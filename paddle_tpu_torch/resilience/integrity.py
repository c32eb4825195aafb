"""Silent-corruption sentinel — self-verifying training state (the port of
``paddle_tpu/resilience/integrity.py``).

Every loud failure mode is already survivable: crashes resume from
atomic checkpoints, hangs are localized by the flight watchdog, dead
serving replicas fail over.  What nothing upstream catches is a rank
that keeps running but computes the *wrong numbers* — a hardware
bitflip, a nondeterministic kernel, a dp replica that desynced after a
missed collective.  There is no NaN, no stall, no dead socket; the only
symptom is a loss curve that quietly goes wrong while every checkpoint
since the corruption gets poisoned.  This module makes live training
state verify itself, three ways:

- **cross-rank fingerprints** — :func:`tree_fingerprint` computes a
  per-leaf CRC32 digest (leaf-name-keyed, over the exact bytes of each
  array; on the card for CUDA tensors).  Every ``fingerprint_every`` steps each dp rank
  publishes its digest over the TCPStore rendezvous plane (per-step
  keys under ``integrity/fp/rank_<r>``) and compares against its
  peers: replicated state must be *bitwise identical*, so any mismatch
  is corruption.  Majority vote names the divergent rank(s) and the
  first divergent leaf; ``integrity_divergence_total{kind="cross_rank"}``
  fires with an ``integrity::divergence`` span, and the divergent rank
  flips ``training_healthy`` + ``integrity_divergence_active``.
- **sampled step replay** — every ``replay_every`` steps the callback
  snapshots pre-step state (params, buffers, optimizer state, RNG
  streams, LR), lets the real step run, then re-executes it via
  ``Model.replay_train_batch`` and compares the two outcomes bitwise.
  Any delta means nondeterminism or silent corruption *within one
  step*, reported with the first differing leaf
  (``integrity_divergence_total{kind="replay"}``).
- **repair** — a confirmed cross-rank divergence is an anomaly kind
  (``param_divergence``) the :class:`~paddle_tpu_torch.observability.health.
  HealthMonitor` routes through the PR-6 rollback machinery: the
  divergent rank restores the newest checkpoint at or before the last
  *verified* step, discards the poisoned newer checkpoints, rewinds the
  fit loop and **replays** the same batches (no data is skipped —
  unlike a poisoned-batch rollback, the data was fine; the state was
  not), reconverging bitwise with the healthy replicas.

Audit-on-save (``CheckpointManager.save(verify=True)``) closes the
fourth hole: a save whose bytes rot between commit and the next
restore.  See :mod:`.checkpoint_manager`.

The ``bitflip`` fault kind (:mod:`.faults`) makes every detection path
reproducible on CPU: flip one seed-chosen bit in a named array at the
``hapi.step_params`` site and watch the sentinel find it, name it, and
repair it.

Overhead: a fingerprint of CUDA tensors is one launch of the device CRC
(``kernels/crc32.py``: zlib's CRC-32 over each leaf's bytes where they
lie, combined across blocks) and one read back of a word a leaf, every N
steps; a replay costs one extra step (a replay of the captured train
step) and multi-tensor copies of the state into buffers reused from
replay to replay, every M steps.  The JAX package documents a bound of
3 % of step time at its bench config (N=25, M=100); ``chip_smoke.py``
phase 19 (f) checks the port's cost on the card against it.

The port's digests equal the JAX package's for equal arrays: a leaf's
CRC covers ``dtype.str:shape`` and then its host bytes, and a bf16 tensor
digests as the ``'<V2'`` array (its uint16 bits) that an
``ml_dtypes.bfloat16`` array is.  :func:`shard_fingerprint` keys a
plain tensor by its whole index range and a ``mesh.Shard`` by its window
of the global array; :func:`cross_rank_windows` compares a world's
windows and :func:`repair_windows` copies a window back only from a
strict majority of its holders.
The port's train step writes in place, so the replay's snapshot is a
deep copy (``Model.replay_train_batch`` restores the live state after
it), and the in-place bitflip of the fault injector corrupts the live
parameter itself.
"""
from __future__ import annotations

import json
import logging
import time
import zlib

import torch

from ..distributed.mesh import Shard
from ..kernels.crc32 import crc32_leaves
# the duck-typed hapi hook surface: resilience sits below hapi in the
# layer stack, so the sentinel callback does not import hapi
from ..observability.goodput import TrainingCallback

__all__ = ["tree_fingerprint", "shard_fingerprint", "compare_windows",
           "cross_rank_windows", "repair_windows",
           "first_divergent_leaf", "majority_partition",
           "compare_digests", "IntegrityCallback"]

logger = logging.getLogger("paddle_tpu_torch.resilience")


# ------------------------------------------------------------ fingerprints


def _leaf_crc(arr):
    import numpy as np

    from ..distributed.checkpoint import host_array

    a, dtype = host_array(arr)              # device→host for tensors
    a = np.require(a, requirements="C")     # 0-d stays 0-d
    # dtype + shape ride in the digest: a reshaped or recast leaf with
    # identical bytes is still a divergence; bf16 digests as the '<V2'
    # array JAX's ml_dtypes.bfloat16 is
    dstr = "<V2" if dtype == "bfloat16" else a.dtype.str
    crc = zlib.crc32(f"{dstr}:{a.shape}".encode())
    return zlib.crc32(memoryview(a).cast("B") if a.size else b"", crc)


# numpy's dtype.str of each torch dtype (bf16: the '<V2' of ml_dtypes)
_DTYPE_STR = {
    torch.float64: "<f8", torch.float32: "<f4", torch.float16: "<f2",
    torch.bfloat16: "<V2", torch.int64: "<i8", torch.int32: "<i4",
    torch.int16: "<i2", torch.int8: "|i1", torch.uint8: "|u1",
    torch.bool: "|b1", torch.complex64: "<c8", torch.complex128: "<c16"}
_headers = {}      # (dtype, shape) -> CRC of the "dtype:shape" header


def _header_crc(t):
    key = (t.dtype, t.shape)
    crc = _headers.get(key)
    if crc is None:
        crc = zlib.crc32(f"{_DTYPE_STR[t.dtype]}:{tuple(t.shape)}"
                         .encode())
        _headers[key] = crc
    return crc


def _digest_leaves(leaves):
    """CRC32 of each array leaf: the CUDA tensors of one device in one
    launch of the device kernel (``kernels/crc32.py``, one sync), every
    other leaf on the host with ``zlib``.  Equal digests either way."""
    out = [None] * len(leaves)
    by_device = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            by_device.setdefault(leaf.device, []).append(i)
        else:
            out[i] = _leaf_crc(leaf)
    for idx in by_device.values():
        tensors = [leaves[i] for i in idx]
        for i, crc in zip(idx, crc32_leaves(
                tensors, [_header_crc(t) for t in tensors])):
            out[i] = crc
    return out


def _visit(tree, prefix, leaf_key):
    """``{path: crc32}`` over a nested dict/list/array tree, paths
    ``/``-joined in sorted order; ``leaf_key(path, node)`` names an array
    leaf (``None`` skips it).  Non-array scalar leaves hash their
    ``repr``; ``None`` leaves are skipped."""
    out, names, leaves = {}, [], []

    def visit(path, node):
        if isinstance(node, dict):
            for k in sorted(node):
                visit(f"{path}/{k}" if path else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(f"{path}/{i}" if path else str(i), v)
        elif node is None:
            return
        elif isinstance(node, Shard):
            key = leaf_key(path, node)
            if key is not None:
                out[key] = None
                names.append(key)
                leaves.append(node.data.contiguous())
        elif hasattr(node, "dtype") or hasattr(node, "__array__"):
            key = leaf_key(path, node)
            if key is not None:
                out[key] = None         # keeps the visiting order
                names.append(key)
                leaves.append(node)
        else:
            out[path] = zlib.crc32(repr(node).encode())

    visit(prefix, tree)
    for name, crc in zip(names, _digest_leaves(leaves)):
        out[name] = crc
    return out


def tree_fingerprint(tree, prefix=""):
    """Per-leaf CRC32 digest of a nested dict/list/array tree.

    Returns ``{leaf_path: crc32}`` with ``/``-joined path keys in
    sorted order — the cheap, leaf-name-keyed state digest the
    cross-rank compare and the step-replay verifier both speak.
    Non-array scalar leaves hash their ``repr``; ``None`` leaves are
    skipped.  CUDA tensors are digested on the card, one launch and one
    sync a device."""
    return _visit(tree, prefix, lambda path, node: path)


def shard_fingerprint(tree, prefix="", devices=None):
    """Per-window CRC32 digest, ``{leaf_path@window: crc32}``, the
    multi-chip view of :func:`tree_fingerprint` (JAX: one entry per
    addressable shard, ``window`` its global index slice, ``0:64,32:64``).
    A ``distributed.mesh.Shard`` leaf (``HybridEngine.shard_views``,
    ``Model.shard_views`` in a world) is keyed by its real window of the
    global array; any other tensor is one window, its whole index range
    (a 0-d leaf is ``0:1``).  ``devices`` keeps only the leaves on those
    devices.  Digests compare within a dp replica group only, or window
    by window across every rank (:func:`compare_windows`)."""
    devset = None if devices is None else {str(d) for d in devices}

    def window(path, node):
        data = node.data if isinstance(node, Shard) else node
        dev = getattr(data, "device", "cpu")
        if devset is not None and str(dev) not in devset:
            return None
        if isinstance(node, Shard):
            return f"{path}@{node.key}"
        shape = tuple(node.shape) or (1,)
        return f"{path}@" + ",".join(f"0:{n}" for n in shape)

    return _visit(tree, prefix, window)


def compare_windows(digests):
    """Windows whose digests disagree across the ranks that hold them:
    ``digests`` ``{rank: {leaf@window: crc32}}`` (each rank's
    :func:`shard_fingerprint`).  Returns ``[{"rank", "leaf", "window",
    "majority_ranks"}]`` (empty: every replica of every window agrees).
    Where one digest is held by strictly more ranks than any other, it
    is the window's majority and each other holder is named beside it.
    Without such a majority (two holders that disagree, or a tie) which
    copy is right is unknown: every holder is named with
    ``majority_ranks`` empty, and :func:`repair_windows` copies nothing
    there (recovery is the rollback's, as in :class:`IntegrityCallback`;
    the JAX ``majority_partition``'s two-rank anchor is a convention for
    naming, not a source to repair from)."""
    holders = {}
    for rank, d in digests.items():
        for key, crc in d.items():
            holders.setdefault(key, {}).setdefault(crc, []).append(rank)
    out = []
    for key in sorted(holders):
        groups = sorted(holders[key].values(), key=len, reverse=True)
        if len(groups) < 2:
            continue
        majority = groups[0] if len(groups[0]) > len(groups[1]) else []
        leaf, _, win = key.partition("@")
        named = sorted(r for g in groups if g is not majority for r in g)
        for r in named:
            out.append({"rank": int(r), "leaf": leaf, "window": win,
                        "majority_ranks": sorted(majority)})
    return out


def cross_rank_windows(views, prefix=""):
    """Every rank's :func:`shard_fingerprint` of ``views`` (a tree of
    ``mesh.Shard``) exchanged over the world (an all-gather of the
    digests) and compared window by window: ``(divergent, digests)``,
    ``divergent`` as :func:`compare_windows` gives it, the same on every
    rank.  A collective: every rank of the world calls it."""
    import torch.distributed as dist

    mine = shard_fingerprint(views, prefix)
    if not dist.is_initialized():
        return compare_windows({0: mine}), {0: mine}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    digests = dict(enumerate(every))
    return compare_windows(digests), digests


def repair_windows(views, divergent, prefix=""):
    """Copy each divergent window of :func:`cross_rank_windows` that has
    a majority from the lowest rank of that majority into the rank that
    holds it wrong, in place (``collective.send`` / ``recv`` over the
    world); a window without a majority is left as it is.  Returns the
    windows this rank repaired.  A collective: every rank calls it with
    the same ``divergent``."""
    from ..distributed import collective
    from ..distributed.env import get_rank
    from ..distributed.mesh import _leaf_paths

    me = get_rank()
    by_key = {f"{prefix}{p}@{v.key}": v for p, v in _leaf_paths(views)}
    done = []
    for d in divergent:
        if not d["majority_ranks"]:
            continue
        key = f"{d['leaf']}@{d['window']}"
        src, dst = d["majority_ranks"][0], d["rank"]
        view = by_key.get(key)
        # rank-ok: a matched point-to-point pair: every rank walks the
        # same divergent list, the source sends and the holder receives,
        # and the other ranks take no part in this window
        if me == src:
            collective.send(view.data, dst)
        elif me == dst:     # rank-ok: the receiving half of the pair above
            buf = torch.empty_like(view.data)
            collective.recv(buf, src)
            with torch.no_grad():
                view.data.copy_(buf)
            done.append(key)
    return done


def _same_bits(a, b):
    """True when two tensors hold the same bytes (bitwise, unlike
    ``torch.equal``: NaN and -0.0 count by their bits)."""
    a, b = a.detach(), b.detach()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def _bytes(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _first_different_leaf(mine, other):
    """First (sorted) name whose tensors differ in their bits between two
    ``{name: tensor}`` dicts of one device: one concatenated comparison
    and one host read; the per-leaf search runs only after a mismatch."""
    names = sorted(mine)
    for name in names:
        a, b = mine[name], other[name]
        if a.dtype != b.dtype or a.shape != b.shape:
            return name
    if not names or bool(torch.equal(
            torch.cat([_bytes(mine[n]) for n in names]),
            torch.cat([_bytes(other[n]) for n in names]))):
        return None
    return next(n for n in names if not _same_bits(mine[n], other[n]))


def first_divergent_leaf(mine, other):
    """First (sorted) leaf name whose digest differs between two
    fingerprints — a leaf missing from either side counts."""
    for name in sorted(set(mine) | set(other)):
        if mine.get(name) != other.get(name):
            return name
    return None


def majority_partition(digests):
    """Partition ``{rank: fingerprint}`` by bitwise-identical digest.

    Returns ``(majority_ranks, minority_ranks, majority_digest)``.
    The majority is the largest identical group; a tie breaks toward
    the group containing the lowest rank (with two ranks, rank 0
    anchors — attribution is a convention there, detection is not)."""
    groups = {}
    for rank, digest in digests.items():
        key = tuple(sorted(digest.items()))
        groups.setdefault(key, []).append(rank)
    ordered = sorted(groups.items(),
                     key=lambda kv: (-len(kv[1]), min(kv[1])))
    maj_key, maj_ranks = ordered[0]
    minority = sorted(r for key, ranks in groups.items()
                      if key != maj_key for r in ranks)
    return sorted(maj_ranks), minority, dict(maj_key)


def compare_digests(digests):
    """Cross-rank compare: ``None`` when every rank agrees, else a
    report naming the divergent rank(s) and, per divergent rank, the
    first divergent leaf vs the majority."""
    if len(digests) < 2:
        return None
    majority, minority, maj_digest = majority_partition(digests)
    if not minority:
        return None
    return {
        "majority_ranks": majority,
        "divergent_ranks": minority,
        "first_divergent_leaf": {
            r: first_divergent_leaf(digests[r], maj_digest)
            for r in minority},
    }


# ----------------------------------------------------------- the sentinel


def _rank_step_key(prefix, rank, step):
    return f"{prefix}/fp/rank_{int(rank)}/step_{int(step)}"


class IntegrityCallback(TrainingCallback):
    """The silent-corruption sentinel as a ``Model.fit`` callback.

    ``store``/``rank``/``world_size`` wire the cross-rank fingerprint
    compare over the TCPStore rendezvous plane (omit ``store`` for
    single-process use — replay verification still runs).  ``monitor``
    (a :class:`~paddle_tpu_torch.observability.health.HealthMonitor`, ideally
    ``action="rollback"``) receives a confirmed *own-rank* divergence
    as a ``param_divergence`` anomaly, which triggers the
    restore-and-replay repair (requires a ``CheckpointCallback`` in the
    same fit); without a monitor the sentinel detects and reports but
    does not repair.

    ``fingerprint_every=0`` / ``replay_every=0`` disable that
    mechanism.  ``include_opt_state`` folds optimizer slots into the
    fingerprint (params-only by default: corrupt optimizer state
    surfaces in the params within a step anyway).

    Events land in ``self.events`` (newest last), metrics in
    ``integrity_checks_total{kind}`` / ``integrity_divergence_total
    {kind}`` / ``integrity_fingerprint_seconds`` /
    ``integrity_replay_seconds`` / ``integrity_last_verified_step`` /
    ``integrity_divergence_active``, spans as ``integrity::divergence``
    and ``integrity::replay``.  The telemetry server's ``/integrity``
    endpoint serves :meth:`report`, and ``/healthz`` goes 503 while
    ``divergence_active`` is set (cleared when a later compare
    matches again — i.e. once the repair actually reconverged)."""

    def __init__(self, store=None, rank=0, world_size=1,
                 fingerprint_every=25, replay_every=0, monitor=None,
                 include_opt_state=False, key_prefix="integrity",
                 history=4, registry=None, tracer=None, clock=None,
                 peers=None, fingerprint_shards=False,
                 local_devices=None):
        """``peers``/``fingerprint_shards``/``local_devices`` are the
        GSPMD wiring: under a multi-chip mesh the fingerprint must
        cover each rank's *addressable shard view*
        (:func:`shard_fingerprint`, enabled by ``fingerprint_shards``;
        ``local_devices`` restricts to this rank's devices) and the
        cross-rank compare must be restricted to this rank's dp
        replica group (``peers``, from
        the JAX package's ``distributed.mesh.replica_peers``) — mp/pp/
        sharding neighbours hold different shards and legitimately
        differ."""
        super().__init__()
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.peers = None if peers is None else sorted(
            int(p) for p in peers)
        self.fingerprint_shards = bool(fingerprint_shards)
        self.local_devices = local_devices
        self.fingerprint_every = int(fingerprint_every)
        self.replay_every = int(replay_every)
        self.monitor = monitor
        self.include_opt_state = bool(include_opt_state)
        self.key_prefix = key_prefix
        self.history = int(history)
        self._registry = registry
        self._tracer = tracer
        self._clock = clock or time.time
        self._global_step = 0
        self._snapshot = self._snap_buf = None
        self.events = []
        self.divergence_active = False
        self.last_verified_global_step = None
        self.checks = {"fingerprint": 0, "replay": 0}

    # ---- wiring ---------------------------------------------------------
    def registry(self):
        if self._registry is None:
            from ..observability.metrics import default_registry

            self._registry = default_registry()
        return self._registry

    def tracer(self):
        if self._tracer is None:
            from ..observability.tracing import default_tracer

            self._tracer = default_tracer()
        return self._tracer

    def _active_gauge(self):
        return self.registry().gauge(
            "integrity_divergence_active",
            "1 while a confirmed state divergence on this rank is "
            "unrepaired")

    def _divergence_counter(self, kind):
        return self.registry().counter(
            "integrity_divergence_total",
            "state divergences detected by the integrity sentinel",
            labelnames=("kind",)).labels(kind=kind)

    def _check_counter(self, kind):
        return self.registry().counter(
            "integrity_checks_total",
            "integrity verifications run (fingerprint compares, step "
            "replays)", labelnames=("kind",)).labels(kind=kind)

    def report(self):
        """The ``/integrity`` payload."""
        return {
            "rank": self.rank,
            "world_size": self.world_size,
            "fingerprint_every": self.fingerprint_every,
            "replay_every": self.replay_every,
            "global_step": self._global_step,
            "last_verified_global_step": self.last_verified_global_step,
            "divergence_active": bool(self.divergence_active),
            "checks": dict(self.checks),
            "events": list(self.events[-32:]),
        }

    # ---- hapi hooks -----------------------------------------------------
    def on_train_begin(self, logs=None):
        info = getattr(self.model, "_resume_info", None) or {}
        self._global_step = int(info.get("global_step", 0))
        self._snapshot = self._snap_buf = None
        self.events = []
        self.checks = {"fingerprint": 0, "replay": 0}
        self.divergence_active = False
        self.last_verified_global_step = None
        self._active_gauge().set(0)
        if self.replay_every:
            # fit stashes each raw batch so the replay can re-feed it
            self.model._stash_batch = True

    def on_train_end(self, logs=None):
        if self.model is not None:
            self.model._stash_batch = False

    def rewind_to(self, global_step):
        """Rollback support: a rewind-and-replay repair moved training
        back to ``global_step`` — step counting must follow, and a
        snapshot taken for the aborted step is meaningless now."""
        self._global_step = int(global_step)
        self._snapshot = None

    def on_train_batch_begin(self, step, logs=None):
        if not self.replay_every:
            return
        upcoming = self._global_step + 1
        if upcoming % self.replay_every:
            return
        # the step updates in place: the snapshot is a deep copy, into
        # the buffers of this fit's previous one
        self._snapshot = self._snap_buf = self.model.train_state_snapshot(
            into=self._snap_buf)

    def on_train_batch_end(self, step, logs=None):
        self._global_step += 1
        if self._snapshot is not None:
            self._run_replay(step)
        if self.fingerprint_every and \
                self._global_step % self.fingerprint_every == 0:
            self._run_fingerprint(step)

    # ---- step replay ----------------------------------------------------
    def _run_replay(self, step):
        snap, self._snapshot = self._snapshot, None
        batch = getattr(self.model, "_last_batch", None)
        if batch is None:
            return
        t0 = time.perf_counter()
        loss2, params2 = self.model.replay_train_batch(snap, batch)
        current = dict(self.model.network.named_parameters())
        leaf = _first_different_leaf(current, params2)
        self.registry().histogram(
            "integrity_replay_seconds",
            "wall time of one sampled step replay").observe(
                time.perf_counter() - t0)
        self._check_counter("replay").inc()
        self.checks["replay"] += 1
        if leaf is None:
            return
        detail = {"kind": "replay", "global_step": self._global_step,
                  "step": int(step), "first_divergent_leaf": leaf,
                  "replayed_loss": float(loss2)}
        self.events.append(detail)
        self._divergence_counter("replay").inc()
        span = self.tracer().start_trace("integrity::replay",
                                         attributes=dict(detail))
        span.end()
        logger.error(
            "integrity: step replay mismatch at global step %d — first "
            "divergent leaf %r (the step is nondeterministic or "
            "silently corrupting)", self._global_step, leaf)
        if self.monitor is not None:
            # step_replay_mismatch is deliberately NOT a rollback kind:
            # replay can't say which of the two executions was right
            self.monitor.external_anomaly("step_replay_mismatch",
                                          detail, step)

    # ---- cross-rank fingerprints ---------------------------------------
    def _fingerprint_tree(self):
        if self.fingerprint_shards and \
                getattr(self.model, "_mesh", None) is not None:
            # a world: each parameter's window this rank owns
            return self.model.shard_views()
        # whole (gathered in a world whose steps hold windows), so the
        # ranks of a healthy world digest the same bytes
        params, st = self.model._whole_state()
        tree = {"params": params}
        if self.include_opt_state and st is not None:
            tree["opt"] = st
        return tree

    def _run_fingerprint(self, step):
        t0 = time.perf_counter()
        if self.fingerprint_shards:
            digest = shard_fingerprint(self._fingerprint_tree(),
                                       devices=self.local_devices)
        else:
            digest = tree_fingerprint(self._fingerprint_tree())
        self.registry().histogram(
            "integrity_fingerprint_seconds",
            "wall time of one parameter-tree fingerprint").observe(
                time.perf_counter() - t0)
        digests = {self.rank: digest}
        if self.store is not None:
            try:
                self._publish(digest)
                digests.update(self._peer_digests())
            except (OSError, RuntimeError) as e:
                logger.warning("integrity: store unavailable for "
                               "fingerprint exchange: %s", e)
        self._check_counter("fingerprint").inc()
        self.checks["fingerprint"] += 1
        report = compare_digests(digests)
        if report is None:
            self.last_verified_global_step = self._global_step
            self.registry().gauge(
                "integrity_last_verified_step",
                "newest global step whose cross-rank fingerprint "
                "compare matched").set(self._global_step)
            if self.divergence_active:
                self.divergence_active = False
                self._active_gauge().set(0)
                logger.warning(
                    "integrity: rank %d reconverged with the fleet at "
                    "global step %d — divergence repaired",
                    self.rank, self._global_step)
            return
        self._handle_divergence(report, step)

    def _publish(self, digest):
        key = _rank_step_key(self.key_prefix, self.rank,
                             self._global_step)
        self.store.set(key, json.dumps(
            {"rank": self.rank, "global_step": self._global_step,
             "time": self._clock(), "digest": digest}))
        stale = self._global_step - self.history * self.fingerprint_every
        if stale > 0 and hasattr(self.store, "delete_key"):
            try:
                self.store.delete_key(_rank_step_key(
                    self.key_prefix, self.rank, stale))
            except (OSError, RuntimeError):
                pass

    def _peer_digests(self):
        """Peer fingerprints for THIS global step — only ranks that
        have already published (non-blocking: a slow peer is compared
        on a later step, not waited on).  With ``peers`` set, only the
        dp replica group is consulted — everyone else's shard view
        differs by construction.

        The ``blocking=False`` below is load-bearing, not an
        optimization: a blocking get here would make every fingerprint
        interval a de-facto barrier — one dead rank stalls the whole
        fleet's training loop.  The ``collective-discipline`` static
        pass treats a blocking one-sided store wait as exactly that
        hazard; this publish/compare exchange stays in its handshake
        class only because nobody ever waits."""
        out = {}
        ranks = (self.peers if self.peers is not None
                 else range(self.world_size))
        for r in ranks:
            if r == self.rank:
                continue
            key = _rank_step_key(self.key_prefix, r, self._global_step)
            try:
                blob = self.store.get(key, blocking=False)
            except KeyError:
                continue
            try:
                payload = json.loads(blob)
            except ValueError:
                continue
            out[r] = {k: int(v)
                      for k, v in payload.get("digest", {}).items()}
        return out

    def _handle_divergence(self, report, step):
        self_divergent = self.rank in report["divergent_ranks"]
        detail = {
            "kind": "cross_rank",
            "global_step": self._global_step,
            "step": int(step),
            "divergent_ranks": report["divergent_ranks"],
            "majority_ranks": report["majority_ranks"],
            "first_divergent_leaf": report["first_divergent_leaf"],
            "self_divergent": self_divergent,
            "last_verified_global_step": self.last_verified_global_step,
        }
        self.events.append(detail)
        self._divergence_counter("cross_rank").inc()
        span = self.tracer().start_trace("integrity::divergence",
                                         attributes={
                                             k: repr(v) if
                                             isinstance(v, (list, dict))
                                             else v
                                             for k, v in detail.items()})
        span.end()
        leaves = report["first_divergent_leaf"]
        logger.error(
            "integrity: cross-rank state divergence at global step %d "
            "— divergent rank(s) %s, first divergent leaf %s",
            self._global_step, report["divergent_ranks"], leaves)
        if not self_divergent:
            return                  # the divergent rank repairs itself
        self.divergence_active = True
        self._active_gauge().set(1)
        self.registry().gauge(
            "training_healthy",
            "1 = no active training anomaly, 0 = unhealthy").set(0)
        if self.monitor is not None:
            rollback_detail = dict(detail)
            rollback_detail["rewind"] = True
            if self.last_verified_global_step is not None:
                # restore a checkpoint at or before the last step the
                # fleet agreed on — anything newer may be poisoned
                rollback_detail["restore_before"] = \
                    self.last_verified_global_step + 1
            self.monitor.external_anomaly("param_divergence",
                                          rollback_detail, step)
