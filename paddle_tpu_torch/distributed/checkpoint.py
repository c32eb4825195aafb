"""Sharded checkpoints (the port of ``paddle_tpu/distributed/checkpoint.py``).

The on-disk format is the JAX package's, byte for byte, so a checkpoint
written by either package loads in the other:

  <path>/manifest.<rank>.json      leaves (path, id, shape, dtype, and
                                   per shard its file, CRC32 and index
                                   window), step, extra; format
                                   ``paddle_tpu.sharded_checkpoint.v2``
  <path>/<leaf-id>/shard<k>.npy    one ``.npy`` per saved window

On one GPU a tensor is one window (``shardr<rank>_0.npy`` over the whole
array).  In a world each rank writes only its own index windows: a leaf
given as a ``mesh.Shard`` (``HybridEngine.state_windows``: pp layer
ranges, mp splits, ZeRO-3 slices and the ZeRO chunks of the canonical
optimizer state) is written under its window of the global array, and
only by the one rank whose ``owner`` flag is set, so a window several
ranks hold is written once.  :func:`load_sharded` unions the windows of
every rank's manifest, so a checkpoint that a multi-device JAX engine
wrote loads here and the JAX package reads a world's; a restore reads
only the windows it needs (memory-mapped).  Leaves follow JAX's flattening: dict keys
sorted, ``/``-joined paths, ``None`` skipped; a Python int is saved as
int32 and a float as float32, as ``jnp.asarray`` makes them.

bf16: numpy has no bfloat16, and the JAX package saves an
``ml_dtypes.bfloat16`` array, whose ``.npy`` header reads ``'<V2'``.  The
port writes the tensor's uint16 bits under that same header, so the two
packages' files (and CRCs) are equal for an equal tree, and it reads a
``V2`` file back as bf16 by the manifest's ``"dtype": "bfloat16"``.  In
the host form of :func:`load_sharded` a bf16 leaf is a CPU
``torch.bfloat16`` tensor; every other leaf is a numpy array.

Crash safety: each shard is written through ``resilience.atomic``'s tmp
+ rename with a running CRC32 recorded in the manifest, and the
manifest is written last (atomically too), so its presence implies every
shard it names was on disk first.  ``CommitBarrier`` makes that commit
point multi-host over the ``TCPStore``.  Fault sites:
``checkpoint.before_shard``, ``checkpoint.shard_write``,
``checkpoint.before_manifest``, ``checkpoint.manifest_write``,
``checkpoint.shard_ack``, ``checkpoint.before_barrier_commit``.

``save_engine_state`` / ``load_engine_state`` keep ``HybridEngine``'s
params and its optimizer state in the JAX engine's canonical form
(``opt_canonical``: param-shaped ``m``, ``v`` and ``master``), so a state
crosses between the engines whatever their topology: a world saves its
windows (through a ``CommitBarrier`` when one is given), and a world of
another layout, one process or the JAX engine loads them.
``load_engine_state(..., into=(params, opt_state))`` restores in place:
it copies into the live tensors, so an engine that captured its step as
a CUDA graph replays it with the restored state, without a new capture.
"""
from __future__ import annotations

import glob
import json
import os
import threading

import numpy as np
import torch

from ..resilience.atomic import atomic_write
from ..resilience.faults import fault_point
from ..resilience.retry import Deadline

__all__ = ["save_sharded", "load_sharded", "save_engine_state",
           "load_engine_state", "CommitBarrier", "CommitBarrierError"]

FORMAT = "paddle_tpu.sharded_checkpoint.v2"


# ------------------------------------------------------ commit barrier


class CommitBarrierError(RuntimeError):
    """The multi-host commit barrier did not complete: a rank failed to
    ack its shards (or the committer died) within the timeout.  The
    checkpoint was NOT committed."""


class CommitBarrier:
    """Multi-host checkpoint commit over ``TCPStore`` (the JAX class):
    every rank writes its shards and :meth:`ack`\\ s their CRCs; rank 0's
    :meth:`commit` waits for every ack, fires
    ``checkpoint.before_barrier_commit``, runs the commit function and
    publishes the committed marker, on which the other ranks block.
    Tokens are generation-qualified (:meth:`begin`), so a retried save
    is never satisfied by a dead attempt's acks."""

    def __init__(self, store, rank, world_size, timeout=30.0,
                 key_prefix="ckpt_commit"):
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.timeout = float(timeout)
        self.key_prefix = key_prefix
        self._lock = threading.Lock()
        self._gen = {}       # guarded-by: self._lock  token -> generation
        self._acks = {}      # guarded-by: self._lock  token -> {rank: crcs}
        self._state = {}     # guarded-by: self._lock  token -> phase str

    def _key(self, token, gen, leaf):
        return f"{self.key_prefix}/{token}/g{int(gen)}/{leaf}"

    def begin(self, token, prepare=None):
        """Open a commit attempt for ``token``; returns its generation.
        Rank 0 bumps the generation, runs ``prepare`` and publishes it;
        the other ranks block on it (one Deadline for the whole join)."""
        if self.rank == 0:
            gen = self.store.add(f"{self.key_prefix}/{token}/gen", 1)
            if prepare is not None:
                prepare()
            self.store.set(f"{self.key_prefix}/{token}/open", str(gen))
        else:
            dl = Deadline(self.timeout)
            while True:   # lint-ok: bounded-retries Deadline-bounded poll
                try:
                    raw = self.store.get(f"{self.key_prefix}/{token}/open",
                                         blocking=True,
                                         timeout=dl.remaining())
                except TimeoutError:
                    raise CommitBarrierError(
                        f"commit barrier {token!r}: rank 0 never opened a "
                        f"generation within {self.timeout}s") from None
                gen = int(raw)
                with self._lock:
                    stale = self._gen.get(token)
                if (stale is None or gen > stale) \
                        and not self._finished(token, gen):
                    break
                if dl.expired():
                    raise CommitBarrierError(
                        f"commit barrier {token!r}: no new generation "
                        f"within {self.timeout}s (stuck at g{gen})")
                dl.sleep(0.005)
        with self._lock:
            self._gen[token] = gen
            self._state[token] = "open"
        return gen

    def _finished(self, token, gen):
        for leaf in ("committed", "aborted"):
            try:
                self.store.get(self._key(token, gen, leaf), blocking=False)
                return True
            except KeyError:
                pass
        return False

    def _abort(self, token, gen, why):
        try:
            self.store.set(self._key(token, gen, "aborted"), why)
        except (OSError, RuntimeError):
            pass    # silent-ok: best-effort tombstone while failing anyway
        with self._lock:
            self._state[token] = "failed"

    def _generation(self, token):
        with self._lock:
            gen = self._gen.get(token)
        return self.begin(token) if gen is None else gen

    def ack(self, token, crcs):
        """Publish this rank's shard-CRC digest; the fault site fires
        before the store write."""
        gen = self._generation(token)
        fault_point("checkpoint.shard_ack")
        self.store.set(self._key(token, gen, f"ack/rank_{self.rank}"),
                       json.dumps({"rank": self.rank,
                                   "crcs": dict(crcs or {})}))
        with self._lock:
            self._state[token] = "acked"

    def _collect_acks(self, token, gen):
        acks = {}
        dl = Deadline(self.timeout)
        for r in range(self.world_size):
            try:
                raw = self.store.get(self._key(token, gen, f"ack/rank_{r}"),
                                     blocking=True, timeout=dl.remaining())
            except (KeyError, TimeoutError):
                self._abort(token, gen, f"rank {r} never acked")
                raise CommitBarrierError(
                    f"commit barrier {token!r} (g{gen}): rank {r} never "
                    f"acked its shards within {self.timeout}s — checkpoint "
                    f"NOT committed") from None
            acks[r] = json.loads(raw)
        return acks

    def commit(self, token, fn=None):
        """Rank 0: collect every ack, fire the fault site, run ``fn`` (THE
        commit), publish the marker, return the acks.  Other ranks: block
        on the marker."""
        gen = self._generation(token)
        if self.rank == 0:
            acks = self._collect_acks(token, gen)
            with self._lock:
                self._acks[token] = {r: a.get("crcs", {})
                                     for r, a in acks.items()}
            fault_point("checkpoint.before_barrier_commit")
            if fn is not None:
                fn()
            self.store.set(self._key(token, gen, "committed"),
                           json.dumps(sorted(acks)))
            with self._lock:
                self._state[token] = "committed"
            return acks
        try:
            self.store.get(self._key(token, gen, "committed"),
                           blocking=True, timeout=self.timeout)
        except (KeyError, TimeoutError):
            self._abort(token, gen, "commit marker never appeared")
            raise CommitBarrierError(
                f"commit barrier {token!r} (g{gen}): commit marker never "
                f"appeared within {self.timeout}s — rank 0 died or a peer "
                f"never acked; previous checkpoint remains current") \
                from None
        with self._lock:
            self._state[token] = "committed"
        return None

    def status(self):
        with self._lock:
            return {"rank": self.rank, "world_size": self.world_size,
                    "tokens": dict(self._state),
                    "acked_ranks": {t: sorted(a)
                                    for t, a in self._acks.items()}}


# ------------------------------------------------------------ the tree


def _leaf_id(path_str):
    return path_str.replace("/", ".")


def tree_items(tree, prefix=""):
    """``(path, leaf)`` of a nested dict / list / tuple tree in JAX's
    flattening order: dict keys sorted, ``/``-joined paths, ``None``
    skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def host_array(leaf):
    """``(numpy array, dtype name)`` of a leaf on the host: a tensor's
    values (bf16 as its uint16 bits, named ``bfloat16``), a numpy array,
    or a Python scalar at JAX's default width."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.cpu().contiguous().view(torch.uint16).numpy(), \
                "bfloat16"
        a = t.cpu().contiguous().numpy()
        return a, str(a.dtype)
    if isinstance(leaf, bool):
        a = np.asarray(leaf)
    elif isinstance(leaf, int):
        a = np.asarray(leaf, np.int32)
    elif isinstance(leaf, float):
        a = np.asarray(leaf, np.float32)
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _write_npy(f, arr, dtype):
    """``np.save``'s bytes; a bf16 leaf (uint16 bits) under the header
    ``np.save`` writes for an ``ml_dtypes.bfloat16`` array (``'<V2'``)."""
    arr = np.require(arr, requirements="C")     # 0-d stays 0-d
    if dtype != "bfloat16":
        np.save(f, arr)
        return
    d = np.lib.format.header_data_from_array_1_0(arr)
    d["descr"] = "<V2"
    try:
        np.lib.format.write_array_header_1_0(f, d)
    except ValueError:
        np.lib.format.write_array_header_2_0(f, d)
    f.write(arr.tobytes())


def _full_window(shape):
    return [[0, int(n)] for n in shape]


def _dtype_name(t):
    """The manifest's dtype name of a tensor (without reading it)."""
    return "bfloat16" if t.dtype == torch.bfloat16 else \
        str(torch.empty((), dtype=t.dtype).numpy().dtype)


def save_sharded(path, tree, step=None, extra=None, rank=None,
                 barrier=None):
    """Save a tree of tensors / arrays: one ``.npy`` a leaf (its one
    window) and ``manifest.<rank>.json``; returns the manifest.

    ``barrier`` (a :class:`CommitBarrier`): the manifest lands as a
    ``.pending`` file, this rank acks its CRCs, and rank 0 renames every
    rank's pending manifest only once every ack arrived.  ``rank``
    defaults to the barrier's, else 0."""
    if rank is None:
        rank = barrier.rank if barrier is not None else 0
    rank = int(rank)
    os.makedirs(path, exist_ok=True)
    from .mesh import Shard

    leaves = []
    for pstr, leaf in tree_items(tree):
        lid = _leaf_id(pstr)
        if isinstance(leaf, Shard):
            shape, index = list(leaf.shape), [list(w) for w in leaf.index]
            arr, dtype = host_array(leaf.data) if leaf.owner else \
                (None, _dtype_name(leaf.data))
        else:
            arr, dtype = host_array(leaf)
            shape, index = list(arr.shape), _full_window(arr.shape)
        shards = []
        if arr is not None:
            ldir = os.path.join(path, lid)
            os.makedirs(ldir, exist_ok=True)
            fname = f"shardr{rank}_0.npy"
            fpath = os.path.join(ldir, fname)
            fault_point("checkpoint.before_shard", path=fpath)
            with atomic_write(fpath, "wb",
                              site="checkpoint.shard_write") as f:
                _write_npy(f, arr, dtype)
                crc = f.crc32
            shards.append({"file": fname, "crc32": crc, "index": index})
        leaves.append({"path": pstr, "id": lid, "shape": shape,
                       "dtype": dtype, "shards": shards})
    manifest = {"format": FORMAT, "leaves": leaves,
                "step": None if step is None else int(step),
                "extra": extra or {}}
    fault_point("checkpoint.before_manifest", path=path)
    final_name = os.path.join(path, f"manifest.{rank}.json")
    if barrier is None:
        with atomic_write(final_name, "w",
                          site="checkpoint.manifest_write") as f:
            json.dump(manifest, f, indent=1)
        return manifest
    with atomic_write(final_name + ".pending", "w",
                      site="checkpoint.manifest_write") as f:
        json.dump(manifest, f, indent=1)
    crcs = {f"{l['id']}/{s['file']}": s["crc32"]
            for l in leaves for s in l["shards"]}
    token = os.path.basename(os.path.normpath(path))
    barrier.ack(token, crcs)
    barrier.commit(token, fn=lambda: _commit_pending_manifests(path))
    return manifest


def _commit_pending_manifests(path):
    for pend in sorted(glob.glob(os.path.join(path,
                                              "manifest.*.json.pending"))):
        os.replace(pend, pend[:-len(".pending")])


def _load_manifest(path):
    """Union every rank's manifest (the first provides the metadata)."""
    files = sorted(glob.glob(os.path.join(path, "manifest.*.json")))
    if not files:
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f)
    with open(files[0]) as f:
        manifest = json.load(f)
    by_path = {l["path"]: l for l in manifest["leaves"]}
    for fn in files[1:]:
        with open(fn) as f:
            other = json.load(f)
        for leaf in other["leaves"]:
            mine = by_path.get(leaf["path"])
            if mine is None:
                manifest["leaves"].append(leaf)
                by_path[leaf["path"]] = leaf
                continue
            seen = {tuple(map(tuple, s["index"])) for s in mine["shards"]}
            for s in leaf["shards"]:
                if tuple(map(tuple, s["index"])) not in seen:
                    mine["shards"].append(s)
    return manifest


def _np_dtype(name):
    """The numpy dtype a leaf is read into (bf16: its uint16 bits)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _read_leaf(path, leaf, window=None):
    """The leaf on the host, assembled from the saved windows: the whole
    of it, or only ``window`` (``[(start, stop)]`` per dim; each file is
    memory-mapped and only its overlap with the window read)."""
    shape = leaf["shape"]
    want = [(0, int(n)) for n in shape] if window is None else \
        [(int(a), int(b)) for a, b in window]
    want_dt = _np_dtype(leaf["dtype"])
    out = np.empty([b - a for a, b in want], dtype=want_dt)
    filled = 0
    for sh in leaf["shards"]:
        win = sh["index"]
        lo = [max(a, c) for (a, _), (c, _) in zip(want, win)]
        hi = [min(b, d) for (_, b), (_, d) in zip(want, win)]
        if any(l >= h for l, h in zip(lo, hi)):
            continue
        data = np.load(os.path.join(path, leaf["id"], sh["file"]),
                       mmap_mode="r")
        if data.dtype != want_dt:
            # a V2 file (bf16) reads as raw void: its bits, by the
            # manifest's dtype
            data = data.view(want_dt)
        src = tuple(slice(l - c, h - c) for l, h, (c, _) in
                    zip(lo, hi, win))
        dst = tuple(slice(l - a, h - a) for l, h, (a, _) in
                    zip(lo, hi, want))
        out[dst] = data[src]
        filled += int(np.prod([h - l for l, h in zip(lo, hi)]))
    if filled < out.size:
        raise ValueError(f"checkpoint leaf {leaf['path']}: saved shards "
                         f"cover only {filled}/{out.size} of the window "
                         f"{want}")
    return out


def leaf_tensor(arr, dtype_name):
    """A host array read by :func:`load_sharded` as a CPU tensor (bf16
    from its uint16 bits)."""
    t = torch.from_numpy(np.require(arr, requirements="C"))
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


def _host_leaf(arr, dtype_name):
    return leaf_tensor(arr, dtype_name) if dtype_name == "bfloat16" else arr


def load_sharded(path, like_tree=None):
    """Load a sharded checkpoint; returns ``(tree, manifest)``.

    Without ``like_tree``: ``{path: array}`` on the host (numpy; bf16 as a
    CPU ``torch.bfloat16`` tensor).  With it, a tree of the same structure
    whose leaves carry ``shape``, ``dtype`` and ``device`` (tensors, or
    the templates of ``HybridEngine.state_template``): each leaf becomes a
    tensor of that dtype on that device."""
    manifest = _load_manifest(path)
    by_path = {l["path"]: l for l in manifest["leaves"]}
    if like_tree is None:
        return {p: _host_leaf(_read_leaf(path, l), l["dtype"])
                for p, l in by_path.items()}, manifest

    def build(ref, pstr):
        leaf = by_path.get(pstr)
        if leaf is None:
            raise KeyError(f"checkpoint has no leaf {pstr!r}")
        if tuple(leaf["shape"]) != tuple(ref.shape):
            raise ValueError(
                f"leaf {pstr}: checkpoint shape {leaf['shape']} != target "
                f"{tuple(ref.shape)} — a restore re-windows, it does not "
                f"reshape")
        t = leaf_tensor(_read_leaf(path, leaf), leaf["dtype"])
        return t.to(ref.device, ref.dtype)

    return _map_tree(like_tree, build), manifest


def _map_tree(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, prefix[:-1])


# ---------------------------------------------------- engine state facade


def engine_tree(engine, params, opt_state):
    """The tree :func:`save_engine_state` writes: ``params`` and the
    optimizer state in its canonical form."""
    return {"params": params,
            "opt": engine.opt_canonical(opt_state, params)}


def save_engine_state(path, engine, params, opt_state, barrier=None):
    """Save a ``HybridEngine``'s training state topology-neutrally: params
    as they are, the optimizer in the canonical form.  In a world each
    rank writes its own windows (``engine.state_windows``) and its own
    manifest; ``barrier`` (a :class:`CommitBarrier` over the world's
    ranks) makes the commit one for all of them."""
    if engine.distributed:
        from .env import get_rank

        tree = engine.state_windows(params, opt_state)
        rank = barrier.rank if barrier is not None else get_rank()
    else:
        tree, rank = engine_tree(engine, params, opt_state), None
    return save_sharded(path, tree, step=int(opt_state["step"]),
                        extra={"kind": "hybrid_engine"}, rank=rank,
                        barrier=barrier)


def load_engine_state(path, engine, into=None):
    """Restore onto ``engine``; returns ``(params, opt_state)`` ready for
    ``engine.step``.  Without ``into`` the state is new tensors on the
    engine's device, built from ``engine.state_template()``.  With
    ``into=(params, opt_state)`` (the engine's live state) every value is
    copied into the live tensors in place and ``opt_state["step"]`` set,
    so the tensors a captured step reads keep their storage and the graph
    replays without a new capture."""
    if engine.distributed:
        return _load_windows(path, engine, into)
    if into is None:
        params_t, canon_t = engine.state_template()
        tree, manifest = load_sharded(
            path, like_tree={"params": params_t, "opt": canon_t})
        step = int(manifest["step"] or 0)
        return tree["params"], engine.opt_from_canonical(tree["opt"], step)
    params, opt_state = into
    manifest = _load_manifest(path)
    by_path = {l["path"]: l for l in manifest["leaves"]}
    live = engine_tree(engine, params, opt_state)
    with torch.no_grad():
        for pstr, dst in tree_items(live):
            leaf = by_path.get(pstr)
            if leaf is None:
                raise KeyError(f"checkpoint has no leaf {pstr!r}")
            if tuple(leaf["shape"]) != tuple(dst.shape):
                raise ValueError(f"leaf {pstr}: checkpoint shape "
                                 f"{leaf['shape']} != {tuple(dst.shape)}")
            dst.copy_(leaf_tensor(_read_leaf(path, leaf), leaf["dtype"]))
    step = int(manifest["step"] or 0)
    opt_state["step"] = step
    engine._step.fill_(step)
    return params, opt_state


def _load_windows(path, engine, into=None):
    """``load_engine_state`` on a rank of a world: each leaf's window of
    this rank (its param shard under ``param_specs``; the canonical
    optimizer state takes the same window) read from whatever windows the
    checkpoint holds, then the optimizer cut to this engine's layout."""
    manifest = _load_manifest(path)
    by_path = {l["path"]: l for l in manifest["leaves"]}
    params_t, _ = engine.state_template()
    odt = engine._opt_dtype()

    def read(pstr, tmpl, key, dtype):
        leaf = by_path.get(pstr)
        if leaf is None:
            raise KeyError(f"checkpoint has no leaf {pstr!r}")
        if tuple(leaf["shape"]) != tuple(tmpl.shape):
            raise ValueError(f"leaf {pstr}: checkpoint shape "
                             f"{leaf['shape']} != {tuple(tmpl.shape)}")
        win = engine._window(key, tuple(tmpl.shape))
        t = leaf_tensor(_read_leaf(path, leaf, win), leaf["dtype"])
        return t.to(engine.device, dtype)

    params = _map_tree(params_t, lambda t, p: read(
        f"params/{p}", t, p, t.dtype))
    canon = {name: _map_tree(params_t, lambda t, p, name=name: read(
        f"opt/{name}/{p}", t, p, odt)) for name in ("m", "v", "master")}
    step = int(manifest["step"] or 0)
    opt_state = engine.opt_from_canonical(canon, step)
    if into is None:
        return params, opt_state
    live_p, live_o = into
    with torch.no_grad():
        for (_, dst), (_, src) in zip(tree_items(live_p),
                                      tree_items(params)):
            dst.copy_(src)
        for (_, dst), (_, src) in zip(tree_items(live_o["slots"]),
                                      tree_items(opt_state["slots"])):
            dst.copy_(src)
    live_o["step"] = step
    return live_p, live_o
