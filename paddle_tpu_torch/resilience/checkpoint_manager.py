"""Crash-safe checkpoint lifecycle over ``distributed.checkpoint`` (the port
of ``paddle_tpu/resilience/checkpoint_manager.py``).

- **atomic commit** — each save lands in ``<dir>/step_<n>.tmp`` (shards
  checksummed, manifest last), then ONE ``os.replace`` publishes it as
  ``<dir>/step_<n>``;
- **checksums** — :func:`verify_checkpoint` recomputes every shard's
  CRC32 against its manifest;
- **discovery** — :meth:`CheckpointManager.latest` skips ``.tmp``
  leftovers and (``verify=True``) corrupt directories;
- **fallback restore** — :meth:`CheckpointManager.restore` walks newest
  → oldest to the first intact checkpoint (``before_step`` bounds it);
- **retention** — ``keep_last_n`` removes old steps after each commit;
- **audit-on-save** — ``save(verify=True)`` re-reads the committed
  shards before retention runs (:class:`CheckpointAuditError`);
- **discard** — :meth:`CheckpointManager.discard_after` drops steps
  newer than one (the integrity repair's poisoned saves);
- **async save** — ``async_save=True`` snapshots the tree to host memory
  on the training thread and writes and commits it on a background
  thread; :meth:`wait` joins it and re-raises its failure.

The async snapshot is a deep copy.  A tensor on the card goes by one
device→host copy into a pinned host buffer, which the manager keeps and
reuses from save to save (one per leaf, by path, shape and dtype); the
training thread waits for the copies to complete before the handoff,
then its next step (a captured graph writes the same tensors in place)
can never race the write.  So the training thread pays the copy, as in
JAX, and not the disk.  Because the buffers are reused, a save first
joins the previous save's write (the JAX manager snapshots first and
joins after).  Host tensors and numpy arrays are copied too.

Fault sites: ``checkpoint.before_shard``, ``checkpoint.shard_write``,
``checkpoint.before_manifest``, ``checkpoint.manifest_write``,
``checkpoint.before_commit``, ``checkpoint.after_commit``.  Metrics:
``checkpoint_save_seconds{mode="background"}`` (the overlapped write;
``CheckpointCallback`` records ``sync`` and ``async``),
``checkpoint_commits_total``, ``checkpoint_corrupt_skipped_total``,
``checkpoint_audit_failures_total``, ``checkpoint_discarded_total``,
``checkpoint_tmp_swept_total``, ``checkpoint_gc_removed_total``.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from ..observability.profiling import phase as profiling_phase
from .faults import fault_point

__all__ = ["CheckpointManager", "CheckpointAuditError",
           "verify_checkpoint"]

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointAuditError(RuntimeError):
    """A just-committed checkpoint failed its post-commit audit
    (``save(verify=True)``); the previous good checkpoints were NOT
    garbage-collected."""

    def __init__(self, step, errors):
        super().__init__(
            f"checkpoint step {step} failed post-commit audit: "
            + "; ".join(errors) + " — old checkpoints were not GC'd")
        self.step = int(step)
        self.errors = list(errors)


def _step_dirname(step):
    return f"step_{int(step):010d}"


def _file_crc32(path, chunk=1 << 20):
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return crc
            crc = zlib.crc32(b, crc)


def verify_checkpoint(path):
    """``(ok, errors)``: every shard's CRC32 recomputed against the
    manifest.  No manifest, a missing shard or a mismatch fails; a shard
    entry without a ``crc32`` (older format) is accepted."""
    from ..distributed.checkpoint import _load_manifest

    errors = []
    try:
        manifest = _load_manifest(path)
    except (OSError, ValueError) as e:
        return False, [f"manifest unreadable: {e}"]
    for leaf in manifest.get("leaves", []):
        for sh in leaf["shards"]:
            fpath = os.path.join(path, leaf["id"], sh["file"])
            want = sh.get("crc32")
            try:
                got = _file_crc32(fpath)
            except OSError as e:
                errors.append(f"{leaf['path']}/{sh['file']}: {e}")
                continue
            if want is not None and got != want:
                errors.append(f"{leaf['path']}/{sh['file']}: crc32 "
                              f"{got:#010x} != manifest {want:#010x}")
    return not errors, errors


class _HostSnapshot:
    """Deep host copies of a checkpoint tree into buffers reused from
    save to save.  ``take(tree)`` returns a tree of host tensors / numpy
    arrays the caller's later in-place writes cannot reach; device
    copies are waited for before it returns."""

    def __init__(self):
        self._bufs = {}          # (path, shape, dtype, pinned) -> tensor

    def _buffer(self, path, t):
        pin = t.device.type == "cuda"
        key = (path, tuple(t.shape), t.dtype, pin)
        buf = self._bufs.get(key)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
            self._bufs[key] = buf
        return buf

    def take(self, tree):
        devices = set()

        def copy(node, path):
            if isinstance(node, dict):
                return {k: copy(v, f"{path}/{k}") for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(copy(v, f"{path}/{i}")
                                  for i, v in enumerate(node))
            if isinstance(node, torch.Tensor):
                t = node.detach()
                buf = self._buffer(path, t)
                buf.copy_(t, non_blocking=t.device.type == "cuda")
                if t.device.type == "cuda":
                    devices.add(t.device)
                return buf
            if isinstance(node, np.ndarray):
                return np.array(node, copy=True)
            return node

        out = copy(tree, "")
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        return out


class CheckpointManager:
    """Atomic, checksummed, retained checkpoints under one directory."""

    def __init__(self, directory, keep_last_n=None, async_save=False,
                 sweep_orphans=True, verify_on_save=False, barrier=None):
        self.directory = os.fspath(directory)
        self.keep_last_n = keep_last_n
        self.async_save = bool(async_save)
        self.verify_on_save = bool(verify_on_save)
        # multi-host: a distributed.checkpoint.CommitBarrier makes the
        # step-directory rename rank-0-only and gated on every rank's ack
        self._barrier = barrier
        self._lock = threading.Lock()
        self._thread = None
        self._error = None      # guarded-by: self._lock
        self._snapshot = _HostSnapshot()
        os.makedirs(self.directory, exist_ok=True)
        if barrier is not None and barrier.rank != 0:
            sweep_orphans = False
        if sweep_orphans:
            # reclaim step_N.tmp debris of a save killed in an earlier
            # process (pass False for a read-side manager beside a live
            # trainer)
            self._sweep_tmp()

    # ------------------------------------------------------------ discovery
    def steps(self):
        """Committed step numbers, ascending (no verification)."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_RE.match, entries)
                      if m and os.path.isdir(os.path.join(self.directory,
                                                          m.group(0))))

    def step_path(self, step):
        return os.path.join(self.directory, _step_dirname(step))

    def latest(self, verify=True):
        """Newest committed (and, with ``verify``, intact) step, or None."""
        for step in reversed(self.steps()):
            if not verify:
                return step
            ok, _ = verify_checkpoint(self.step_path(step))
            if ok:
                return step
            self._count("checkpoint_corrupt_skipped_total")
        return None

    # --------------------------------------------------------------- save
    def save(self, tree, step, extra=None, verify=None):
        """Checkpoint ``tree`` as ``step``.  With ``async_save`` the host
        snapshot is taken now (after joining the previous save, whose
        buffers it reuses) and the write and commit run on a background
        thread; a background failure surfaces from :meth:`wait` or the
        next save.  ``verify=True`` audits the committed bytes before
        retention runs."""
        verify = self.verify_on_save if verify is None else bool(verify)
        self.wait()
        if not self.async_save:
            self._write_and_commit(tree, step, extra, verify=verify)
            return self.step_path(step)
        host_tree = self._snapshot.take(tree)
        self._thread = threading.Thread(
            target=self._bg_save, args=(host_tree, step, extra, verify),
            name=f"ckpt-save-{step}", daemon=True)
        self._thread.start()
        return self.step_path(step)

    def _bg_save(self, tree, step, extra, verify=False):
        t0 = time.perf_counter()
        try:
            self._write_and_commit(tree, step, extra, verify=verify)
        except BaseException as e:          # surfaced by wait()/next save
            with self._lock:
                self._error = e
            return
        from ..observability.metrics import default_registry

        default_registry().histogram(
            "checkpoint_save_seconds",
            "checkpoint save duration by mode (sync/async block the "
            "training thread; background is the overlapped write)",
            labelnames=("mode",),
        ).labels(mode="background").observe(time.perf_counter() - t0)

    def wait(self):
        """Join an in-flight async save; re-raise its failure here."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _write_and_commit(self, tree, step, extra, verify=False):
        with profiling_phase("checkpoint"):
            if self._barrier is not None:
                return self._write_and_commit_multihost(tree, step, extra,
                                                        verify)
            from ..distributed.checkpoint import save_sharded

            final = self.step_path(step)
            tmp = final + ".tmp"
            if os.path.exists(tmp):             # debris of a crashed save
                shutil.rmtree(tmp)
            save_sharded(tmp, tree, step=int(step), extra=extra)
            fault_point("checkpoint.before_commit", path=tmp)
            if os.path.isdir(final):
                # re-saving a committed step (after a fallback restore):
                # the new bytes supersede
                shutil.rmtree(final)
            os.replace(tmp, final)              # THE commit point
            fault_point("checkpoint.after_commit", path=final)
            self._after_commit(final, step, verify)

    def _after_commit(self, final, step, verify):
        self._count("checkpoint_commits_total")
        if verify:
            # audit BEFORE retention: a save that fails its re-read must
            # never cause the good checkpoints to be removed
            ok, errors = verify_checkpoint(final)
            if not ok:
                self._count("checkpoint_audit_failures_total")
                raise CheckpointAuditError(step, errors)
        self._gc()

    def _write_and_commit_multihost(self, tree, step, extra, verify):
        """Every rank writes into one shared ``step_N.tmp`` and acks its
        CRCs; rank 0 renames it once every ack arrived, then alone audits
        and collects."""
        from ..distributed.checkpoint import save_sharded

        b = self._barrier
        final = self.step_path(step)
        tmp = final + ".tmp"
        token = _step_dirname(step)

        def _prepare():
            if os.path.exists(tmp):
                shutil.rmtree(tmp)

        b.begin(token, prepare=_prepare)
        manifest = save_sharded(tmp, tree, step=int(step), extra=extra,
                                rank=b.rank)
        b.ack(token, {f"{l['id']}/{s['file']}": s["crc32"]
                      for l in manifest["leaves"] for s in l["shards"]})

        def _commit():
            fault_point("checkpoint.before_commit", path=tmp)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        b.commit(token, fn=_commit)
        if b.rank != 0:
            return
        fault_point("checkpoint.after_commit", path=final)
        self._after_commit(final, step, verify)

    # ------------------------------------------------------------- restore
    def restore(self, like_tree=None, step=None, verify=True,
                before_step=None):
        """``(step, tree, manifest)`` of the newest intact checkpoint (or
        exactly ``step``, which must verify), strictly below
        ``before_step`` when it is given; ``like_tree`` as in
        ``load_sharded``.  ``FileNotFoundError`` when nothing restores."""
        from ..distributed.checkpoint import load_sharded

        candidates = [step] if step is not None else \
            [s for s in reversed(self.steps())
             if before_step is None or s < int(before_step)]
        last_err = None
        for s in candidates:
            path = self.step_path(s)
            if verify:
                ok, errors = verify_checkpoint(path)
                if not ok:
                    if step is not None:
                        raise ValueError(
                            f"checkpoint step {s} failed verification: "
                            + "; ".join(errors))
                    self._count("checkpoint_corrupt_skipped_total")
                    last_err = errors
                    continue
            tree, manifest = load_sharded(path, like_tree=like_tree)
            return s, tree, manifest
        detail = f" (newest candidate errors: {last_err})" if last_err \
            else ""
        raise FileNotFoundError(
            f"no intact checkpoint under {self.directory!r}{detail}")

    def discard_after(self, step):
        """Remove committed checkpoints STRICTLY NEWER than ``step``;
        returns their step numbers."""
        removed = []
        for s in self.steps():
            if s > int(step):
                shutil.rmtree(self.step_path(s), ignore_errors=True)
                removed.append(s)
                self._count("checkpoint_discarded_total")
        return removed

    # ----------------------------------------------------------- retention
    def _sweep_tmp(self):
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return
        for name in entries:
            full = os.path.join(self.directory, name)
            if name.endswith(".tmp") and _STEP_RE.match(name[:-4]) \
                    and os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
                self._count("checkpoint_tmp_swept_total")

    def _gc(self):
        self._sweep_tmp()
        if self.keep_last_n is None:
            return
        steps = self.steps()
        for s in steps[:max(0, len(steps) - int(self.keep_last_n))]:
            shutil.rmtree(self.step_path(s), ignore_errors=True)
            self._count("checkpoint_gc_removed_total")

    @staticmethod
    def _count(name):
        from ..observability.metrics import default_registry

        default_registry().counter(name).inc()
