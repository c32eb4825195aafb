"""Worker processes of the DataLoader (the port of
``paddle_tpu/io/multiprocess.py``; parity:
fluid/dataloader/dataloader_iter.py:341 _DataLoaderIterMultiProcess +
worker.py _worker_loop: worker processes, shared-memory batches, ordered
reassembly, error propagation, worker_info).

Workers are FORKED producers that run only the dataset's code (numpy,
PIL, decoding) and the collate function on the CPU.  A forked child must
never touch CUDA: it inherits a copy of the parent's CUDA context that
it cannot use, and torch refuses it ("Cannot re-initialize CUDA in
forked subprocess") or hangs.  So a worker marks itself
(``_device.IN_FORKED_WORKER``, on which ``resolve_device`` refuses a
CUDA device with a directed error) and pins torch to one CPU thread,
since OpenMP's pool does not survive a fork.  Batches travel as raw
bytes in one POSIX shared-memory segment each (the reference's
``_array_to_share_memory_tensor`` path), not through the queue's pickle
and 64 KB pipe chunks; the DataLoader's background thread copies each
segment once, into pinned host tensors when the batches go to the card,
and unlinks it.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue as pyqueue
import secrets
import time
import traceback
from multiprocessing import shared_memory

import numpy as np
import torch

from .. import _device

__all__ = ["WorkerInfo", "get_worker_info", "MultiprocessIter"]

_worker_info = None
SHM_PREFIX = "ptt_"      # every segment's name: ptt_<pid>_<token>_<w>_<i>


def segment_prefix():
    """The prefix of every segment made for this process by its
    iterators' workers."""
    return f"{SHM_PREFIX}{os.getpid()}_"


@dataclasses.dataclass
class WorkerInfo:
    id: int
    num_workers: int
    dataset: object


def get_worker_info():
    """Inside a worker: (id, num_workers, dataset); else None (parity:
    paddle.io.get_worker_info) — the hook an IterableDataset uses to
    shard its stream across workers."""
    return _worker_info


# ------------------------------------------------------------ wire format


def _flatten(batch):
    """Split a collated batch into (numpy leaves, spec to rebuild it).
    A torch tensor travels as its raw bytes with its dtype and shape;
    numpy arrays and scalars as numpy arrays."""
    if isinstance(batch, (tuple, list)):
        arrays, specs = [], []
        for b in batch:
            a, s = _flatten(b)
            arrays += a
            specs.append(s)
        return arrays, (type(batch), specs)
    if isinstance(batch, dict):
        arrays, specs = [], []
        for k, v in batch.items():
            a, s = _flatten(v)
            arrays += a
            specs.append((k, s))
        return arrays, (dict, specs)
    if isinstance(batch, torch.Tensor):
        t = batch.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return [raw], ("tensor", t.dtype, tuple(t.shape))
    if isinstance(batch, (np.ndarray, np.generic)):
        return [np.asarray(batch)], ("array",)
    return [np.asarray(batch)], ("scalar",)


def _rebuild(arrays, spec, pin):
    """Inverse of :func:`_flatten` over an iterator of arrays."""
    kind = spec[0]
    if kind in (tuple, list):
        return kind(_rebuild(arrays, s, pin) for s in spec[1])
    if kind is dict:
        return {k: _rebuild(arrays, s, pin) for k, s in spec[1]}
    a = next(arrays)
    if kind == "tensor":
        dtype, shape = spec[1], spec[2]
        out = torch.empty(shape, dtype=dtype, pin_memory=pin)
        out.reshape(-1).view(torch.uint8).numpy()[...] = a
        return out
    if kind == "scalar":
        return a.item() if a.shape == () else a.copy()
    return a.copy()


def _pack_shm(arrays, name):
    """Copy numpy arrays into ONE shared-memory segment named ``name``;
    returns the arrays' (dtype, shape, offset).  The segment outlives
    this process: the parent unlinks it."""
    total = sum(int(a.nbytes) for a in arrays)
    shm = shared_memory.SharedMemory(name=name, create=True,
                                     size=max(total, 1))
    metas, off = [], 0
    for a in arrays:
        dst = np.ndarray(a.shape, dtype=a.dtype, buffer=shm.buf, offset=off)
        np.copyto(dst, a)
        del dst                    # release the buffer export before close
        metas.append((a.dtype.str, a.shape, off))
        off += int(a.nbytes)
    shm.close()
    # ownership passes to the parent; the fork shares its resource
    # tracker, which would otherwise report the segment as leaked
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass    # silent-ok: the tracker may not know this segment
    return metas


def _unlink(name):
    try:
        seg = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return
    seg.close()
    seg.unlink()


def _unpack_shm(name, metas, spec, pin):
    """Rebuild a batch from its segment (one copy per leaf, into pinned
    tensors when ``pin``), then unlink the segment."""
    shm = shared_memory.SharedMemory(name=name)
    try:
        views = (np.ndarray(shape, dtype=np.dtype(dtype), buffer=shm.buf,
                            offset=off) for dtype, shape, off in metas)
        batch = _rebuild(views, spec, pin)
        del views
        return batch
    finally:
        shm.close()
        shm.unlink()


# ------------------------------------------------------------ worker loop


def _worker_loop(loader, worker_id, num_workers, token, index_q, result_q,
                 use_shared_memory, worker_init_fn, stop_event):
    global _worker_info
    _worker_info = WorkerInfo(id=worker_id, num_workers=num_workers,
                              dataset=loader.dataset)
    _device.IN_FORKED_WORKER = True
    torch.set_num_threads(1)
    seq = [0]

    def emit(i, batch):
        arrays, spec = _flatten(batch)
        if use_shared_memory:
            name = f"{SHM_PREFIX}{token}_{worker_id}_{seq[0]}"
            seq[0] += 1
            metas = _pack_shm(arrays, name)
            result_q.put(("shm", i, (name, metas), spec))
        else:
            result_q.put(("raw", i, arrays, spec))

    try:
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
        if loader.iterable_mode:
            # every worker iterates its own replica of the stream; the
            # dataset shards it through get_worker_info() (an unsharded
            # one yields each sample num_workers times, as the reference)
            for i, batch in enumerate(loader._host_batches(None)):
                if stop_event.is_set():
                    return
                emit((worker_id, i), batch)
            result_q.put(("done", worker_id, None, None))
            return
        while True:
            if stop_event.is_set():
                return
            job = index_q.get()
            if job is None:
                result_q.put(("done", worker_id, None, None))
                return
            i, indices = job
            batch = loader.collate_fn([loader.dataset[j] for j in indices])
            if stop_event.is_set():
                return
            emit(i, batch)
    except KeyboardInterrupt:
        pass
    except BaseException:
        result_q.put(("error", worker_id, traceback.format_exc(), None))


# ------------------------------------------------------------ parent iter


class MultiprocessIter:
    """Ordered iterator over a DataLoader's batches built by forked
    worker processes.  ``pin``: rebuild tensors in pinned host memory."""

    def __init__(self, loader, index_batches=None, timeout=0, pin=False):
        self.loader = loader
        self.nw = loader.num_workers
        self.timeout = timeout or None
        self.pin = pin
        # names this iterator's segments, under the prefix of this
        # process, which a leak check globs for
        self.token = f"{os.getpid()}_{secrets.token_hex(4)}"
        # fork by default (datasets need not pickle); "forkserver" or
        # "spawn" through DataLoader(mp_context=) for a dataset that
        # pickles
        ctx = mp.get_context(getattr(loader, "mp_context", None) or "fork")
        # bounded: each queued segment is live tmpfs memory; +nw leaves
        # room for the "done" marks
        self.result_q = ctx.Queue(
            maxsize=self.nw * loader.prefetch_factor + self.nw)
        self._stop = ctx.Event()
        self.index_q = ctx.Queue() if not loader.iterable_mode else None
        self._procs = []
        self._pending = None
        self._n_batches = None
        if not loader.iterable_mode:
            self._pending = list(enumerate(index_batches))
            self._n_batches = len(self._pending)
        for w in range(self.nw):
            p = ctx.Process(
                target=_worker_loop,
                args=(loader, w, self.nw, self.token, self.index_q,
                      self.result_q, loader.use_shared_memory,
                      loader.worker_init_fn, self._stop),
                daemon=True)
            p.start()
            self._procs.append(p)

    @property
    def worker_pids(self):
        return [p.pid for p in self._procs]

    def _drain_one(self, timeout=None):
        """Pop and discard one pending result, unlinking its segment (an
        undrained segment would stay in /dev/shm for good)."""
        kind, _, payload, _spec = (self.result_q.get_nowait()
                                   if timeout is None
                                   else self.result_q.get(timeout=timeout))
        if kind == "shm":
            _unlink(payload[0])

    def _shutdown(self):
        # a cooperative stop first: a worker blocked in result_q.put()
        # holds a segment whose name has not reached us, so keep draining
        # until its put completes and it sees the stop
        self._stop.set()
        if self.index_q is not None:
            # map-mode workers blocked in index_q.get() never reach the
            # stop check: one None each wakes them
            for _ in range(self.nw):
                try:
                    self.index_q.put_nowait(None)
                except Exception:
                    break   # silent-ok: a full or closed queue: the
                    #         close wakes them
        deadline = time.monotonic() + 10.0
        while (any(p.is_alive() for p in self._procs)
               and time.monotonic() < deadline):
            try:
                self._drain_one(timeout=0.05)
            except pyqueue.Empty:
                pass
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=1.0)
        self._procs = []
        try:
            while True:
                self._drain_one()
        except pyqueue.Empty:
            pass
        # a worker terminated between creating its segment and queueing
        # its name leaves the segment unnamed to us: sweep by token
        shm_dir = "/dev/shm"
        if os.path.isdir(shm_dir):
            for f in os.listdir(shm_dir):
                if f.startswith(f"{SHM_PREFIX}{self.token}_"):
                    _unlink(f)

    def _get(self):
        """Pop a result, polling the workers' liveness: a worker killed
        by the OS (a non-zero exit code) raises naming it within one poll,
        and workers that all exited cleanly without the awaited batch
        raise after one grace drain, instead of hanging."""
        waited = 0.0
        poll = 0.5
        # lint-ok: bounded-retries unbounded by design when the caller
        # asked for timeout=None; a dead worker raises via _raise_worker
        while True:
            try:
                return self.result_q.get(
                    timeout=poll if self.timeout is None
                    else min(poll, max(0.05, self.timeout - waited)))
            except pyqueue.Empty:
                waited += poll
                dead = [(w, p.exitcode) for w, p in enumerate(self._procs)
                        if not p.is_alive() and p.exitcode not in (0, None)]
                if dead:
                    wid, code = dead[0]
                    self._raise_worker(
                        wid, f"worker process died (exitcode {code}) — "
                             f"killed by the OS (OOM?) or a native crash; "
                             f"no traceback could be sent")
                if self._procs and all(not p.is_alive()
                                       for p in self._procs):
                    try:
                        return self.result_q.get(timeout=1.0)
                    except pyqueue.Empty:
                        pass
                    self._shutdown()
                    raise RuntimeError(
                        "all DataLoader workers exited without producing "
                        "the awaited batch")
                if self.timeout is not None and waited >= self.timeout:
                    self._shutdown()
                    raise RuntimeError(
                        f"DataLoader worker timed out after "
                        f"{self.timeout}s")

    def _decode(self, kind, payload, spec):
        if kind == "shm":
            name, metas = payload
            return _unpack_shm(name, metas, spec, self.pin)
        return _rebuild(iter(payload), spec, self.pin)

    def _raise_worker(self, wid, tb):
        self._shutdown()
        raise RuntimeError(f"DataLoader worker {wid} failed:\n{tb}")

    def __iter__(self):
        try:
            if self.loader.iterable_mode:
                yield from self._iter_streams()
            else:
                yield from self._iter_indexed()
        finally:
            self._shutdown()

    def _iter_indexed(self):
        # keep nw * prefetch_factor jobs in flight
        window = self.nw * self.loader.prefetch_factor
        submitted = 0
        for _ in range(min(window, self._n_batches)):
            self.index_q.put(self._pending[submitted])
            submitted += 1
        buffered, next_idx = {}, 0
        while next_idx < self._n_batches:
            while next_idx not in buffered:
                kind, idx, payload, spec = self._get()
                if kind == "error":
                    self._raise_worker(idx, payload)
                buffered[idx] = self._decode(kind, payload, spec)
            yield buffered.pop(next_idx)
            next_idx += 1
            if submitted < self._n_batches:
                self.index_q.put(self._pending[submitted])
                submitted += 1
        for _ in range(self.nw):
            self.index_q.put(None)

    def _iter_streams(self):
        """Iterable datasets: batches arrive tagged (worker, local index)
        and are yielded round-robin over the workers (w0:b0, w1:b0, ...,
        w0:b1, ...), finished workers dropping out of the rotation."""
        buffered = {}
        finished = [False] * self.nw
        counts = [0] * self.nw
        local = [0] * self.nw
        w = 0

        def exhausted(i):
            return finished[i] and local[i] >= counts[i]

        while not all(exhausted(i) for i in range(self.nw)):
            if exhausted(w):
                w = (w + 1) % self.nw
                continue
            key = (w, local[w])
            if key in buffered:
                yield buffered.pop(key)
                local[w] += 1
                w = (w + 1) % self.nw
                continue
            kind, idx, payload, spec = self._get()
            if kind == "error":
                self._raise_worker(idx, payload)
            elif kind == "done":
                finished[idx] = True
            else:
                wid, li = idx
                counts[wid] += 1
                buffered[(wid, li)] = self._decode(kind, payload, spec)
