"""DataLoader (the port of ``paddle_tpu/io/dataloader.py``).

Batches are built (sampled, read, collated with numpy) by one background
thread, up to ``prefetch_factor`` ahead, and pinned when the target is
the card; the iterating thread copies each to the device of
``set_device`` with ``non_blocking``, one batch ahead of its consumer
(the JAX package's ``_device_prefetch``).  The batch order
is the samplers', drawn from numpy's global state when iteration begins,
as in JAX.

``num_workers > 0`` forks worker processes that build the batches into
POSIX shared memory (``io/multiprocess.py``); the background thread
rebuilds each in pinned host memory (when the target is the card), so
the copies out of shared memory overlap the consumer's step too.  The
batch order is the sampler's, as without workers.
``use_thread_workers=True`` builds batches in threads instead, for
datasets that cannot fork (live handles, sockets)."""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..core.place import current_device
from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn"]


def default_collate_fn(batch):
    """Stack samples (tuples, dicts, arrays, tensors) into CPU tensors;
    float64 becomes float32, as in JAX."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn(list(s)) for s in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return torch.stack([s.cpu() for s in batch])
    arr = np.stack([np.asarray(s) for s in batch])
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr)


def _map(batch, fn):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(b, fn) for b in batch)
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    return fn(batch) if isinstance(batch, torch.Tensor) else batch


class _Failed:
    def __init__(self, exc):
        self.exc = exc


_DONE = object()


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 use_thread_workers=False, mp_context=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 2)
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.use_thread_workers = use_thread_workers
        self.mp_context = mp_context
        self.iterable_mode = isinstance(dataset, IterableDataset)
        if self.iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self.iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _host_batches(self, index_batches):
        if self.iterable_mode:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        else:
            for indices in index_batches:
                yield self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        device = current_device()
        # the sampler draws here, in the iterating thread, so the order
        # follows numpy's global state as the JAX loader's does
        index_batches = (None if self.iterable_mode
                         else list(self.batch_sampler))
        pin = device.type == "cuda"
        if self.num_workers > 0 and not self.use_thread_workers:
            from .multiprocess import MultiprocessIter

            # the workers' batches are rebuilt in pinned memory already
            source = self._workers = MultiprocessIter(
                self, index_batches, self.timeout, pin=pin)
            pin = False
        elif self.num_workers > 0:
            source = self._threaded_batches(index_batches)
        else:
            source = self._host_batches(index_batches)
        yield from _one_ahead(self._prefetched(source, pin), device)

    def _prefetched(self, source, pin):
        """Host batches of ``source``, built (and pinned, with ``pin``) by
        one background thread up to ``prefetch_factor`` ahead, so the
        iterating thread only queues each batch's copy to the device."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_factor)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            it = iter(source)
            try:
                for batch in it:
                    if pin:
                        batch = _map(batch, torch.Tensor.pin_memory)
                    if not put(batch):
                        return
                put(_DONE)
            except Exception as e:  # handed to the iterating thread
                put(_Failed(e))
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()        # a worker pool shuts down here

        thread = threading.Thread(target=produce, daemon=True,
                                  name="DataLoader-prefetch")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    return
                if isinstance(item, _Failed):
                    raise item.exc
                yield item
        finally:
            stop.set()
            thread.join()

    def _threaded_batches(self, index_batches):
        """``use_thread_workers``: ``num_workers`` threads build the
        batches of a map-style dataset, yielded in order (one producer
        thread for an iterable dataset)."""
        if self.iterable_mode:
            yield from self._host_batches(None)
            return
        jobs: queue.Queue = queue.Queue()
        for job in enumerate(index_batches):
            jobs.put(job)
        done = threading.Condition()
        results: dict = {}     # guarded-by: done

        def work():
            while True:
                try:
                    i, indices = jobs.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = self.collate_fn(
                        [self.dataset[j] for j in indices])
                except Exception as e:  # handed to the consumer
                    batch = _Failed(e)
                with done:
                    results[i] = batch
                    done.notify_all()

        threads = [threading.Thread(target=work, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        for i in range(len(index_batches)):
            with done:
                while i not in results:
                    done.wait()
                batch = results.pop(i)
            if isinstance(batch, _Failed):
                raise batch.exc
            yield batch


def _one_ahead(host, device):
    """Copy each host batch to ``device`` (``non_blocking`` from pinned
    memory) one batch ahead of the consumer: batch N+1's copy is queued
    before batch N is handed out (the JAX package's
    ``_device_prefetch``).  An error building batch N+1 is raised after
    batch N has been handed out, where it would be without the
    lookahead."""
    move = (lambda b: b) if device.type == "cpu" else (
        lambda b: _map(b, lambda t: t.to(device, non_blocking=True)))
    it = iter(host)
    try:
        try:
            ahead = move(next(it))
        except StopIteration:
            return
        while True:
            try:
                nxt = next(it)
            except StopIteration:
                yield ahead
                return
            except Exception:
                yield ahead
                raise
            nxt = move(nxt)
            yield ahead
            ahead = nxt
    finally:
        it.close()
