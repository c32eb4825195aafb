"""Industrial data pipeline: InMemoryDataset / QueueDataset (the port of
``paddle_tpu/io/industrial.py``).

Reference parity: paddle/fluid/framework/data_set.cc (``Dataset`` family:
file-list input, ``LoadIntoMemory``, ``LocalShuffle``/``GlobalShuffle``,
channel-fed workers) + the python facade paddle.distributed.InMemoryDataset
(fleet/dataset/). The reference feeds CTR trainers from slot-format text
files through C++ DataFeed channels.

Design (as in the JAX package): the heavy lifting the C++ channels do (parallel
parse + shuffle + worker fan-out) maps onto the framework's OWN
multiprocess DataLoader (io/multiprocess.py) — an InMemoryDataset is a
map-style Dataset whose parse happens once on load (optionally through
the fork-pool), so downstream it composes with every sampler/loader
feature instead of needing a parallel Trainer/DeviceWorker stack.
``QueueDataset`` streams the same files lazily (IterableDataset) for
corpora that don't fit host RAM.

Line format: the reference's slot format (``name:count v...``) via
``use_slots``; or a user ``parse_fn(line) -> sample``.
"""
from __future__ import annotations

import glob
import random

import numpy as np

from .dataset import Dataset, IterableDataset

__all__ = ["InMemoryDataset", "QueueDataset", "parse_slot_line"]


def _world():
    """(number of ranks, this rank) of the default process group, or
    (1, 0) when none is initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def parse_slot_line(line, slots, dense_slots=()):
    """Parse one slot-format line: whitespace tokens of
    ``slot_name:feasign`` pairs grouped per slot (the DataFeed
    MultiSlotDataFeed contract, simplified to name:value tokens).
    Returns {slot: int64 array} (+ float32 for dense slots)."""
    buckets = {s: [] for s in slots}
    for tok in line.split():
        name, _, val = tok.partition(":")
        if name in buckets:
            buckets[name].append(val)
    out = {}
    for s in slots:
        if s in dense_slots:
            out[s] = np.asarray([float(v) for v in buckets[s]], np.float32)
        else:
            out[s] = np.asarray([int(v) for v in buckets[s]], np.int64)
    return out


class InMemoryDataset(Dataset):
    """data_set.cc InMemoryDataset analog: set a file list, load, shuffle,
    iterate as a plain map-style Dataset."""

    def __init__(self):
        self._filelist = []
        self._parse_fn = None
        self._slots = None
        self._dense = ()
        self._samples = None
        self._seed = 0

    # ---- configuration (init(...) keyword parity) --------------------
    def init(self, use_var=None, parse_fn=None, use_slots=None,
             dense_slots=(), **kwargs):
        if "pipe_command" in kwargs:
            raise NotImplementedError(
                "pipe_command preprocessing is not supported: do the "
                "transform in parse_fn (runs per line at load) instead")
        if kwargs:
            raise TypeError(f"unknown init() options: {sorted(kwargs)}")
        self._parse_fn = parse_fn
        self._slots = list(use_slots) if use_slots else None
        self._dense = tuple(dense_slots)
        return self

    def set_filelist(self, filelist):
        files = []
        for f in filelist:
            hits = sorted(glob.glob(f))
            files.extend(hits if hits else [f])
        self._filelist = files
        return self

    # ---- loading ------------------------------------------------------
    def _parse(self, line):
        line = line.strip()
        if not line:
            return None
        if self._parse_fn is not None:
            return self._parse_fn(line)
        if self._slots is not None:
            return parse_slot_line(line, self._slots, self._dense)
        return line

    def load_into_memory(self):
        """Parse every file into host memory (LoadIntoMemory)."""
        self._globally_partitioned = False
        samples = []
        for path in self._filelist:
            with open(path) as f:
                for line in f:
                    s = self._parse(line)
                    if s is not None:
                        samples.append(s)
        self._samples = samples
        return self

    # ---- shuffles -----------------------------------------------------
    def local_shuffle(self, seed=None):
        self._require_loaded()
        rng = random.Random(self._seed if seed is None else seed)
        rng.shuffle(self._samples)
        self._seed += 1
        return self

    def global_shuffle(self, fleet=None, seed=None,
                       identical_filelist=False):
        """The reference shuffles ACROSS trainers by rehashing samples to
        ranks over the PS network.  Without that network there are two
        honest modes:

        - per-rank DISJOINT file shards (the common setup): cross-rank
          redistribution is impossible without comm, so this is a local
          shuffle with a rank-decorrelated seed — no sample is dropped;
        - ``identical_filelist=True``: every rank loaded the SAME full
          filelist, so a same-seed shuffle + rank-strided slice
          partitions the corpus exactly once across ranks."""
        nranks, rank = _world()
        self._require_loaded()
        base = 42 if seed is None else seed
        if identical_filelist and nranks > 1:
            if getattr(self, "_globally_partitioned", False):
                raise RuntimeError(
                    "global_shuffle(identical_filelist=True) already "
                    "partitioned this dataset across ranks; a second "
                    "call would shrink the corpus geometrically. "
                    "Reload (load_into_memory) before re-partitioning, "
                    "or use local_shuffle for per-epoch shuffling.")
            rng = random.Random(base)          # same permutation everywhere
            rng.shuffle(self._samples)
            self._samples = self._samples[rank::nranks]
            self._globally_partitioned = True
        else:
            rng = random.Random(base + rank)   # decorrelated, nothing lost
            rng.shuffle(self._samples)
        return self

    def release_memory(self):
        self._samples = None
        return self

    def get_memory_data_size(self, fleet=None):
        return len(self._samples or [])

    # ---- Dataset protocol --------------------------------------------
    def _require_loaded(self):
        if self._samples is None:
            raise RuntimeError(
                "InMemoryDataset: call load_into_memory() first")

    def __len__(self):
        self._require_loaded()
        return len(self._samples)

    def __getitem__(self, i):
        self._require_loaded()
        return self._samples[i]


class QueueDataset(IterableDataset):
    """Streaming variant (data_set.cc QueueDataset): parse lazily,
    never materialize the corpus; shard across DataLoader workers via
    get_worker_info (the channel-per-worker analog)."""

    def __init__(self):
        self._filelist = []
        self._parse_fn = None
        self._slots = None
        self._dense = ()

    init = InMemoryDataset.init
    set_filelist = InMemoryDataset.set_filelist
    _parse = InMemoryDataset._parse

    def __iter__(self):
        from .multiprocess import get_worker_info

        info = get_worker_info()
        wid = info.id if info else 0
        nw = info.num_workers if info else 1
        i = 0
        for path in self._filelist:
            with open(path) as f:
                for line in f:
                    s = self._parse(line)
                    if s is None:
                        continue
                    if i % nw == wid:
                        yield s
                    i += 1
