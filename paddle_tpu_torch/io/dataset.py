"""Datasets (the port of ``paddle_tpu/io/dataset.py``; numpy only, as
there)."""
from __future__ import annotations

import bisect

import numpy as np

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(np.asarray(t)[idx] for t in self.tensors)

    def __len__(self):
        return len(np.asarray(self.tensors[0]))


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cum, idx)
        prev = 0 if ds_idx == 0 else self.cum[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if sum(lengths) != total:
        raise ValueError("sum of lengths must equal dataset length")
    perm = np.random.permutation(total)
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out
