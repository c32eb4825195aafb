"""Sparse tensors (the port of ``paddle_tpu/sparse/__init__.py``; parity:
python/paddle/sparse/ + the reference's SparseCooTensor/SparseCsrTensor,
paddle/phi/core/sparse_*_tensor.h).

A COO tensor keeps its entries as given — ``indices`` [ndim, nnz] and
``values`` [nnz], duplicates included, as the JAX package's BCOO does —
and ``to_dense`` sums duplicates.  CSR is (crows, cols, values).  The
product with a dense matrix is ``torch.sparse.mm`` on the device of the
operands; ``add`` concatenates the entries and sums duplicates
(``coalesce``: sorted, unique indices, as ``bcoo_sum_duplicates``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import convert_dtype

__all__ = ["sparse_coo_tensor", "sparse_csr_tensor", "SparseCooTensor",
           "SparseCsrTensor", "matmul", "add", "to_dense"]


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


class SparseCooTensor:
    def __init__(self, indices, values, shape):
        self._indices = indices.to(torch.int64)
        self._values = values
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return self._shape

    @property
    def nnz(self):
        return int(self._values.shape[0])

    def indices(self):
        return self._indices          # [ndim, nnz] like paddle

    def values(self):
        return self._values

    def _torch(self):
        return torch.sparse_coo_tensor(self._indices, self._values,
                                       self._shape)

    def to_dense(self):
        return self._torch().to_dense()

    def to_sparse_csr(self):
        assert len(self.shape) == 2
        rows, cols = self._indices[0], self._indices[1]
        order = torch.argsort(rows * self._shape[1] + cols, stable=True)
        counts = torch.bincount(rows, minlength=self._shape[0])
        crows = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        return SparseCsrTensor(crows, cols[order], self._values[order],
                               self._shape)

    def __repr__(self):
        return f"SparseCooTensor(shape={self.shape}, nnz={self.nnz})"


class SparseCsrTensor:
    def __init__(self, crows, cols, values, shape):
        values = _t(values)
        self._crows = _t(crows).to(device=values.device, dtype=torch.int64)
        self._cols = _t(cols).to(device=values.device, dtype=torch.int64)
        self._values = values
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return self._shape

    @property
    def nnz(self):
        return int(self._values.shape[0])

    def crows(self):
        return self._crows

    def cols(self):
        return self._cols

    def values(self):
        return self._values

    def to_dense(self):
        return self.to_sparse_coo().to_dense()

    def to_sparse_coo(self, sparse_dim=2):
        rows = torch.repeat_interleave(
            torch.arange(self._shape[0], device=self._crows.device),
            torch.diff(self._crows), output_size=self.nnz)
        return SparseCooTensor(torch.stack([rows, self._cols]),
                               self._values, self._shape)

    def __repr__(self):
        return f"SparseCsrTensor(shape={self.shape}, nnz={self.nnz})"


def sparse_coo_tensor(indices, values, shape=None, dtype=None,
                      stop_gradient=True):
    """paddle.sparse.sparse_coo_tensor parity: indices [ndim, nnz]."""
    vals = _t(values)
    idx = _t(indices).to(device=vals.device, dtype=torch.int64)
    if dtype is not None:
        vals = vals.to(convert_dtype(dtype))
    if shape is None:
        shape = tuple(int(m) + 1 for m in idx.amax(dim=1).tolist())
    return SparseCooTensor(idx, vals, shape)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None,
                      stop_gradient=True):
    vals = _t(values)
    if dtype is not None:
        vals = vals.to(convert_dtype(dtype))
    return SparseCsrTensor(crows, cols, vals, shape)


def to_dense(x):
    return x.to_dense()


def matmul(a, b):
    """sparse @ dense (paddle.sparse.matmul)."""
    if isinstance(a, SparseCsrTensor):
        a = a.to_sparse_coo()
    return torch.sparse.mm(a._torch(), _t(b))


def add(a, b):
    """sparse + sparse → sparse (same format as ``a``)."""
    if a.shape != b.shape:
        raise ValueError(f"sparse add shape mismatch: {a.shape} vs "
                         f"{b.shape}")
    want_csr = isinstance(a, SparseCsrTensor)
    aa = a.to_sparse_coo() if want_csr else a
    bb = b.to_sparse_coo() if isinstance(b, SparseCsrTensor) else b
    summed = torch.sparse_coo_tensor(
        torch.cat([aa._indices, bb._indices], dim=1),
        torch.cat([aa._values, bb._values]), a.shape).coalesce()
    out = SparseCooTensor(summed.indices(), summed.values(), a.shape)
    return out.to_sparse_csr() if want_csr else out
