"""Linear algebra ops (the port of ``paddle_tpu/ops/linalg.py``; parity:
python/paddle/tensor/linalg.py).

Precision (the JAX package's ``mxu_precision``): fp32 operands multiply
in true fp32 — TF32 is switched off for the call on the card
(``_exact``), whatever ``torch.backends.cuda.matmul.allow_tf32`` says
outside it — and a half-precision ``matmul`` accumulates in fp32 and is
cast back to ``x``'s dtype.  ``lstsq`` is the SVD solution
(``jnp.linalg.lstsq``'s: residuals only where M > N at full rank),
``histogram`` counts in ``bins`` equal bins over [min, max] (the data's
range when both are 0)."""
from __future__ import annotations

import contextlib

import torch

from ..core.dispatch import register_op

__all__ = ["matmul", "mm", "bmm", "dot", "inner", "outer", "cross", "t",
           "norm", "dist", "trace", "kron", "matrix_power", "inverse",
           "pinv", "det", "slogdet", "cholesky", "qr", "svd", "eigh",
           "eigvalsh", "matrix_rank", "solve", "triangular_solve", "lstsq",
           "multi_dot", "einsum", "mv", "histogram", "bincount"]


@contextlib.contextmanager
def _exact(*arrays):
    """TF32 off around the call when an fp32 operand lies on the card."""
    fp32 = any(isinstance(a, torch.Tensor) and a.is_cuda
               and a.dtype == torch.float32 for a in arrays)
    flag = torch.backends.cuda.matmul.allow_tf32
    if not (fp32 and flag):
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


@register_op("matmul")
def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    with _exact(x, y):
        if x.dtype == y.dtype:
            return torch.matmul(x, y)
        ct = torch.promote_types(x.dtype, y.dtype)
        out = torch.matmul(x.to(ct), y.to(ct))
    return out.to(x.dtype) if x.dtype in (torch.bfloat16,
                                          torch.float16) else out


@register_op("mm")
def mm(x, y):
    with _exact(x, y):
        return torch.matmul(x, y)


@register_op("bmm")
def bmm(x, y):
    with _exact(x, y):
        return torch.matmul(x, y)


@register_op("dot")
def dot(x, y):
    return torch.sum(x * y, dim=-1)


@register_op("inner")
def inner(x, y):
    with _exact(x, y):
        return torch.inner(x, y)


@register_op("outer")
def outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@register_op("cross")
def cross(x, y, axis=None):
    if axis is None:
        axis = next((i for i, s in enumerate(x.shape) if s == 3), -1)
    return torch.linalg.cross(x, y, dim=axis)


@register_op("t")
def t(x):
    return x if x.dim() < 2 else x.transpose(-1, -2)


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


@register_op("norm")
def norm(x, p="fro", axis=None, keepdim=False):
    if p == "fro":
        if axis is None:
            return torch.sqrt(torch.sum(torch.square(x)))
        return torch.sqrt(torch.sum(torch.square(x), dim=_axes(axis),
                                    keepdim=keepdim))
    if p == float("inf"):
        return torch.amax(x.abs(), dim=() if axis is None else _axes(axis),
                          keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(x.abs(), dim=() if axis is None else _axes(axis),
                          keepdim=keepdim)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.sum(x.abs() ** p, dim=_axes(axis),
                     keepdim=keepdim) ** (1.0 / p)


@register_op("dist")
def dist(x, y, p=2.0):
    d = x - y
    if p == float("inf"):
        return d.abs().amax()
    if p == 0:
        return torch.sum(d != 0).to(x.dtype)
    return torch.sum(d.abs() ** p) ** (1.0 / p)


@register_op("trace_op")
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2).sum(-1)


@register_op("kron")
def kron(x, y):
    return torch.kron(x, y)


@register_op("matrix_power")
def matrix_power(x, n):
    with _exact(x):
        return torch.linalg.matrix_power(x, n)


@register_op("inverse")
def inverse(x):
    return torch.linalg.inv(x)


@register_op("pinv")
def pinv(x, rcond=1e-15):
    return torch.linalg.pinv(x, rtol=rcond)


@register_op("det")
def det(x):
    return torch.linalg.det(x)


@register_op("slogdet")
def slogdet(x):
    sign, logabs = torch.linalg.slogdet(x)
    return sign, logabs


@register_op("cholesky")
def cholesky(x, upper=False):
    return torch.linalg.cholesky(x, upper=upper)


@register_op("qr")
def qr(x, mode="reduced"):
    q, r = torch.linalg.qr(x, mode=mode)
    return q, r


@register_op("svd")
def svd(x, full_matrices=False):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh


@register_op("eigh")
def eigh(x, UPLO="L"):
    w, v = torch.linalg.eigh(x, UPLO=UPLO)
    return w, v


@register_op("eigvalsh")
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@register_op("matrix_rank", differentiable=False)
def matrix_rank(x, tol=None):
    if tol is None:
        return torch.linalg.matrix_rank(x)
    return torch.linalg.matrix_rank(x, rtol=tol)


@register_op("solve")
def solve(x, y):
    return torch.linalg.solve(x, y)


@register_op("triangular_solve")
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    if transpose:
        x, upper = x.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


@register_op("lstsq")
def lstsq(x, y, rcond=None):
    """(solution, residuals, rank, singular values), by the SVD."""
    m, n = x.shape[-2:]
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(x.dtype).eps * max(m, n)
    keep = s > rcond * s.amax()
    inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    yy = y if y.dim() == x.dim() else y.unsqueeze(-1)
    with _exact(x, y):
        sol = vh.transpose(-1, -2) @ (inv.unsqueeze(-1) *
                                      (u.transpose(-1, -2) @ yy))
    rank = keep.sum(-1)
    if y.dim() != x.dim():
        sol = sol.squeeze(-1)
    if m > n and int(rank) == n:
        with _exact(x, sol):
            res = torch.sum(torch.square(x @ sol - y), dim=0)
    else:
        res = torch.zeros((0,), dtype=x.dtype, device=x.device)
    return sol, res, rank, s


@register_op("multi_dot")
def multi_dot(xs):
    xs = list(xs)
    with _exact(*xs):
        return torch.linalg.multi_dot(xs)


@register_op("einsum")
def einsum(equation, *operands):
    with _exact(*operands):
        return torch.einsum(equation, *operands)


@register_op("mv")
def mv(x, vec):
    with _exact(x, vec):
        return torch.matmul(x, vec)


@register_op("histogram", differentiable=False)
def histogram(x, bins=100, min=0, max=0):  # noqa: A002
    lo, hi = float(min), float(max)
    if lo == 0 and hi == 0:
        lo, hi = float(x.min()), float(x.max())
    return torch.histc(x.float(), bins=bins, min=lo, max=hi).to(torch.int64)


@register_op("bincount", differentiable=False)
def bincount(x, weights=None, minlength=0):
    return torch.bincount(x, weights=weights, minlength=minlength)
