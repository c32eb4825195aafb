"""Reductions and statistics (the port of ``paddle_tpu/ops/reduction.py``;
parity: python/paddle/tensor/math.py + stat.py).  ``axis`` is an int, a
list or ``None`` (all axes); ``max``/``min`` return values only (their
gradient split evenly between ties, as JAX's); ``median`` averages the
two middle values of an even count, as ``jnp.median``."""
from __future__ import annotations

import torch

from ..core.dispatch import register_op
from ..core.dtype import convert_dtype

__all__ = ["sum", "mean", "max", "min", "prod", "amax", "amin", "std",
           "var", "median", "quantile", "nanmean", "nansum", "all", "any",
           "count_nonzero", "argmax", "argmin"]


def _dims(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(a % ndim for a in axis) if ndim else ()
    return (axis % ndim,) if ndim else ()


def _flat_axis(x, axis):
    """``(x', dim)`` with the reduced axes of ``x`` as the one last axis
    of ``x'`` (for ops that take one dim)."""
    dims = _dims(axis, x.dim())
    keep = [d for d in range(x.dim()) if d not in dims]
    y = x.permute(keep + list(dims)) if x.dim() else x.reshape(1)
    return y.reshape([x.shape[d] for d in keep] + [-1]), dims


def _keep(out, x, dims, keepdim):
    if keepdim:
        for d in sorted(dims):
            out = out.unsqueeze(d)
    return out


@register_op("sum")
def sum(x, axis=None, keepdim=False, dtype=None):  # noqa: A001
    out = torch.sum(x, dim=_dims(axis, x.dim()), keepdim=keepdim)
    return out.to(convert_dtype(dtype)) if dtype is not None else out


@register_op("mean")
def mean(x, axis=None, keepdim=False):
    return torch.mean(x, dim=_dims(axis, x.dim()), keepdim=keepdim)


@register_op("max")
def max(x, axis=None, keepdim=False):  # noqa: A001
    return torch.amax(x, dim=_dims(axis, x.dim()), keepdim=keepdim)


@register_op("min")
def min(x, axis=None, keepdim=False):  # noqa: A001
    return torch.amin(x, dim=_dims(axis, x.dim()), keepdim=keepdim)


@register_op("prod")
def prod(x, axis=None, keepdim=False, dtype=None):
    y, dims = _flat_axis(x, axis)
    out = _keep(torch.prod(y, dim=-1), x, dims, keepdim)
    return out.to(convert_dtype(dtype)) if dtype is not None else out


@register_op("amax")
def amax(x, axis=None, keepdim=False):
    return torch.amax(x, dim=_dims(axis, x.dim()), keepdim=keepdim)


@register_op("amin")
def amin(x, axis=None, keepdim=False):
    return torch.amin(x, dim=_dims(axis, x.dim()), keepdim=keepdim)


@register_op("std")
def std(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(x, dim=_dims(axis, x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@register_op("var")
def var(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(x, dim=_dims(axis, x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@register_op("median")
def median(x, axis=None, keepdim=False):
    y, dims = _flat_axis(x, axis)
    return _keep(torch.quantile(y, 0.5, dim=-1), x, dims, keepdim)


@register_op("quantile")
def quantile(x, q, axis=None, keepdim=False):
    y, dims = _flat_axis(x, axis)
    q_t = torch.as_tensor(q, dtype=y.dtype, device=y.device)
    out = torch.quantile(y, q_t, dim=-1)     # q's axes first
    if keepdim:
        for d in sorted(dims):
            out = out.unsqueeze(d + q_t.dim())
    return out


@register_op("nanmean")
def nanmean(x, axis=None, keepdim=False):
    return torch.nanmean(x, dim=_dims(axis, x.dim()), keepdim=keepdim)


@register_op("nansum")
def nansum(x, axis=None, keepdim=False):
    return torch.nansum(x, dim=_dims(axis, x.dim()), keepdim=keepdim)


@register_op("all", differentiable=False)
def all(x, axis=None, keepdim=False):  # noqa: A001
    return torch.all(x, dim=_dims(axis, x.dim()), keepdim=keepdim)


@register_op("any", differentiable=False)
def any(x, axis=None, keepdim=False):  # noqa: A001
    return torch.any(x, dim=_dims(axis, x.dim()), keepdim=keepdim)


@register_op("count_nonzero", differentiable=False)
def count_nonzero(x, axis=None, keepdim=False):
    dims = _dims(axis, x.dim())
    return _keep(torch.count_nonzero(x, dim=dims), x, dims, keepdim)


@register_op("argmax", differentiable=False)
def argmax(x, axis=None, keepdim=False, dtype="int64"):
    out = torch.argmax(x, dim=axis, keepdim=keepdim and axis is not None)
    return out.to(convert_dtype(dtype))


@register_op("argmin", differentiable=False)
def argmin(x, axis=None, keepdim=False, dtype="int64"):
    out = torch.argmin(x, dim=axis, keepdim=keepdim and axis is not None)
    return out.to(convert_dtype(dtype))
