"""Tensor creation ops (the port of ``paddle_tpu/ops/creation.py``; parity:
python/paddle/tensor/creation.py).  Tensors are made on the current
device (``set_device``), in the default dtype where none is given, as in
the JAX package; ``empty`` is zeros, as there."""
from __future__ import annotations

import torch

from ..core.dispatch import register_op
from ..core.dtype import convert_dtype, get_default_dtype
from ..core.place import current_device
from ..core.tensor import tensor_ctor  # noqa: F401

__all__ = ["zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
           "arange", "linspace", "eye", "diag", "diagflat", "tril", "triu",
           "meshgrid", "assign", "clone", "empty", "empty_like", "complex",
           "tensor_ctor"]


def _dt(dtype):
    return get_default_dtype() if dtype is None else convert_dtype(dtype)


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, int):
        shape = [shape]
    return tuple(int(s) for s in shape)


@register_op("zeros", differentiable=False)
def zeros(shape, dtype=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=current_device())


@register_op("ones", differentiable=False)
def ones(shape, dtype=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype),
                      device=current_device())


@register_op("full", differentiable=False)
def full(shape, fill_value, dtype=None):
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=current_device())


@register_op("zeros_like")
def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


@register_op("ones_like")
def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=convert_dtype(dtype))


@register_op("full_like")
def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=convert_dtype(dtype))


@register_op("arange", differentiable=False)
def arange(start=0, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=convert_dtype(dtype),
                        device=current_device())


@register_op("linspace", differentiable=False)
def linspace(start, stop, num, dtype=None):
    return torch.linspace(start, stop, int(num), dtype=_dt(dtype),
                          device=current_device())


@register_op("eye", differentiable=False)
def eye(num_rows, num_columns=None, dtype=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=_dt(dtype),
                     device=current_device())


@register_op("diag")
def diag(x, offset=0):
    return torch.diag(x, diagonal=offset)


@register_op("diagflat")
def diagflat(x, offset=0):
    return torch.diagflat(x, offset=offset)


@register_op("tril")
def tril(x, diagonal=0):
    return torch.tril(x, diagonal=diagonal)


@register_op("triu")
def triu(x, diagonal=0):
    return torch.triu(x, diagonal=diagonal)


@register_op("meshgrid")
def meshgrid(*args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return tuple(torch.meshgrid(*args, indexing="ij"))


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    return torch.as_tensor(x, device=current_device())


@register_op("assign")
def assign(x):
    return _copy(x)


@register_op("clone")
def clone(x):
    return _copy(x)


@register_op("empty", differentiable=False)
def empty(shape, dtype=None):
    return zeros(shape, dtype)


@register_op("empty_like", differentiable=False)
def empty_like(x, dtype=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


@register_op("complex")
def complex(real, imag):  # noqa: A001
    return torch.complex(real, imag)
