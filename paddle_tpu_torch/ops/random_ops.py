"""Random sampling ops (the port of ``paddle_tpu/ops/random_ops.py``;
parity: python/paddle/tensor/random.py).

Draws come from the port's explicit generator of the device
(``core/random.py``: ``paddle.seed`` re-seeds it), or from the
``torch.Generator`` passed as ``key`` (the JAX package's explicit key).
The bits are not JAX's: the ops are held to ``paddle.seed``
reproducibility and to their distributions."""
from __future__ import annotations

import torch

from ..core.dispatch import register_op
from ..core.dtype import convert_dtype, get_default_dtype
from ..core.place import current_device
from ..core.random import generator

__all__ = ["uniform", "randn", "normal", "randint", "randperm", "rand",
           "bernoulli", "multinomial", "poisson", "standard_normal",
           "exponential"]


def _gen(key, device):
    return generator(device) if key is None else key


def _float(dtype):
    return convert_dtype(dtype) or get_default_dtype()


def _shape(shape):
    return tuple(int(s) for s in (shape or ()))


@register_op("uniform", differentiable=False)
def uniform(shape, dtype=None, min=-1.0, max=1.0, key=None):  # noqa: A002
    dev = current_device()
    out = torch.empty(_shape(shape), dtype=_float(dtype), device=dev)
    return out.uniform_(min, max, generator=_gen(key, dev))


@register_op("randn", differentiable=False)
def randn(shape, dtype=None, key=None):
    dev = current_device()
    return torch.randn(_shape(shape), dtype=_float(dtype), device=dev,
                       generator=_gen(key, dev))


@register_op("normal", differentiable=False)
def normal(mean=0.0, std=1.0, shape=None, key=None):
    dev = current_device()
    base = torch.randn(_shape(shape), dtype=get_default_dtype(),
                       device=dev, generator=_gen(key, dev))
    return base * std + mean


@register_op("randint", differentiable=False)
def randint(low=0, high=None, shape=(1,), dtype="int64", key=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    return torch.randint(low, high, _shape(shape),
                         dtype=convert_dtype(dtype), device=dev,
                         generator=_gen(key, dev))


@register_op("randperm", differentiable=False)
def randperm(n, dtype="int64", key=None):
    dev = current_device()
    return torch.randperm(n, dtype=convert_dtype(dtype), device=dev,
                          generator=_gen(key, dev))


@register_op("rand", differentiable=False)
def rand(shape, dtype=None, key=None):
    dev = current_device()
    return torch.rand(_shape(shape), dtype=_float(dtype), device=dev,
                      generator=_gen(key, dev))


@register_op("bernoulli", differentiable=False)
def bernoulli(x, key=None):
    return torch.bernoulli(x, generator=_gen(key, x.device)).to(x.dtype)


@register_op("multinomial", differentiable=False)
def multinomial(x, num_samples=1, replacement=False, key=None):
    return torch.multinomial(x, num_samples, replacement=replacement,
                             generator=_gen(key, x.device))


@register_op("poisson", differentiable=False)
def poisson(x, key=None):
    return torch.poisson(x, generator=_gen(key, x.device)).to(
        get_default_dtype())


@register_op("standard_normal", differentiable=False)
def standard_normal(shape, dtype=None, key=None):
    return randn(shape, dtype=dtype, key=key)


@register_op("exponential", differentiable=False)
def exponential(x, lam=1.0, key=None):
    return torch.empty_like(x).exponential_(
        lam, generator=_gen(key, x.device))
