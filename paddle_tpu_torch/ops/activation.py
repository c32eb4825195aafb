"""Activation ops (the port of ``paddle_tpu/ops/activation.py``, with
``sigmoid``, ``tanh`` and ``softplus`` of ``ops/math.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.dispatch import register_op
from ..core.random import generator

__all__ = ["relu", "relu6", "leaky_relu", "prelu", "elu", "selu", "celu",
           "gelu", "silu", "swish", "hardswish", "hardsigmoid", "hardtanh",
           "hardshrink", "softshrink", "tanhshrink", "thresholded_relu",
           "log_sigmoid", "maxout", "softmax", "log_softmax", "softsign",
           "mish", "glu", "sigmoid", "tanh", "softplus", "gumbel_softmax"]


@register_op("relu")
def relu(x):
    return torch.relu(x)


@register_op("relu6")
def relu6(x):
    return torch.clamp(x, 0, 6)


@register_op("leaky_relu")
def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


@register_op("prelu")
def prelu(x, weight):
    return torch.where(x >= 0, x, weight * x)


@register_op("elu")
def elu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


@register_op("selu")
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@register_op("celu")
def celu(x, alpha=1.0):
    return torch.clamp(x, min=0) + torch.clamp(alpha * torch.expm1(x / alpha),
                                               max=0)


@register_op("gelu")
def gelu(x, approximate=False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


@register_op("silu")
def silu(x):
    return F.silu(x)


swish = silu


@register_op("hardswish")
def hardswish(x):
    return x * torch.clamp(x + 3, 0, 6) / 6


@register_op("hardsigmoid")
def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5):
    return torch.clamp(slope * x + offset, 0, 1)


@register_op("hardtanh")
def hardtanh(x, min=-1.0, max=1.0):  # noqa: A002
    return torch.clamp(x, min, max)


@register_op("hardshrink")
def hardshrink(x, threshold=0.5):
    return torch.where(x.abs() > threshold, x, 0)


@register_op("softshrink")
def softshrink(x, threshold=0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0))


@register_op("tanhshrink")
def tanhshrink(x):
    return x - torch.tanh(x)


@register_op("thresholded_relu")
def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, 0)


@register_op("log_sigmoid")
def log_sigmoid(x):
    return F.logsigmoid(x)


@register_op("maxout")
def maxout(x, groups, axis=1):
    shape = list(x.shape)
    axis = axis % x.dim()
    shape[axis:axis + 1] = [shape[axis] // groups, groups]
    return x.reshape(shape).amax(dim=axis + 1)


@register_op("softmax")
def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


@register_op("log_softmax")
def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


@register_op("softsign")
def softsign(x):
    return x / (1 + x.abs())


@register_op("mish")
def mish(x):
    return x * torch.tanh(F.softplus(x))


@register_op("glu")
def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@register_op("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register_op("tanh")
def tanh(x):
    return torch.tanh(x)


@register_op("softplus")
def softplus(x, beta=1.0, threshold=20.0):
    bx = beta * x
    return torch.where(bx > threshold, x, torch.log1p(torch.exp(bx)) / beta)


@register_op("gumbel_softmax")
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, key=None):
    """softmax((x + g) / temperature) with Gumbel(0, 1) noise ``g`` from
    the port's generator of ``x``'s device (or ``key``, a
    ``torch.Generator``); ``hard``: the one-hot of the argmax forward,
    the soft gradient backward (straight-through)."""
    gen = generator(x.device) if key is None else key
    u = torch.rand(x.shape, generator=gen, device=x.device, dtype=x.dtype)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(x.dtype).tiny)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y + (y_hard - y).detach()
    return y
