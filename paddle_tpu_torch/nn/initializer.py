"""Weight initializers (the port of ``paddle_tpu/nn/initializer.py``).

The same fans and distributions as the JAX package; the values come from
the port's generator of the target device (``core.random``), so they are
not JAX's bits: tests carry weights across instead."""
from __future__ import annotations

import math

import torch

from ..core.dtype import convert_dtype
from ..core.random import generator

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "calculate_gain",
]


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: paddle stores OIHW for conv, (in, out) for linear
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv2d": 1.0,
        "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    return gains[nonlinearity]


class Initializer:
    """``init(shape, dtype, device)`` → a new tensor."""

    def __call__(self, shape, dtype, device):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device):
        return torch.full(tuple(shape), self.value,
                          dtype=convert_dtype(dtype), device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device):
        out = torch.empty(tuple(shape), dtype=convert_dtype(dtype),
                          device=device)
        return out.normal_(self.mean, self.std, generator=generator(device))


class TruncatedNormal(Initializer):
    """Normal truncated to ±2 standard deviations, as JAX's
    ``truncated_normal(-2, 2)``."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device):
        out = torch.empty(tuple(shape), dtype=convert_dtype(dtype),
                          device=device)
        return torch.nn.init.trunc_normal_(
            out, self.mean, self.std, self.mean - 2 * self.std,
            self.mean + 2 * self.std, generator=generator(device))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device):
        out = torch.empty(tuple(shape), dtype=convert_dtype(dtype),
                          device=device)
        return out.uniform_(self.low, self.high,
                            generator=generator(device))


class XavierNormal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype, device):
        fan_in, fan_out = _fans(shape)
        std = self.gain * math.sqrt(2.0 / (fan_in + fan_out))
        return Normal(0.0, std)(shape, dtype, device)


class XavierUniform(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype, device):
        fan_in, fan_out = _fans(shape)
        limit = self.gain * math.sqrt(6.0 / (fan_in + fan_out))
        return Uniform(-limit, limit)(shape, dtype, device)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, nonlinearity="relu", negative_slope=0.0):
        self.fan_in = fan_in
        self.nonlinearity = nonlinearity
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype, device):
        fan_in = self.fan_in or _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / math.sqrt(fan_in))(shape, dtype, device)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, nonlinearity="relu", negative_slope=0.0):
        self.fan_in = fan_in
        self.nonlinearity = nonlinearity
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype, device):
        fan_in = self.fan_in or _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fan_in)
        return Uniform(-limit, limit)(shape, dtype, device)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype, device):
        return torch.as_tensor(self.value, dtype=convert_dtype(dtype),
                               device=device).reshape(tuple(shape)).clone()
