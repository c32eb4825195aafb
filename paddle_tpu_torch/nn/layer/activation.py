"""Activation layers (the port of ``paddle_tpu/nn/layer/activation.py``)."""
from __future__ import annotations

from ... import ops
from ..initializer import Constant
from .layers import Layer

__all__ = [
    "ReLU", "ReLU6", "LeakyReLU", "PReLU", "ELU", "SELU", "CELU", "GELU",
    "Silu", "Swish", "Hardswish", "Hardsigmoid", "Hardtanh", "Hardshrink",
    "Softshrink", "Tanhshrink", "ThresholdedReLU", "LogSigmoid", "Maxout",
    "Softmax", "LogSoftmax", "Softplus", "Softsign", "Mish", "Sigmoid",
    "Tanh", "GLU",
]


def _simple(name, op_name):
    op = getattr(ops, op_name)

    class _Act(Layer):
        def __init__(self, **kwargs):
            super().__init__()
            self._kwargs = kwargs

        def forward(self, x):
            return op(x, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
Sigmoid = _simple("Sigmoid", "sigmoid")
Tanh = _simple("Tanh", "tanh")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "silu")
Hardswish = _simple("Hardswish", "hardswish")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
Softsign = _simple("Softsign", "softsign")
Mish = _simple("Mish", "mish")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
SELU = _simple("SELU", "selu")


class GELU(Layer):
    def __init__(self, approximate=False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return ops.gelu(x, approximate=self.approximate)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return ops.leaky_relu(x, negative_slope=self.negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return ops.elu(x, alpha=self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return ops.celu(x, alpha=self.alpha)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return ops.hardshrink(x, threshold=self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return ops.softshrink(x, threshold=self.threshold)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return ops.thresholded_relu(x, threshold=self.threshold)


class Softmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return ops.softmax(x, axis=self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return ops.log_softmax(x, axis=self.axis)


class GLU(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return ops.glu(x, axis=self.axis)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None):
        super().__init__()
        self.weight = self.create_parameter(
            [num_parameters], default_initializer=Constant(init),
            attr=weight_attr)

    def forward(self, x):
        w = self.weight
        if w.numel() > 1:
            w = w.reshape([1, -1] + [1] * (x.dim() - 2))
        return ops.prelu(x, w)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0):  # noqa: A002
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return ops.hardtanh(x, min=self.min, max=self.max)


class Maxout(Layer):
    def __init__(self, groups, axis=1):
        super().__init__()
        self.groups = groups
        self.axis = axis

    def forward(self, x):
        return ops.maxout(x, self.groups, axis=self.axis)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0):
        super().__init__()
        self.beta = beta
        self.threshold = threshold

    def forward(self, x):
        return ops.softplus(x, beta=self.beta, threshold=self.threshold)
