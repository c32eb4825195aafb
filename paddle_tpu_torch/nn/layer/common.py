"""Common layers (the port of ``paddle_tpu/nn/layer/common.py``):
``Linear`` keeps Paddle's ``[in, out]`` weight, ``y = x @ W + b``."""
from __future__ import annotations

from ... import ops
from .layers import Layer

__all__ = ["Linear", "Dropout", "Flatten"]


class Linear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                [out_features], is_bias=True, attr=bias_attr)

    def forward(self, x):
        out = ops.matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias
        return out

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x):
        return ops.dropout(x, p=self.p, training=self.training,
                           mode=self.mode)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        if x.dim() == 0:
            return x.reshape(1)
        return x.flatten(self.start_axis, self.stop_axis)
