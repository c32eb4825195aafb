"""Pooling layers (the port of ``paddle_tpu/nn/layer/pooling.py``)."""
from __future__ import annotations

from ... import ops
from .layers import Layer

__all__ = ["MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D",
           "AdaptiveMaxPool2D"]


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW"):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return ops.max_pool2d(x, self.kernel_size, stride=self.stride,
                              padding=self.padding, ceil_mode=self.ceil_mode,
                              data_format=self.data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, data_format="NCHW"):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive
        self.data_format = data_format

    def forward(self, x):
        return ops.avg_pool2d(x, self.kernel_size, stride=self.stride,
                              padding=self.padding, ceil_mode=self.ceil_mode,
                              exclusive=self.exclusive,
                              data_format=self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return ops.adaptive_avg_pool2d(x, self.output_size,
                                       data_format=self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return ops.adaptive_max_pool2d(x, self.output_size,
                                       data_format=self.data_format)
