"""Convolution layers (the port of ``paddle_tpu/nn/layer/conv.py``):
Paddle's OIHW weights ((in, out/groups, ...) when transposed), drawn
``KaimingUniform(fan_in)``, and a zero bias unless ``bias_attr=False``."""
from __future__ import annotations

import math

from ... import ops
from ..initializer import KaimingUniform
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose"]


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd,
                 stride=1, padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format=None,
                 transposed=False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * nd
        self.kernel_size = tuple(kernel_size)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        if transposed:
            w_shape = [in_channels, out_channels // groups, *self.kernel_size]
        else:
            w_shape = [out_channels, in_channels // groups, *self.kernel_size]
        fan_in = (in_channels // groups) * math.prod(self.kernel_size)
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr,
            default_initializer=KaimingUniform(fan_in=fan_in))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter([out_channels], is_bias=True,
                                              attr=bias_attr)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2,
                         stride, padding, dilation, groups,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return ops.conv2d(x, self.weight, self.bias, stride=self.stride,
                          padding=self.padding, dilation=self.dilation,
                          groups=self.groups, data_format=self.data_format)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1,
                         stride, padding, dilation, groups,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return ops.conv1d(x, self.weight, self.bias, stride=self.stride,
                          padding=self.padding, dilation=self.dilation,
                          groups=self.groups)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3,
                         stride, padding, dilation, groups,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return ops.conv3d(x, self.weight, self.bias, stride=self.stride,
                          padding=self.padding, dilation=self.dilation,
                          groups=self.groups)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2,
                         stride, padding, dilation, groups,
                         weight_attr, bias_attr, data_format, transposed=True)
        self.output_padding = output_padding

    def forward(self, x):
        return ops.conv2d_transpose(
            x, self.weight, self.bias, stride=self.stride,
            padding=self.padding, output_padding=self.output_padding,
            dilation=self.dilation, groups=self.groups,
            data_format=self.data_format)
