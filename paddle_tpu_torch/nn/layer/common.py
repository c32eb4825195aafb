"""Common layers (the port of ``paddle_tpu/nn/layer/common.py``):
``Linear`` keeps Paddle's ``[in, out]`` weight, ``y = x @ W + b``;
``Bilinear``'s weight is ``[out, in1, in2]`` and its bias ``[1, out]``;
``Embedding`` draws its table from N(0, 1) and zeroes ``padding_idx``'s
row, as the JAX package does."""
from __future__ import annotations

import torch

from ... import ops
from ..initializer import Normal, XavierUniform
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Flatten",
           "Pad2D", "Upsample", "UpsamplingBilinear2D",
           "UpsamplingNearest2D", "Bilinear", "CosineSimilarity", "Unfold"]


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


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return ops.embedding(x, self.weight, padding_idx=self.padding_idx)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return ops.dropout2d(x, p=self.p, training=self.training,
                             data_format=self.data_format)


class Pad2D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return ops.pad(x, self.padding, mode=self.mode, value=self.value,
                       data_format=self.data_format)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW"):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.data_format = data_format

    def forward(self, x):
        return ops.interpolate(x, size=self.size,
                               scale_factor=self.scale_factor,
                               mode=self.mode,
                               align_corners=self.align_corners,
                               data_format=self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size=size, scale_factor=scale_factor,
                         mode="bilinear", align_corners=True,
                         data_format=data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size=size, scale_factor=scale_factor,
                         mode="nearest", data_format=data_format)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=XavierUniform())
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter([1, out_features],
                                              is_bias=True)

    def forward(self, x1, x2):
        out = ops.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        if self.bias is not None:
            out = ops.add(out, self.bias)
        return out


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return ops.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return ops.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                          self.dilations)
