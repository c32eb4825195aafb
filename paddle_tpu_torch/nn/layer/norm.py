"""Normalisation layers (the port of ``paddle_tpu/nn/layer/norm.py``).

Batch norm keeps fp32 ``_mean``/``_variance`` buffers and updates them
with Paddle's momentum, ``running = m·running + (1 − m)·batch`` (m = 0.9),
from the biased batch variance, as the JAX package does; it is not
``torch.nn.BatchNorm2d``, which stores the unbiased variance and takes
momentum as 1 − m."""
from __future__ import annotations

import torch

from ... import ops
from ...core.place import current_device
from ..initializer import Constant
from .layers import Layer

__all__ = ["BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "LayerNorm",
           "GroupNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                [num_features], default_initializer=Constant(1.0),
                attr=weight_attr)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter([num_features], is_bias=True,
                                              attr=bias_attr)
        dev = current_device()
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        use_stats = self.use_global_stats
        if use_stats is None:
            use_stats = not self.training
        if use_stats:
            return ops.batch_norm_infer(
                x, self._mean, self._variance, self.weight, self.bias,
                epsilon=self.epsilon, data_format=self.data_format)
        out, mean, var = ops.batch_norm_train(
            x, self.weight, self.bias, epsilon=self.epsilon,
            data_format=self.data_format)
        m = self.momentum
        with torch.no_grad():
            self._mean.copy_(m * self._mean + (1 - m) * mean)
            self._variance.copy_(m * self._variance + (1 - m) * var)
        return out

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                self.normalized_shape, default_initializer=Constant(1.0),
                attr=weight_attr)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                self.normalized_shape, is_bias=True, attr=bias_attr)

    def forward(self, x):
        return ops.layer_norm(x, self.weight, self.bias, epsilon=self.epsilon,
                              normalized_ndim=len(self.normalized_shape))


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                [num_channels], default_initializer=Constant(1.0),
                attr=weight_attr)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter([num_channels], is_bias=True)

    def forward(self, x):
        return ops.group_norm(x, self.num_groups, self.weight, self.bias,
                              epsilon=self.epsilon)
