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
           "GroupNorm", "InstanceNorm2D", "RMSNorm", "SyncBatchNorm",
           "SpectralNorm"]


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


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm.  On one card (the port's training runs
    one process a card) its batch statistics are the card's batch, so it
    is ``BatchNorm``, as the JAX package's is outside a mesh."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            new = SyncBatchNorm(layer.num_features, layer.momentum,
                                layer.epsilon,
                                data_format=layer.data_format)
            new.set_state_dict(layer.state_dict())
            return new
        return layer


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


class RMSNorm(Layer):
    """LLaMA-family RMS norm, weight initialised to ones."""

    def __init__(self, hidden_size, epsilon=1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], default_initializer=Constant(1.0))

    def forward(self, x):
        return ops.rms_norm(x, self.weight, epsilon=self.epsilon)


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        self.epsilon = epsilon
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                [num_features], default_initializer=Constant(1.0))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter([num_features], is_bias=True)

    def forward(self, x):
        return ops.instance_norm(x, self.weight, self.bias,
                                 epsilon=self.epsilon)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma from ``power_iters`` power iterations on
    the weight reshaped to [weight_shape[dim], -1] from the (non-trained)
    vectors ``weight_u``/``weight_v``, drawn from N(0, 1).  As in the JAX
    package, the iteration's vectors are not written back."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12):
        super().__init__()
        from ..initializer import Normal

        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.weight_u = self.create_parameter(
            [h], default_initializer=Normal(0, 1))
        self.weight_v = self.create_parameter(
            [w], default_initializer=Normal(0, 1))
        self.weight_u.requires_grad_(False)
        self.weight_v.requires_grad_(False)

    def forward(self, weight):
        w = ops.reshape(ops.moveaxis(weight, self.dim, 0),
                        [weight.shape[self.dim], -1])
        u, v = self.weight_u, self.weight_v
        for _ in range(self.power_iters):
            v_new = ops.matmul(ops.transpose_last2(w), ops.reshape(u, [-1, 1]))
            v = ops.reshape(v_new, [-1]) / (ops.norm(v_new) + self.eps)
            u_new = ops.matmul(w, ops.reshape(v, [-1, 1]))
            u = ops.reshape(u_new, [-1]) / (ops.norm(u_new) + self.eps)
        sigma = ops.matmul(ops.reshape(u, [1, -1]),
                           ops.matmul(w, ops.reshape(v, [-1, 1])))
        return weight / ops.reshape(sigma, [])
