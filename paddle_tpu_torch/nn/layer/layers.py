"""Layer base class (the port of ``paddle_tpu/nn/layer/layers.py``).

``Layer`` is a ``torch.nn.Module`` with Paddle's surface on top:
``create_parameter``, ``register_buffer(persistable=)``, list-returning
``parameters``/``sublayers``, ``state_dict`` (parameters, then the
persistable buffers, under the JAX package's structured names, so a JAX
``state_dict()`` loads without renaming), ``set_state_dict`` (torch
tensors or numpy arrays) and the forward pre/post hooks.  Parameters are
``Parameter``s (``torch.nn.Parameter`` with Paddle's ``name`` and
``optimize_attr``); autograd is torch's.  The JAX package's
``raw_state``/``swap_state`` are its jit plumbing and have no counterpart
here (``torch.func.functional_call`` is one if ever needed)."""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ...core.dtype import convert_dtype, get_default_dtype
from ...core.place import current_device
from ...core.tensor import Parameter
from ..initializer import Constant, XavierUniform

__all__ = ["Layer", "Parameter", "Sequential", "LayerList", "ParameterList",
           "Identity"]


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype=None):
        super().__init__()
        self._dtype = convert_dtype(dtype) or get_default_dtype()

    # -------------------------------------------------------------- registry
    def register_buffer(self, name, tensor, persistable=True):
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor),
                                     device=current_device())
        super().register_buffer(name, tensor, persistent=persistable)

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def create_parameter(self, shape, dtype=None, is_bias=False,
                         default_initializer=None, attr=None):
        """A new ``Parameter`` on the current device (``set_device``).
        Initializers default as in the JAX package (and the reference):
        Xavier-uniform for weights, zeros for biases; ``attr`` (a
        ``ParamAttr``) may name another, a learning-rate multiplier, a
        name, or ``trainable=False``."""
        dtype = convert_dtype(dtype) or self._dtype
        init = default_initializer
        if attr is not None and getattr(attr, "initializer", None) is not None:
            init = attr.initializer
        if init is None:
            init = Constant(0.0) if is_bias else XavierUniform()
        with torch.no_grad():
            data = init(list(shape), dtype, current_device())
        trainable = attr is None or getattr(attr, "trainable", True)
        p = Parameter(data, requires_grad=bool(trainable))
        if attr is not None:
            if getattr(attr, "learning_rate", None) is not None:
                p.optimize_attr["learning_rate"] = attr.learning_rate
            if getattr(attr, "name", None):
                p.name = attr.name
            p.regularizer = getattr(attr, "regularizer", None)
        return p

    # ------------------------------------------------------------- traversal
    def parameters(self, include_sublayers=True):
        return list(super().parameters(recurse=include_sublayers))

    def sublayers(self, include_self=False):
        mods = list(self.modules())
        return mods if include_self else mods[1:]

    def named_sublayers(self, prefix="", include_self=False):
        for name, layer in self.named_modules(prefix=prefix):
            if layer is not self or include_self:
                yield name, layer

    # ------------------------------------------------------------ state dict
    def state_dict(self, *args, structured_name_prefix="", **kwargs):
        """Parameters first, then persistable buffers (the JAX order);
        called by torch internals with torch's arguments, it is torch's."""
        if args or kwargs:
            return super().state_dict(*args, **kwargs)
        out = OrderedDict()
        for name, p in self.named_parameters(prefix=structured_name_prefix):
            out[name] = p
        persistent = set(super().state_dict(keep_vars=True))
        for name, b in self.named_buffers():
            if name in persistent:
                key = (f"{structured_name_prefix}.{name}"
                       if structured_name_prefix else name)
                out[key] = b
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy every entry of ``state_dict`` (torch tensors or numpy
        arrays) into the tensor of the same name, in its dtype and on its
        device; returns ``(missing, unexpected)`` names."""
        own = self.state_dict()
        missing = [name for name in own if name not in state_dict]
        unexpected = [name for name in state_dict if name not in own]
        with torch.no_grad():
            for name, target in own.items():
                if name not in state_dict:
                    continue
                value = state_dict[name]
                if not isinstance(value, torch.Tensor):
                    value = torch.from_numpy(np.array(value, copy=True))
                if tuple(value.shape) != tuple(target.shape):
                    raise ValueError(
                        f"set_state_dict: {name} has shape "
                        f"{tuple(value.shape)}, expected "
                        f"{tuple(target.shape)}")
                target.copy_(value.to(target.dtype))
        return missing, unexpected

    load_dict = set_state_dict

    # ------------------------------------------------------------ run modes
    def astype(self, dtype):
        return self.to(dtype=convert_dtype(dtype))

    # ----------------------------------------------------------------- hooks
    def register_forward_post_hook(self, hook):
        """``hook(layer, args, out)``, returning a new output or None."""
        return self.register_forward_hook(hook)


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            for name, layer in layers[0]:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or ()):
            self.add_sublayer(str(i), layer)

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._modules.values())[idx]
        return self._modules[str(idx % len(self._modules))]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.register_parameter(str(i), p)

    def append(self, parameter):
        self.register_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())


class Identity(Layer):
    def forward(self, x):
        return x
