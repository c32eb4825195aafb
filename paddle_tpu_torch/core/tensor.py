"""The eager Tensor (the port of ``paddle_tpu/core/tensor.py``).

The port's tensors are torch tensors: ``Tensor`` *is* ``torch.Tensor``
(every ported layer, the captured CUDA graphs and the kernels take and
return them; ``autograd/__init__.py``).  ``stop_gradient`` is
``not requires_grad``.  ``Parameter`` is the trainable leaf that
``Layer.create_parameter`` makes.

``to_tensor`` follows the JAX package's rules (its ``_to_jax``): a
float64 numpy array without a ``dtype`` becomes float32, a Python float
takes the default dtype (``set_default_dtype``), everything else keeps
what torch infers (Python ints are int64 — the JAX package's int32 there
is JAX's 32-bit mode, not a rule of the package).  It always copies, and
places the tensor on ``place`` or the current device (``set_device``;
the card unless ``set_device("cpu")``, raising without CUDA).

Paddle's Tensor methods: a name ``torch.Tensor`` already has stays
torch's, whatever Paddle means by it (``split``, ``transpose``, ``sort``,
``max``, ``gather``, ``scatter``, ``where``, ``size``…; Paddle's meaning
is the function of the same name, ``paddle.split(x, …)``); a name torch
lacks is added from ``_PADDLE_ONLY`` by ``patch_tensor_methods``, and
never over an attribute torch defines.
"""
from __future__ import annotations

import numpy as np
import torch

from .dtype import convert_dtype, get_default_dtype
from .place import Place, current_device

__all__ = ["Tensor", "Parameter", "to_tensor", "is_tensor",
           "patch_tensor_methods"]

Tensor = torch.Tensor


class Parameter(torch.nn.Parameter):
    """A trainable tensor with Paddle's attributes: ``name`` (the key of
    its optimizer state; ``None`` gives ``param_{i}``), ``optimize_attr``
    (its learning-rate multiplier), ``trainable``, ``regularizer`` and
    ``persistable`` (True; a tensor's is False)."""

    name = None
    persistable = True
    regularizer = None        # a ParamAttr's, from create_parameter
    trainable = True
    optimize_attr = None      # each parameter's own dict

    def __new__(cls, data, requires_grad=True, trainable=None, name=None):
        if trainable is not None:
            requires_grad = trainable
        p = super().__new__(cls, data, requires_grad)
        p.optimize_attr = {"learning_rate": 1.0}
        p.trainable = requires_grad
        if name is not None:
            p.name = name
        return p

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        out.optimize_attr = dict(self.optimize_attr)
        out.trainable, out.name = self.trainable, self.name
        out.regularizer = self.regularizer
        memo[id(self)] = out
        return out


def _device_of(place):
    if place is None:
        return current_device()
    if isinstance(place, Place):
        return place.torch_device()
    if isinstance(place, str):
        kind, _, idx = place.lower().strip().partition(":")
        kind = "gpu" if kind in ("gpu", "cuda") else kind
        return Place(kind, int(idx or 0)).torch_device()
    from .._device import resolve_device

    return resolve_device(place)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a new tensor (a copy) of ``data`` on ``place``
    (default: the current device), ``requires_grad = not stop_gradient``
    (floating and complex dtypes only: an integer tensor has no
    gradient)."""
    device = _device_of(place)
    dt = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach()
    else:
        if isinstance(data, np.ndarray) and data.dtype == np.float64 and \
                dt is None:
            data = data.astype(np.float32)
        if isinstance(data, float) and dt is None:
            dt = get_default_dtype()
        if isinstance(data, np.ndarray):
            t = torch.from_numpy(np.array(data, copy=True))
        else:
            t = torch.as_tensor(data)
    t = t.to(device=device, dtype=dt, copy=True)
    if not stop_gradient and (t.is_floating_point() or t.is_complex()):
        t.requires_grad_(True)
    return t


def tensor_ctor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.tensor(...)``: ``to_tensor`` under its numpy-style name
    (the JAX ``ops/creation.py:120``)."""
    return to_tensor(data, dtype=dtype, place=place,
                     stop_gradient=stop_gradient)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


# ---------------------------------------------------- Paddle-only methods


def _stop_gradient(self):
    return not self.requires_grad


def _set_stop_gradient(self, value):
    self.requires_grad_(not value)


def _place(self):
    if self.device.type == "cuda":
        return Place("gpu", self.device.index or 0)
    return Place(self.device.type, self.device.index or 0)


def _clear_grad(self, set_to_zero=False):
    if set_to_zero and self.grad is not None:
        self.grad.zero_()
    else:
        self.grad = None


def _astype(self, dtype):
    return self.to(convert_dtype(dtype))


def _set_value(self, value):
    """In-place value replacement (keeps the tensor's identity)."""
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.asarray(value))
    if tuple(value.shape) != tuple(self.shape):
        raise ValueError(f"set_value shape mismatch: {tuple(value.shape)} "
                         f"vs {tuple(self.shape)}")
    with torch.no_grad():
        self.copy_(value)


def _gradient(self):
    return None if self.grad is None else self.grad.detach().cpu().numpy()


def _retain_grads(self):
    """Keep this (non-leaf) tensor's ``.grad`` after backward."""
    self.retain_grad()


def _persistable(self):
    return self.__dict__.get("_persistable", False)


def _set_persistable(self, value):
    self.__dict__["_persistable"] = bool(value)


#: attributes Paddle's Tensor has and torch.Tensor lacks: name -> the
#: attribute itself, or the name of the op in ``paddle_tpu_torch.ops``
_PADDLE_ONLY = {
    "stop_gradient": property(_stop_gradient, _set_stop_gradient),
    "place": property(_place),
    "clear_grad": _clear_grad,
    "clear_gradient": _clear_grad,
    "astype": _astype,
    "set_value": _set_value,
    "gradient": _gradient,
    "retain_grads": _retain_grads,
    "persistable": property(_persistable, _set_persistable),
    "cast": "cast",
    "concat": "concat",
    "equal_all": "equal_all",
    "gather_nd": "gather_nd",
    "greater_than": "greater_than",
    "less_than": "less_than",
    "scale": "scale",
    "stack": "stack",
    "unstack": "unstack",
}

_ADDED = []        # names this process added to torch.Tensor


def patch_tensor_methods(ops):
    """Add ``_PADDLE_ONLY`` to ``torch.Tensor``, each name only where
    torch has no attribute of that name; returns the names added."""
    for name, attr in _PADDLE_ONLY.items():
        if name in _ADDED or hasattr(torch.Tensor, name):
            continue
        setattr(torch.Tensor, name,
                getattr(ops, attr) if isinstance(attr, str) else attr)
        _ADDED.append(name)
    return list(_ADDED)

