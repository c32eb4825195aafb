"""paddle.save / paddle.load (the port of ``paddle_tpu/framework_io.py``;
parity: python/paddle/framework/io.py:568,784).

Pickles nested state structures with tensors converted to numpy
(protocol 4, the reference's >4GB-safe path): ``Layer.state_dict()``,
``Optimizer.state_dict()`` and arbitrary nested containers.  The file
format is the JAX package's, so files cross in both directions: each
tensor is a ``paddle_tpu.framework_io._TensorPayload`` holding a numpy
``array``.  The port never imports ``paddle_tpu`` (importing it loads
jax): its unpickler maps that class name to its own ``_TensorPayload``,
and its pickler (the pure-Python one, whose ``save_global`` can be
overridden) writes its own class under that name.  A bf16 tensor is an
``ml_dtypes`` bfloat16 array, as the JAX package writes it: saving one
needs ``ml_dtypes``, and raises ``ImportError`` without it.
"""
from __future__ import annotations

import io
import pickle

import numpy as np
import torch

from .core.place import current_device
from .resilience.atomic import atomic_write

__all__ = ["save", "load"]

_JAX_CLASS = ("paddle_tpu.framework_io", "_TensorPayload")


class _TensorPayload:
    def __init__(self, array):
        self.array = array


def _payload(t):
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return _TensorPayload(t.numpy())
    try:
        import ml_dtypes
    except ImportError as e:
        raise ImportError(
            "paddle.save of a bfloat16 tensor needs ml_dtypes: the file "
            "holds it as an ml_dtypes.bfloat16 array, as the JAX package "
            "writes it") from e
    bits = t.contiguous().view(torch.int16).numpy()
    return _TensorPayload(bits.view(ml_dtypes.bfloat16))


def _tensor(payload, device):
    a = payload.array
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _map(obj, fn, kind):
    if isinstance(obj, kind):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(v, fn, kind) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(v, fn, kind) for v in obj)
    return obj


class _Pickler(pickle._Pickler):
    """Writes the port's ``_TensorPayload`` as the JAX package's class."""

    def save_global(self, obj, name=None):
        if obj is not _TensorPayload:
            return super().save_global(obj, name)
        module, qualname = _JAX_CLASS
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode())
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in (_JAX_CLASS, (__name__, "_TensorPayload")):
            return _TensorPayload
        if module.split(".")[0] == "paddle_tpu":
            raise pickle.UnpicklingError(
                f"{module}.{name}: the port maps only the JAX package's "
                f"_TensorPayload (importing paddle_tpu would load jax)")
        return super().find_class(module, name)


def save(obj, path, protocol=4):
    """Atomic: bytes land in a same-directory tmp file and ``os.replace``
    publishes them, so a crash mid-dump never corrupts an existing
    checkpoint at ``path``."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=protocol).dump(
        _map(obj, _payload, torch.Tensor))
    with atomic_write(path, "wb", site="framework_io.save") as f:
        f.write(buf.getbuffer())


def load(path, return_numpy=False, device=None):
    """The saved tree with its tensors on ``device`` (default: that of
    ``set_device``), or as numpy arrays with ``return_numpy``."""
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    if return_numpy:
        return _map(obj, lambda p: p.array, _TensorPayload)
    dev = current_device() if device is None else torch.device(device)
    return _map(obj, lambda p: _tensor(p, dev), _TensorPayload)
