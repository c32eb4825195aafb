"""Dtype names (the port of ``paddle_tpu/core/dtype.py``).

Paddle's dtype strings map to torch dtypes; the default dtype is what
``Layer.create_parameter`` makes parameters in."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["float16", "bfloat16", "float32", "float64", "int8", "int16",
           "int32", "int64", "uint8", "bool_", "complex64", "complex128",
           "convert_dtype", "get_default_dtype", "set_default_dtype",
           "is_floating_dtype", "is_integer_dtype", "numpy_dtype"]

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_ALIASES = {
    "float16": float16, "fp16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int": int32,
    "int64": int64, "long": int64, "uint8": uint8, "bool": bool_,
    "complex64": complex64, "complex128": complex128,
}

_default_dtype = [float32]


def convert_dtype(dt):
    """Any dtype spelling (a Paddle string, a numpy dtype, a torch dtype)
    → a torch dtype; ``None`` stays ``None``."""
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str):
        key = dt.lower()
        if key in _ALIASES:
            return _ALIASES[key]
        raise TypeError(f"unknown dtype {dt!r}")
    name = np.dtype(dt).name
    if name not in _ALIASES:
        raise TypeError(f"unknown dtype {dt!r}")
    return _ALIASES[name]


def get_default_dtype():
    return _default_dtype[0]


def set_default_dtype(dt):
    _default_dtype[0] = convert_dtype(dt)


def is_floating_dtype(dt):
    return convert_dtype(dt).is_floating_point


def is_integer_dtype(dt):
    dt = convert_dtype(dt)
    return not (dt.is_floating_point or dt.is_complex or dt == bool_)


def numpy_dtype(dt):
    """The numpy dtype of ``dt``; bfloat16 is ``ml_dtypes.bfloat16``
    (numpy has none), which needs that package."""
    dt = convert_dtype(dt)
    if dt == bfloat16:
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return torch.empty((), dtype=dt).numpy().dtype
