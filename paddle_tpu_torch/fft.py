"""FFT API (the port of ``paddle_tpu/fft.py``; parity: python/paddle/fft.py
— fft/ifft/rfft/irfft families, fftn variants, fftshift helpers,
fftfreq).

Thin over ``torch.fft`` on the device of the input, as the JAX package is
thin over ``jnp.fft``: only the norm/axis argument surface to match.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.dtype import convert_dtype
from .core.place import current_device

__all__ = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
           "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
           "hfft", "ihfft", "fftfreq", "rfftfreq", "fftshift", "ifftshift"]


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _norm(norm):
    # paddle uses 'backward'|'ortho'|'forward' like numpy>=1.20
    return norm or "backward"


def _make1(name):
    fn = getattr(torch.fft, name)

    def op(x, n=None, axis=-1, norm=None, name_=None):
        return fn(_t(x), n=n, dim=axis, norm=_norm(norm))

    op.__name__ = name
    return op


def _make2(name):
    fn = getattr(torch.fft, name)

    def op(x, s=None, axes=(-2, -1), norm=None, name_=None):
        return fn(_t(x), s=s, dim=axes, norm=_norm(norm))

    op.__name__ = name
    return op


def _maken(name):
    fn = getattr(torch.fft, name)

    def op(x, s=None, axes=None, norm=None, name_=None):
        return fn(_t(x), s=s, dim=axes, norm=_norm(norm))

    op.__name__ = name
    return op


fft = _make1("fft")
ifft = _make1("ifft")
rfft = _make1("rfft")
irfft = _make1("irfft")
hfft = _make1("hfft")
ihfft = _make1("ihfft")
fft2 = _make2("fft2")
ifft2 = _make2("ifft2")
rfft2 = _make2("rfft2")
irfft2 = _make2("irfft2")
fftn = _maken("fftn")
ifftn = _maken("ifftn")
rfftn = _maken("rfftn")
irfftn = _maken("irfftn")


def fftfreq(n, d=1.0, dtype=None, name=None, device=None):
    """Sample frequencies, on ``device`` (default: that of
    ``set_device``)."""
    return torch.fft.fftfreq(
        n, d=d, dtype=convert_dtype(dtype) or torch.float32,
        device=device or current_device())


def rfftfreq(n, d=1.0, dtype=None, name=None, device=None):
    return torch.fft.rfftfreq(
        n, d=d, dtype=convert_dtype(dtype) or torch.float32,
        device=device or current_device())


def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(_t(x), dim=axes)


def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(_t(x), dim=axes)
