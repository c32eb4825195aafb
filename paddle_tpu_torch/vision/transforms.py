"""Vision transforms (the port of ``paddle_tpu/vision/transforms.py``;
parity: python/paddle/vision/transforms) — numpy-based.

They run on the host, inside DataLoader workers too, so none of them
touches a device.  ``Resize`` computes the JAX package's
``jax.image.resize(..., "bilinear")`` in numpy: a triangle kernel on
half-pixel centres, widened by the scale when downsampling (antialias),
one weight matrix per resized axis, normalised per output sample
(``_weights``), applied as its few nonzero taps (``_taps``) rather than
as a matrix product: a BLAS call would run numpy's BLAS thread pool in
every DataLoader worker at once."""
from __future__ import annotations

import functools

import numpy as np

__all__ = ["Compose", "Normalize", "ToTensor", "Resize", "RandomCrop",
           "RandomHorizontalFlip", "CenterCrop", "Transpose"]


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class Normalize:
    def __init__(self, mean, std, data_format="CHW"):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img, dtype=np.float32)
        if self.data_format == "CHW":
            shape = (-1, 1, 1)
        else:
            shape = (1, 1, -1)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


class ToTensor:
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img, dtype=np.float32)
        if img.ndim == 2:
            img = img[None]
        elif img.ndim == 3 and self.data_format == "CHW" and img.shape[-1] in (1, 3, 4):
            img = np.transpose(img, (2, 0, 1))
        return img


@functools.lru_cache(maxsize=64)
def _weights(n_in, n_out):
    """[n_in, n_out] bilinear resampling weights (JAX's
    ``compute_weight_mat`` with the triangle kernel, antialiased), in
    fp32 as JAX computes them."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _taps(n_in, n_out):
    """``_weights`` as its nonzero taps: ``idx`` and ``w`` [K, n_out],
    column j's K input rows and weights (zero-weight padding where a
    column has fewer), K = 2 upsampling, about 1 + 1/scale downsampling."""
    dense = _weights(n_in, n_out)
    nz = dense != 0
    k = max(int(nz.sum(0).max()), 1)
    first = np.where(nz.any(0), nz.argmax(0), 0)
    idx = np.minimum(first[None, :] + np.arange(k)[:, None], n_in - 1)
    w = np.take_along_axis(dense, idx, 0)
    # a clamped duplicate row at the edge carries no weight twice
    w[1:][idx[1:] == idx[:-1]] = 0.0
    return idx, w.astype(np.float32)


def _resize_axis(img, axis, n_out):
    """Resample one axis: a K-tap weighted sum of gathered rows (no BLAS
    call, so no thread pool: DataLoader workers run it side by side)."""
    if img.shape[axis] == n_out:
        return img
    idx, w = _taps(img.shape[axis], n_out)
    shape = [1] * img.ndim
    shape[axis] = n_out
    out = np.take(img, idx[0], axis=axis) * w[0].reshape(shape)
    for k in range(1, idx.shape[0]):
        out += np.take(img, idx[k], axis=axis) * w[k].reshape(shape)
    return out


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = np.asarray(img, dtype=np.float32)
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        h_axis = 1 if chw else 0
        out = _resize_axis(img, h_axis, self.size[0])
        return np.ascontiguousarray(
            _resize_axis(out, h_axis + 1, self.size[1]))


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = np.asarray(img)
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        h, w = (img.shape[1], img.shape[2]) if chw else (img.shape[0], img.shape[1])
        th, tw = self.size
        i, j = (h - th) // 2, (w - tw) // 2
        return img[:, i:i + th, j:j + tw] if chw else img[i:i + th, j:j + tw]


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        img = np.asarray(img)
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        if self.padding:
            p = self.padding
            cfg = [(0, 0), (p, p), (p, p)] if chw else [(p, p), (p, p)] + [(0, 0)] * (img.ndim - 2)
            img = np.pad(img, cfg)
        h, w = (img.shape[1], img.shape[2]) if chw else (img.shape[0], img.shape[1])
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return img[:, i:i + th, j:j + tw] if chw else img[i:i + th, j:j + tw]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            img = np.asarray(img)
            return img[..., ::-1].copy() if img.ndim == 3 else img[:, ::-1].copy()
        return img


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.transpose(np.asarray(img), self.order)
