"""Sequence ops (the port of ``paddle_tpu/ops/sequence.py``; reference:
paddle/fluid/operators/sequence_ops/).

The JAX package's contract, kept: padded dense ``[B, T, ...]`` plus
``lengths [B]`` instead of LoD (ragged) tensors; ops mask instead of
slicing rows.  ``sequence_pad``/``sequence_unpad`` convert between the
reference's flat concatenated rows and the padded layout (host-side
lengths), and ``sequence_expand`` repeats rows."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import register_op
from ..core.dtype import convert_dtype

__all__ = ["sequence_mask", "sequence_pad", "sequence_unpad",
           "sequence_softmax", "sequence_reverse", "sequence_expand",
           "sequence_pool"]


def _lengths(lengths, device):
    return torch.as_tensor(lengths, device=device).to(torch.int64)


@register_op("sequence_mask")
def sequence_mask(lengths, maxlen=None, dtype="bool"):
    """[B] lengths -> [B, maxlen] validity mask."""
    dev = lengths.device if isinstance(lengths, torch.Tensor) else None
    ln = _lengths(lengths, dev)
    m = int(maxlen) if maxlen is not None else int(ln.max())
    mask = torch.arange(m, device=ln.device)[None, :] < ln[:, None]
    return mask.to(convert_dtype(dtype))


def sequence_pad(x, lengths, maxlen=None, pad_value=0.0):
    """Flat rows [sum(lengths), ...] -> padded [B, maxlen, ...]."""
    ln = np.asarray(lengths, np.int64)
    m = int(maxlen) if maxlen is not None else int(ln.max())
    offs = np.concatenate([[0], np.cumsum(ln)[:-1]])
    idx = offs[:, None] + np.minimum(np.arange(m)[None, :], ln[:, None] - 1)
    out = x[torch.as_tensor(idx, device=x.device)]
    mask = torch.as_tensor(np.arange(m)[None, :] < ln[:, None],
                           device=x.device)
    mask = mask.reshape(mask.shape + (1,) * (out.dim() - 2))
    return torch.where(mask, out, torch.as_tensor(pad_value, dtype=out.dtype,
                                                  device=x.device))


def sequence_unpad(x, lengths):
    """Padded [B, T, ...] -> flat rows [sum(lengths), ...]."""
    ln = np.asarray(lengths, np.int64)
    return torch.cat([x[b, :ln[b]] for b in range(len(ln))], dim=0)


@register_op("sequence_softmax")
def sequence_softmax(x, lengths=None):
    """Softmax over each row's valid prefix; padding gets 0."""
    if lengths is None:
        return torch.softmax(x, dim=-1)
    ln = _lengths(lengths, x.device)
    mask = torch.arange(x.shape[1], device=x.device)[None, :] < ln[:, None]
    p = torch.softmax(torch.where(mask, x, float("-inf")), dim=1)
    return torch.where(mask, p, 0.0)


@register_op("sequence_reverse")
def sequence_reverse(x, lengths=None):
    """Reverse each row's valid prefix, padding in place."""
    if lengths is None:
        return torch.flip(x, [1])
    ln = _lengths(lengths, x.device)
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    src = torch.where(t < ln[:, None], ln[:, None] - 1 - t, t)
    src = src.reshape(src.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return torch.gather(x, 1, src)


def sequence_expand(x, repeats, maxlen=None):
    """Repeat row b of x [B, ...] repeats[b] times (``maxlen``: the total,
    sum(repeats), when known)."""
    r = torch.as_tensor(repeats, device=x.device)
    return torch.repeat_interleave(x, r, dim=0, output_size=maxlen)


@register_op("sequence_pool")
def sequence_pool(x, pool_type="sum", lengths=None):
    """Masked pooling over the time axis: SUM/AVERAGE/SQRT/MAX/FIRST/LAST
    over each row."""
    B, T = x.shape[0], x.shape[1]
    ln = (torch.full((B,), T, dtype=torch.int64, device=x.device)
          if lengths is None else _lengths(lengths, x.device))
    mask = torch.arange(T, device=x.device)[None, :] < ln[:, None]
    shape = mask.shape + (1,) * (x.dim() - 2)
    mf = mask.reshape(shape).to(x.dtype)
    lnf = ln.reshape((B,) + (1,) * (x.dim() - 2)).to(x.dtype)
    kind = pool_type.lower()
    if kind == "sum":
        return (x * mf).sum(1)
    if kind in ("average", "mean", "avg"):
        return (x * mf).sum(1) / torch.clamp_min(lnf, 1)
    if kind == "sqrt":
        return (x * mf).sum(1) / torch.sqrt(torch.clamp_min(lnf, 1))
    if kind == "max":
        low = (torch.finfo(x.dtype).min if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        return torch.where(mask.reshape(shape), x, low).amax(1)
    if kind == "first":
        return x[:, 0]
    if kind == "last":
        idx = torch.clamp_min(ln - 1, 0).reshape((B, 1) + (1,) *
                                                 (x.dim() - 2))
        return torch.gather(x, 1, idx.expand((B, 1) + x.shape[2:]))[:, 0]
    raise ValueError(f"sequence_pool: unknown pool_type {pool_type!r}")
