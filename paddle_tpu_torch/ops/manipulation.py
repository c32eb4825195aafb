"""Shape and layout ops (the port of ``paddle_tpu/ops/manipulation.py``;
parity: python/paddle/tensor/manipulation.py).  ``split`` and ``chunk``
with a count need an axis the count divides, as ``jnp.split`` does;
``gather``/``index_select`` are ``jnp.take`` (an index tensor of any
rank); the padding modes ``reflect``/``replicate``/``circular`` are
``jnp.pad``'s ``reflect``/``edge``/``wrap`` on any axes."""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dispatch import register_op
from ..core.dtype import convert_dtype

__all__ = [
    "cast", "reshape", "flatten", "transpose", "transpose_last2",
    "moveaxis", "swapaxes", "unsqueeze", "squeeze", "concat", "stack",
    "unstack", "split", "chunk", "tile", "expand", "expand_as",
    "broadcast_to", "flip", "roll", "rot90", "gather", "gather_nd",
    "take_along_axis", "put_along_axis", "scatter", "scatter_nd_add",
    "index_select", "index_sample", "masked_select", "masked_fill", "pad",
    "getitem", "slice", "strided_slice", "repeat_interleave", "unbind",
    "as_real", "as_complex", "one_hot", "unique", "nonzero", "shard_index"]


@register_op("cast")
def cast(x, dtype):
    return x.to(convert_dtype(dtype))


@register_op("reshape")
def reshape(x, shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return torch.reshape(x, tuple(int(s) for s in shape))


@register_op("flatten")
def flatten(x, start_axis=0, stop_axis=-1):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


@register_op("transpose")
def transpose(x, perm):
    return x.permute(tuple(perm))


@register_op("transpose_last2")
def transpose_last2(x):
    if x.dim() < 2:
        return x
    return x.transpose(-1, -2)


@register_op("moveaxis")
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@register_op("swapaxes")
def swapaxes(x, axis0, axis1):
    return torch.swapaxes(x, axis0, axis1)


@register_op("unsqueeze")
def unsqueeze(x, axis):
    if isinstance(axis, (list, tuple)):
        for a in sorted(axis):
            x = torch.unsqueeze(x, a)
        return x
    return torch.unsqueeze(x, axis)


@register_op("squeeze")
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, (list, tuple)):
        axes = tuple(a for a in axis if x.shape[a] == 1)
        return torch.squeeze(x, axes) if axes else x
    if x.shape[axis] != 1:
        return x
    return torch.squeeze(x, axis)


@register_op("concat")
def concat(xs, axis=0):
    return torch.cat(list(xs), dim=axis)


@register_op("stack")
def stack(xs, axis=0):
    return torch.stack(list(xs), dim=axis)


@register_op("unstack")
def unstack(x, axis=0, num=None):
    return tuple(torch.unbind(x, dim=axis))


def _equal_parts(x, n, axis):
    if x.shape[axis] % n:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {x.shape[axis]} into {n}")
    return tuple(torch.tensor_split(x, n, dim=axis))


@register_op("split")
def split(x, num_or_sections, axis=0):
    if isinstance(num_or_sections, int):
        return _equal_parts(x, num_or_sections, axis)
    sections = list(num_or_sections)
    if -1 in sections:          # paddle allows one -1 entry
        known = builtins.sum(s for s in sections if s != -1)
        sections[sections.index(-1)] = x.shape[axis] - known
    return tuple(torch.split(x, sections, dim=axis))


@register_op("chunk")
def chunk(x, chunks, axis=0):
    return _equal_parts(x, chunks, axis)


@register_op("tile")
def tile(x, repeat_times):
    return torch.tile(x, tuple(repeat_times))


@register_op("expand")
def expand(x, shape):
    shape = list(shape)
    x_shape = [1] * (len(shape) - x.dim()) + list(x.shape)
    out = tuple(x_shape[i] if s == -1 else int(s)
                for i, s in enumerate(shape))
    return torch.broadcast_to(x.reshape(x_shape), out)


@register_op("expand_as")
def expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


@register_op("broadcast_to")
def broadcast_to(x, shape):
    return torch.broadcast_to(x, tuple(shape))


@register_op("flip")
def flip(x, axis):
    return torch.flip(x, list(axis) if isinstance(axis, (list, tuple))
                      else [axis])


@register_op("roll")
def roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, dims=axis)


@register_op("rot90")
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


def _take(x, index, axis):
    """``jnp.take(x, index, axis)``: an index tensor of any rank."""
    index = torch.as_tensor(index, device=x.device)
    axis = axis % x.dim()
    out = torch.index_select(x, axis, index.reshape(-1))
    return out.reshape(x.shape[:axis] + index.shape + x.shape[axis + 1:])


@register_op("gather")
def gather(x, index, axis=0):
    return _take(x, index, axis)


@register_op("gather_nd")
def gather_nd(x, index):
    return x[tuple(torch.movedim(index, -1, 0))]


@register_op("take_along_axis")
def take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, indices, dim=axis)


@register_op("put_along_axis")
def put_along_axis(x, indices, values, axis, reduce="assign"):
    values = torch.broadcast_to(
        torch.as_tensor(values, dtype=x.dtype, device=x.device),
        indices.shape)
    if reduce == "assign":
        return torch.scatter(x, axis, indices, values)
    if reduce == "add":
        return torch.scatter_add(x, axis, indices, values)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(x, axis, indices, values, "prod")
    raise ValueError(f"unknown reduce: {reduce}")


@register_op("scatter")
def scatter(x, index, updates, overwrite=True):
    if overwrite:
        return x.index_put((index,), updates)
    return x.index_put((index,), updates, accumulate=True)


@register_op("scatter_nd_add")
def scatter_nd_add(x, index, updates):
    return x.index_put(tuple(torch.movedim(index, -1, 0)), updates,
                       accumulate=True)


@register_op("index_select")
def index_select(x, index, axis=0):
    return _take(x, index, axis)


@register_op("index_sample")
def index_sample(x, index):
    return torch.take_along_dim(x, index, dim=1)


@register_op("masked_select")
def masked_select(x, mask):
    return torch.masked_select(x, mask)


@register_op("masked_fill")
def masked_fill(x, mask, value):
    return torch.where(mask, torch.as_tensor(value, dtype=x.dtype,
                                             device=x.device), x)


def _pad_index(n, lo, hi, mode, device):
    i = np.arange(-lo, n + hi)
    if mode == "replicate":
        i = np.clip(i, 0, n - 1)
    elif mode == "circular":
        i = np.mod(i, n)
    elif mode == "reflect":
        period = 2 * (n - 1)
        i = np.mod(i, period) if period else np.zeros_like(i)
        i = np.where(i > n - 1, period - i, i)
    else:
        raise KeyError(mode)
    return torch.as_tensor(i, device=device)


@register_op("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    pad = [int(p) for p in pad]
    if len(pad) == 2 * x.dim():
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(x.dim())]
    else:
        # paddle convention: pairs for the last len(pad)//2 axes, from the
        # last axis backwards
        cfg = [(0, 0)] * x.dim()
        for i in range(len(pad) // 2):
            cfg[x.dim() - 1 - i] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [p for lo_hi in reversed(cfg) for p in lo_hi]
        return F.pad(x, flat, mode="constant", value=value)
    for dim, (lo, hi) in enumerate(cfg):
        if lo or hi:
            x = torch.index_select(x, dim, _pad_index(
                x.shape[dim], lo, hi, mode, x.device))
    return x


@register_op("getitem")
def getitem(x, idx):
    return x[idx]


@register_op("slice")
def slice(x, axes, starts, ends):  # noqa: A001
    idx = [builtins.slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = builtins.slice(st, en)
    return x[tuple(idx)]


@register_op("strided_slice")
def strided_slice(x, axes, starts, ends, strides):
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        if sd > 0:
            idx = [builtins.slice(None)] * x.dim()
            idx[ax] = builtins.slice(st, en, sd)
            x = x[tuple(idx)]
        else:        # torch slices take no negative step: gather
            rows = range(*builtins.slice(st, en, sd).indices(x.shape[ax]))
            x = torch.index_select(x, ax, torch.as_tensor(
                list(rows), dtype=torch.int64, device=x.device))
    return x


@register_op("repeat_interleave")
def repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@register_op("unbind")
def unbind(x, axis=0):
    return tuple(torch.unbind(x, dim=axis))


@register_op("as_real", differentiable=False)
def as_real(x):
    return torch.view_as_real(x).clone()


@register_op("as_complex", differentiable=False)
def as_complex(x):
    return torch.complex(x[..., 0].contiguous(), x[..., 1].contiguous())


@register_op("one_hot", differentiable=False)
def one_hot(x, num_classes):
    return F.one_hot(x.long(), num_classes).to(torch.float32)


@register_op("unique", differentiable=False)
def unique(x):
    return torch.unique(x, sorted=True)


@register_op("nonzero", differentiable=False)
def nonzero(x):
    return torch.nonzero(x)


@register_op("shard_index", differentiable=False)
def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    hi = (shard_id + 1) * shard_size
    in_shard = (x >= lo) & (x < hi)
    return torch.where(in_shard, x - lo, torch.as_tensor(
        ignore_value, dtype=x.dtype, device=x.device))
