"""Carry parameters between the JAX package's pytrees and the port.

Weights cross through numpy: a JAX tree is handed over as arrays that
``np.asarray`` accepts (jax arrays included), bf16 leaves travel as
fp32 because numpy has no bf16 of its own, and the port's tree is a
nested dict of tensors with the same keys.  Nothing here imports jax.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["params_from_jax", "params_to_numpy"]


def _to_numpy(leaf):
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)          # bfloat16 (ml_dtypes) leaves
    return arr


def params_from_jax(tree, device=None, dtype=None):
    """JAX ``gpt_init``-style tree → the port's nested dict of tensors on
    ``device`` (default CUDA).  Float leaves are cast to ``dtype`` when it
    is given, else kept at fp32 (the numpy carrier's precision)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        arr = _to_numpy(node)
        t = torch.from_numpy(np.array(arr, copy=True, order="C"))
        if t.is_floating_point() and dtype is not None:
            t = t.to(dtype)
        return t.to(dev)

    return conv(tree)


def params_to_numpy(params):
    """Inverse of ``params_from_jax``: the port's tree → nested dict of
    numpy arrays (bf16 tensors come back as fp32)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
