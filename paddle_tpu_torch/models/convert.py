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

__all__ = ["params_from_jax", "params_to_numpy", "opt_from_jax",
           "layer_state_from_jax", "opt_state_from_jax"]

#: leaves the JAX ``gpt_init`` makes fp32 in every model dtype (the MoE
#: gate: routing decisions are precision-sensitive)
FP32_LEAVES = frozenset({"gate_w"})


def _to_numpy(leaf):
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)          # bfloat16 (ml_dtypes) leaves
    return arr


def params_from_jax(tree, device=None, dtype=None):
    """JAX ``gpt_init``-style tree → the port's nested dict of tensors on
    ``device`` (default CUDA).  Float leaves are cast to ``dtype`` when it
    is given, else kept at fp32 (the numpy carrier's precision); the
    leaves named in ``FP32_LEAVES`` stay fp32, as JAX keeps them."""
    return _convert(tree, device, dtype, FP32_LEAVES)


def _convert(tree, device, dtype, keep_fp32=frozenset()):
    dev = resolve_device(device)

    def conv(node, name=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        arr = _to_numpy(node)
        t = torch.from_numpy(np.array(arr, copy=True, order="C"))
        if t.is_floating_point() and dtype is not None \
                and name not in keep_fp32:
            t = t.to(dtype)
        return t.to(dev)

    return conv(tree)


def opt_from_jax(canon, device=None, dtype=None):
    """The JAX engine's canonical optimizer state (``opt_canonical``:
    ``{"m", "v", "master"}`` trees of param-shaped arrays) → the same
    three trees of tensors, every float leaf cast to ``dtype`` when it is
    given (the slots are kept in one dtype);
    ``HybridEngine.opt_from_canonical`` turns them into a state."""
    return {name: _convert(canon[name], device, dtype)
            for name in ("m", "v", "master")}


def params_to_numpy(params):
    """Inverse of ``params_from_jax``: the port's tree → nested dict of
    numpy arrays (bf16 tensors come back as fp32)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def layer_state_from_jax(state, device=None):
    """A JAX ``Layer.state_dict()`` (values as numpy, or anything
    ``np.asarray`` takes) → ``{name: tensor}`` on ``device`` (default
    CUDA), names unchanged; ``Layer.set_state_dict`` takes it."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(_to_numpy(v), copy=True)).to(dev)
            for k, v in state.items()}


def opt_state_from_jax(tree, device=None, templates=None):
    """hapi's optimizer state tree (``Model._opt_state``: ``{"step",
    "slots": {name: {slot: array}}}``) → the port's ``train_batch`` state
    on ``device``.  ``templates`` (``{name: {slot: tensor}}``, e.g. from
    ``optimizer.init_state``) gives each slot its dtype; without it the
    slots stay fp32 (the numpy carrier's precision)."""
    dev = resolve_device(device)
    slots = {}
    for name, s in tree["slots"].items():
        tmpl = (templates or {}).get(name, {})
        slots[name] = {}
        for n, v in s.items():
            t = torch.from_numpy(np.array(_to_numpy(v), copy=True)).to(dev)
            if n in tmpl:
                t = t.to(tmpl[n].dtype)
            slots[name][n] = t
    return {"step": int(np.asarray(tree["step"])), "slots": slots}
