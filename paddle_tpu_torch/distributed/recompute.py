"""Activation checkpointing policies (the port of
``paddle_tpu/distributed/recompute.py::checkpoint_policy``).

JAX names a ``jax.checkpoint`` policy; here each name gives a block
wrapper on non-reentrant ``torch.utils.checkpoint``:

- ``"full"``: save the block's inputs only, recompute everything;
- ``"dots"``: selective checkpointing that saves the outputs of matrix
  products (``aten.mm``, ``aten.addmm``, ``aten.bmm``) and recomputes
  the rest — LayerNorms, GELU, the flash-attention forward — as JAX's
  ``checkpoint_dots`` does.  The flash kernel is a ctypes call inside an
  ``autograd.Function``, invisible to the dispatcher, so its forward is
  re-run in backward with its outputs allocated anew;
- ``"dots_no_batch"``: as ``"dots"`` but not ``bmm``
  (``checkpoint_dots_with_no_batch_dims``);
- ``"nothing"``: no checkpoint; every activation is kept.

Dropout masks stay identical across the recompute because the port
derives them from integer seeds inside the block, not from RNG state.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

__all__ = ["checkpoint_policy"]

_aten = torch.ops.aten
_SAVED_OPS = {
    "dots": (_aten.mm, _aten.addmm, _aten.bmm),
    "dots_no_batch": (_aten.mm, _aten.addmm),
}
POLICIES = ("full", "dots", "dots_no_batch", "nothing")


def _save_ops(ops):
    def policy(ctx, op, *args, **kwargs):
        if op.overloadpacket in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def checkpoint_policy(name: str):
    """A wrapper ``wrap(fn) -> fn'`` that runs ``fn`` under the named
    remat policy (see module docstring)."""
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; expected one of "
                         f"{POLICIES}")
    if name == "nothing":
        return lambda fn: fn
    context_fn = (_save_ops(_SAVED_OPS[name]) if name in _SAVED_OPS
                  else noop_context_fn)

    def wrap(fn):
        @functools.wraps(fn)
        def rematted(*args, **kwargs):
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=context_fn, **kwargs)

        return rematted

    return wrap
