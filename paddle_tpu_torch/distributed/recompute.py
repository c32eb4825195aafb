"""Activation checkpointing (the port of
``paddle_tpu/distributed/recompute.py``): the engines' remat policies,
and the eager ``recompute`` a Paddle program wraps its blocks in.

``checkpoint_policy(name)`` gives a block wrapper on non-reentrant
``torch.utils.checkpoint`` for each of JAX's ``jax.checkpoint`` policies:

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

``remat(fn, policy=)`` is that wrapper as a decorator.  The engines'
blocks derive their dropout masks from integer seeds (``models/gpt.py``
``_dropout``: a hash of the seed and the element index), so their
recompute replays them with no RNG state.

``recompute(function, *args, policy=)`` (Paddle's
``fleet.utils.recompute``) runs ``function`` in the forward and again in
the backward's recompute, each run under the random streams
``core.random.segment_streams`` gives it: dropout inside draws the same
masks both times.  Outside a step scope both runs draw under
``key_stream`` of one seed from the active stream (``split_key``), so
the outer stream advances by that one draw whatever the segment draws.
Inside one (a captured step: hapi's ``train_batch``, ``CapturedStep``)
the forward draws from the first member of the next generator pair and
the recompute from the second (each run of a step from the next member,
so a segment nested in another one replays too), all from the state the
step began with, and nothing is drawn on the host after the pair's
first step: the segment runs inside a CUDA graph with fresh masks at
every replay.  The recompute repeats the forward's draws in order (it
may stop after the last tensor the backward needs, leaving later draws
out; the next step starts every member level again).
``torch.utils.checkpoint``'s ``preserve_rng_state`` would save torch's
default generators only, never the port's, so it stays off
(``preserve_rng_state=False``; saving it would also be a host read of
the CUDA generator's state on every block, for nothing).  The recompute
runs on autograd's thread, so the caller's autocast and device (the
port's own thread-local modes) are taken along, and its step scope
(``segment_streams``).  The parameters of a
``Layer`` called inside get their gradients as any closed-over tensor
does in a non-reentrant checkpoint.  ``use_reentrant`` is accepted and
does nothing, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..amp.auto_cast import _state as _amp_state
from ..amp.auto_cast import auto_cast
from ..core import place as _place
from ..core.random import segment_streams

__all__ = ["recompute", "checkpoint_policy", "no_recompute", "remat"]

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
                              preserve_rng_state=False,
                              context_fn=context_fn, **kwargs)

        return rematted

    return wrap


def _amp_modes():
    st = _amp_state
    return (st.enabled, st.dtype, st.level, set(st.custom_white),
            set(st.custom_black))


@contextlib.contextmanager
def _caller_modes(amp, device):
    """Run under the caller's autocast settings (``_amp_modes()``) and
    device."""
    enabled, dtype, level, white, black = amp
    prev = _place._state.device
    _place._state.device = device
    try:
        with auto_cast(enabled, white, black, level, dtype):
            yield
    finally:
        _place._state.device = prev


def recompute(function, *args, policy="full", use_reentrant=True,
              **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward under the named policy; dropout inside replays the same
    masks (module docstring).  ``use_reentrant`` does nothing."""
    streams = segment_streams()
    modes = (_amp_modes(), _place._state.device)

    def segment(*inputs):
        with _caller_modes(*modes), streams():
            return function(*inputs, **kwargs)

    return checkpoint_policy(policy)(segment)(*args)


def no_recompute(fn):
    """Mark ``fn`` as one a recompute policy keeps (``fn._no_recompute``,
    as in the JAX package)."""
    fn._no_recompute = True
    return fn


def remat(fn=None, policy="full", prevent_cse=True):
    """``checkpoint_policy(policy)`` as a decorator, with or without
    arguments.  ``prevent_cse`` is JAX's and does nothing here: eager
    PyTorch merges no common subexpressions."""
    if fn is None:
        return functools.partial(remat, policy=policy,
                                 prevent_cse=prevent_cse)
    return checkpoint_policy(policy)(fn)
