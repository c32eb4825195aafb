"""Op registry and eager dispatch (the port of
``paddle_tpu/core/dispatch.py``).

One registration point per op.  An op is an eager function on torch
tensors; ``register_op(name)`` records it in ``OP_REGISTRY`` and returns
its public wrapper, which

- applies the port's autocast on entry (``amp.auto_cast``: under
  ``auto_cast`` the positional float tensors of a white-listed op are
  cast to the AMP dtype, those of a black-listed op back to fp32);
- with the ``check_nan_inf`` flag, scans the floating outputs and raises
  ``FloatingPointError`` naming the op and the output (JAX
  ``dispatch.py:139-160``);
- with the ``benchmark`` flag, synchronises the outputs' device and adds
  the op's wall time to :func:`op_times`.

torch's autograd takes the place of the JAX package's ``jax.vjp`` tape,
so there is no tape node: an op's gradient is whatever autograd records
while it runs.  ``OpDef.differentiable`` says whether the op has one
(the conformance tests read it).  ``list_ops()`` is the port's whole
corpus: ``ops/`` and ``contrib/quant.py`` register through here.
"""
from __future__ import annotations

import functools
import time

import torch

from .flags import flag

__all__ = ["register_op", "get_op", "list_ops", "OP_REGISTRY", "OpDef",
           "op_times"]

OP_REGISTRY: dict[str, "OpDef"] = {}
_TIMES: dict[str, list] = {}   # benchmark flag: name -> [calls, seconds]


class OpDef:
    __slots__ = ("name", "fn", "eager_fn", "differentiable")

    def __init__(self, name, fn, eager_fn, differentiable):
        self.name = name
        self.fn = fn
        self.eager_fn = eager_fn
        self.differentiable = differentiable

    def __repr__(self):
        return f"OpDef({self.name})"


def register_op(name=None, differentiable=True):
    """Register an eager torch function as the op ``name`` (its own
    name by default); returns the public wrapper.  The unwrapped
    function stays reachable as ``get_op(name).fn``."""

    def deco(fn):
        op_name = name or fn.__name__

        @functools.wraps(fn)
        def eager(*args, **kwargs):
            if _amp.enabled:
                args = _cast_args(op_name, args)
            if not (flag("check_nan_inf") or flag("benchmark")):
                return fn(*args, **kwargs)
            return _checked(op_name, fn, args, kwargs)

        OP_REGISTRY[op_name] = OpDef(op_name, fn, eager, differentiable)
        eager.op_name = op_name
        return eager

    return deco


def get_op(name: str) -> OpDef:
    return OP_REGISTRY[name]


def list_ops():
    return sorted(OP_REGISTRY)


def op_times():
    """``{op: (calls, seconds)}`` timed while the ``benchmark`` flag was
    on (each call synchronised its device)."""
    return {k: tuple(v) for k, v in _TIMES.items()}


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def _checked(op_name, fn, args, kwargs):
    bench = flag("benchmark")
    t0 = time.perf_counter() if bench else 0.0
    out = fn(*args, **kwargs)
    outs = _tensors(out)
    if bench:
        for dev in {t.device for t in outs if t.is_cuda}:
            torch.cuda.synchronize(dev)
        rec = _TIMES.setdefault(op_name, [0, 0.0])
        rec[0] += 1
        rec[1] += time.perf_counter() - t0
    if flag("check_nan_inf"):
        _check_nan_inf(op_name, outs)
    return out


def _check_nan_inf(op_name, arrays):
    """FLAGS_check_nan_inf parity (nan_inf_utils_detail.cc:570)."""
    for i, a in enumerate(arrays):
        if (a.is_floating_point() or a.is_complex()) and \
                not bool(torch.isfinite(a).all()):
            raise FloatingPointError(
                f"NaN/Inf detected in output {i} of op '{op_name}'")


from ..amp.auto_cast import _cast_args, _state as _amp  # noqa: E402
