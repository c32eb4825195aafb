"""Custom-op API (the port of ``paddle_tpu/incubate/custom_op.py``; parity:
the reference's PD_BUILD_OP / custom kernel registration —
paddle/phi/api/ext/, fluid/framework/custom_operator.cc).

A custom op is a torch function of tensors (a hand-written kernel can sit
inside it, bound as the port's own kernels are: ``kernels/_build.py``).
Registration hangs it off the port's dispatch
(``core.dispatch.register_op``), so the new op gets what built-ins get:
autocast, the ``check_nan_inf`` and ``benchmark`` flags, and autograd.
With a ``backward`` rule the op is a ``torch.autograd.Function``:
``forward`` returns ``(out, res)`` and ``backward(res, cotangent)``
returns one gradient per input, the JAX package's ``custom_vjp``
convention.
"""
from __future__ import annotations

import torch

from ..core.dispatch import register_op

__all__ = ["custom_op", "CustomOpBuilder"]


def _with_backward(fwd, bwd):
    class _Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            out, res = fwd(*args)
            ctx.res = res
            return out

        @staticmethod
        def backward(ctx, *cts):
            grads = bwd(ctx.res, cts[0] if len(cts) == 1 else cts)
            return tuple(grads)

    def op(*args):
        return _Op.apply(*args)

    op.__name__ = getattr(fwd, "__name__", "custom_op")
    return op


def custom_op(name, forward=None, backward=None, differentiable=True):
    """Register a custom op.

    forward: torch function (tensors in → tensor/tuple out).
    backward: optional gradient rule ``bwd(res, cotangent)`` paired with
      a forward returning ``(out, res)``.  Without it, autograd
      differentiates the forward directly.

    Returns the eager entry point (also reachable via
    ``core.dispatch.get_op(name)``).  Decorator form:
    ``@custom_op("my_op")``."""
    if forward is None:
        return lambda fn: custom_op(name, fn, backward, differentiable)
    fn = forward if backward is None else _with_backward(forward, backward)
    return register_op(name, differentiable=differentiable)(fn)


class CustomOpBuilder:
    """Fluent parity shim for PD_BUILD_OP's builder style::

        (CustomOpBuilder("relu6")
            .set_forward(lambda x: torch.clamp(x, 0, 6))
            .register())
    """

    def __init__(self, name):
        self.name = name
        self._forward = None
        self._backward = None
        self._differentiable = True

    def set_forward(self, fn):
        self._forward = fn
        return self

    def set_backward(self, fn):
        self._backward = fn
        return self

    def set_differentiable(self, flag):
        self._differentiable = flag
        return self

    def register(self):
        if self._forward is None:
            raise ValueError(f"custom op {self.name!r} needs set_forward")
        return custom_op(self.name, self._forward, self._backward,
                         self._differentiable)
