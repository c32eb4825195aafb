"""The controls: the reference computed one precision below the one the
configurations state.  They state bfloat16, so a control's products
take int8 or float8 operands and accumulate in float32.  The rounding
of the operands passes gradients unchanged (a straight-through
estimator), so a product's backward reads the same rounded operands as
its forward, beside the gradient that reaches the product, rounded too.

- ``fp8``: FP8 training as Hopper runs it (the "hybrid" recipe): the
  operands in e4m3, the gradient in e5m2, each tensor scaled as a whole
  so that its largest magnitude maps to the format's largest.
- ``int8_rows``: symmetric int8 (the largest magnitude maps to 127)
  scaled along the contracted axis: a row of the left operand, a column
  of the right, a row of the gradient.

A workload file's ``control`` names the one its limits were set from.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _fp8(t, dtype, top):
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).float() * scale


def _int8(t, dim):
    amax = t.abs().amax(dim, keepdim=True)
    scale = amax.clamp(min=1e-30) / 127.0
    return (t / scale).round().clamp(-127, 127) * scale


def _straight(t, rounding):
    """``t`` rounded by ``rounding``, its gradient passed unchanged."""
    return t + (rounding(t.detach()) - t.detach())


def _grad_rounded(rounding):
    class Round(torch.autograd.Function):
        """The identity forward; its backward rounds the gradient."""

        @staticmethod
        def forward(ctx, y):
            return y.view_as(y)

        @staticmethod
        def backward(ctx, g):
            return rounding(g)

    return Round.apply


_E5M2 = _grad_rounded(lambda g: _fp8(g, torch.float8_e5m2, E5M2_MAX))
_INT8_ROWS = _grad_rounded(lambda g: _int8(g, -1))


def e4m3(t):
    return _straight(t, lambda x: _fp8(x, torch.float8_e4m3fn, E4M3_MAX))


def fp8(a, b):
    return _E5M2(e4m3(a) @ e4m3(b))


def int8_rows(a, b):
    return _INT8_ROWS(_straight(a, lambda x: _int8(x, -1))
                      @ _straight(b, lambda x: _int8(x, -2)))


CONTROLS = {"fp8": fp8, "int8_rows": int8_rows}
