"""``matmul`` (the port of ``paddle_tpu/ops/linalg.py:24-33``).

A half-precision ``x`` multiplies with fp32 accumulation and the result
is cast back to ``x``'s dtype, as in JAX; fp32 operands run true fp32
(PyTorch's default ``torch.backends.cuda.matmul.allow_tf32 = False``; the
JAX package asks for ``Precision.HIGHEST``)."""
from __future__ import annotations

import torch

from ..amp.auto_cast import amp_op

__all__ = ["matmul"]


@amp_op("matmul")
def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    if x.dtype == y.dtype:
        return torch.matmul(x, y)
    ct = torch.promote_types(x.dtype, y.dtype)
    out = torch.matmul(x.to(ct), y.to(ct))
    return out.to(x.dtype) if x.dtype in (torch.bfloat16,
                                          torch.float16) else out
