"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``models/gpt.py``, ``kernels/``, ``ops/``, ``distributed/`` for
one-GPU training, ``serving/``, ``observability/``) so each module has
an obvious counterpart.  It
imports ``torch`` and numpy only — never ``jax`` and nothing of
``paddle_tpu`` (importing any ``paddle_tpu`` submodule runs that
package's ``__init__``, which imports jax).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own.  On the
CPU every hand-written kernel is replaced by its plain PyTorch version,
chosen only because the tensors it is given lie on the CPU.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
