"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``models/gpt.py``, ``kernels/``, ``ops/``, ``distributed/`` for
one-GPU training, ``serving/`` with the fleet, ``observability/``,
``resilience/``, ``profiler/``, and the eager API: ``core/``, ``nn/``,
``amp/``, ``optimizer/``, ``io/``, ``metric/``, ``hapi/``, ``vision/``) so each
module has an obvious counterpart.  The top level exports the eager
API, so ``import paddle_tpu_torch as paddle`` runs Paddle-style code.  It
imports ``torch`` and numpy only — never ``jax`` and nothing of
``paddle_tpu`` (importing any ``paddle_tpu`` submodule runs that
package's ``__init__``, which imports jax).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own.  On the
CPU every hand-written kernel is replaced by its plain PyTorch version,
chosen only because the tensors it is given lie on the CPU.
"""
from . import amp, io, metric, nn, optimizer, profiler, vision
from ._device import resolve_device
from .core import (get_default_dtype, get_device, get_rng_state, seed,
                   set_default_dtype, set_device, set_rng_state)
from .hapi import Model
from .profiler.timer import Benchmark

__all__ = ["resolve_device", "nn", "optimizer", "amp", "io", "metric",
           "vision", "profiler", "Benchmark", "Model", "set_device", "get_device", "seed",
           "get_rng_state", "set_rng_state", "get_default_dtype",
           "set_default_dtype"]
