"""Global flag registry (the port of ``paddle_tpu/core/flags.py``).

Flags are defined in one place, can be overridden by ``FLAGS_<name>``
environment variables at import, and are read and written at run time by
``get_flags``/``set_flags`` (the reference's gflags,
paddle/fluid/platform/flags.cc).  The table is the JAX package's.  What
each does in the port:

- ``check_nan_inf``: every op of the registry (``core/dispatch.py``)
  scans its floating outputs and raises ``FloatingPointError`` naming the
  op and output (one host read an op: debug only).
- ``benchmark``: every op synchronises its device after it runs and adds
  its wall time to ``dispatch.op_times()``.
- ``fraction_of_device_memory_to_use``: ``torch.cuda.
  set_per_process_memory_fraction`` on the current card (0 = no cap).
- ``allocator_strategy``: the caching allocator's settings,
  ``PYTORCH_CUDA_ALLOC_CONF``: ``auto_growth`` = ``expandable_segments:
  True`` (segments grow as needed), ``naive_best_fit`` = PyTorch's
  default fixed segments.  Read by PyTorch when CUDA first allocates, so
  set it before (the reference asks the same of its allocator flags).
- ``eager_op_jit``, ``use_bf16_matmul``, ``seed``, ``log_level``,
  ``tpu_interpret_pallas``: accepted and kept, with no effect on the card
  (there is no per-op jit to cache, matmul precision follows the operand
  dtype — ``ops/linalg.py`` — the seed is ``paddle.seed``'s, and there is
  no Pallas interpreter).

Only a flag that was set explicitly (``set_flags`` or ``FLAGS_*``)
touches the allocator: a default never overrides the user's own
``PYTORCH_CUDA_ALLOC_CONF``.
"""
from __future__ import annotations

import logging
import os
import threading

__all__ = ["define_flag", "get_flags", "set_flags", "flag",
           "apply_allocator_flags"]

logger = logging.getLogger("paddle_tpu_torch.core")

_lock = threading.Lock()
_registry: dict[str, dict] = {}     # guarded-by: _lock


def _coerce(value, proto):
    if isinstance(proto, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(proto, int):
        return int(value)
    if isinstance(proto, float):
        return float(value)
    return value


def define_flag(name: str, default, help_str: str = ""):
    """Register a flag; env var ``FLAGS_<name>`` overrides the default."""
    with _lock:
        env = os.environ.get(f"FLAGS_{name}")
        value = _coerce(env, default) if env is not None else default
        _registry[name] = {"value": value, "default": default,
                           "help": help_str,
                           "explicit": env is not None}
    return value


def flag(name: str):
    """Read a flag's current value (one dict lookup: the op hot path)."""
    # lint-ok: lock-discipline the op hot path: one GIL-atomic dict
    # lookup of an entry define_flag / set_flags replace whole
    return _registry[name]["value"]


def get_flags(names=None):
    with _lock:
        if names is None:
            names = list(_registry)
        if isinstance(names, str):
            names = [names]
        return {n: _registry[n]["value"] for n in names}


_ALLOCATOR_FLAGS = ("fraction_of_device_memory_to_use", "allocator_strategy")


def set_flags(mapping: dict):
    touched = False
    with _lock:
        for name, value in mapping.items():
            if name.startswith("FLAGS_"):
                name = name[len("FLAGS_"):]
            if name not in _registry:
                raise KeyError(f"unknown flag: {name}")
            _registry[name]["value"] = _coerce(value,
                                               _registry[name]["default"])
            _registry[name]["explicit"] = True
            touched |= name in _ALLOCATOR_FLAGS
    if touched:
        apply_allocator_flags()


define_flag("check_nan_inf", False, "scan op outputs for NaN/Inf (debug)")
define_flag("benchmark", False, "synchronize and time each op")
define_flag("eager_op_jit", False, "jit-cache eager per-op execution "
            "(no effect in the port: ops run eagerly)")
define_flag("use_bf16_matmul", True, "prefer bf16 inputs on MXU matmuls "
            "(no effect in the port: precision follows the dtypes)")
define_flag("seed", 0, "global random seed (0 = nondeterministic)")
define_flag("tpu_interpret_pallas", False, "run pallas kernels in "
            "interpret mode (no effect in the port: no Pallas)")
define_flag("log_level", 0, "framework VLOG-style verbosity")
define_flag("fraction_of_device_memory_to_use", 0.0,
            "0 = no cap; else torch.cuda.set_per_process_memory_fraction")
define_flag("allocator_strategy", "auto_growth",
            "'auto_growth' (expandable segments) or 'naive_best_fit' "
            "(PyTorch's default segments)")

_STRATEGY = {"auto_growth": "expandable_segments:True",
             "naive_best_fit": "expandable_segments:False"}


def apply_allocator_flags():
    """Push the explicitly set allocator flags into PyTorch's CUDA
    allocator: the memory fraction now (when CUDA is there), the
    strategy into ``PYTORCH_CUDA_ALLOC_CONF`` (read at CUDA's first
    allocation; set after it, the strategy is kept and logged as not
    applied)."""
    import torch

    with _lock:
        frac_explicit = _registry["fraction_of_device_memory_to_use"][
            "explicit"]
        strategy_explicit = _registry["allocator_strategy"]["explicit"]
    if strategy_explicit:
        strategy = flag("allocator_strategy")
        if strategy not in _STRATEGY:
            raise ValueError(f"unknown allocator_strategy {strategy!r}")
        if torch.cuda.is_initialized():
            logger.warning("allocator_strategy=%s set after CUDA's first "
                           "use: it applies to new processes only",
                           strategy)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = _STRATEGY[strategy]
    if frac_explicit and torch.cuda.is_available():
        frac = flag("fraction_of_device_memory_to_use")
        torch.cuda.set_per_process_memory_fraction(
            frac if frac and frac > 0 else 1.0)


apply_allocator_flags()
