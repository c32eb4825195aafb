"""paddle_tpu_torch.resilience — the fault boundary the serving fleet stands
on (the port of ``paddle_tpu.resilience``'s fault injection and retry):

- :mod:`.faults` — deterministic seed-driven fault injection (named
  sites, off by default, env-gated via ``PADDLE_TPU_FAULTS``); the
  serving engine's ``serving.admit`` / ``serving.step`` sites and the
  autoscaler's ``autoscaler.poll`` / ``autoscaler.scale_up`` sites
  call it.
- :mod:`.retry` — jittered exponential backoff (:func:`retry`,
  :func:`backoff_delays`) and :class:`Deadline`; the router's
  backpressure windows and the autoscaler's spawn budget use it.

- :mod:`.atomic` — tmp + rename file writes (``hapi.Model.save``).

The checkpoint manager, the integrity sentinel and the training
supervisor are later slices.
"""
from __future__ import annotations

from .faults import (  # noqa: F401
    FAULT_KINDS,
    FaultInjector,
    FaultSpec,
    PoisonRequestError,
    SimulatedCrash,
    current_injector,
    fault_point,
    injected_faults,
    install,
    install_from_env,
    uninstall,
)
from .retry import Deadline, RetryError, backoff_delays, retry  # noqa: F401

__all__ = [
    "FAULT_KINDS", "FaultInjector", "FaultSpec", "PoisonRequestError",
    "SimulatedCrash", "fault_point", "install", "uninstall",
    "current_injector", "injected_faults", "install_from_env",
    "Deadline", "RetryError", "backoff_delays", "retry",
]

# env-gated fault injection: inert unless PADDLE_TPU_FAULTS is set
install_from_env()
