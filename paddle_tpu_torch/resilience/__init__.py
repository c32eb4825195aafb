"""paddle_tpu_torch.resilience — correctness under failure (the port of
``paddle_tpu.resilience``):

- :mod:`.atomic` — the tmp + rename write every durable file commits
  through, with a running CRC32 and a fault site;
- :mod:`.checkpoint_manager` — :class:`CheckpointManager`: atomic commit,
  per-shard CRC32, ``latest()`` that skips torn or corrupt checkpoints,
  fallback restore, ``keep_last_n``, audit-on-save, ``discard_after`` and
  async save through reused pinned host buffers;
- :mod:`.faults` — deterministic seed-driven fault injection (named
  sites, off by default, env-gated via ``PADDLE_TPU_FAULTS``);
- :mod:`.retry` — jittered exponential backoff and :class:`Deadline`;
- :mod:`.integrity` — the silent-corruption sentinel
  (:func:`tree_fingerprint`, cross-rank compares over the ``TCPStore``,
  sampled step replay, the rewind-and-replay repair;
  :class:`IntegrityCallback`, exported lazily to keep the layers
  acyclic);
- :mod:`.supervisor` — :class:`TrainingSupervisor`: runs the trainer as
  a watched child and relaunches it with backoff, resuming from the
  newest intact checkpoint.
"""
from __future__ import annotations

from .atomic import CRC32Writer, atomic_write  # noqa: F401
from .checkpoint_manager import (  # noqa: F401
    CheckpointAuditError,
    CheckpointManager,
    verify_checkpoint,
)
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
from .supervisor import (  # noqa: F401
    ENV_ATTEMPT,
    ENV_RESUME_DIR,
    TrainingSupervisor,
)

__all__ = [
    "FAULT_KINDS", "FaultInjector", "FaultSpec", "PoisonRequestError",
    "SimulatedCrash", "fault_point", "install", "uninstall",
    "current_injector", "injected_faults", "install_from_env",
    "Deadline", "RetryError", "backoff_delays", "retry",
    "atomic_write", "CRC32Writer",
    "CheckpointManager", "CheckpointAuditError", "verify_checkpoint",
    "IntegrityCallback", "tree_fingerprint", "compare_digests",
    "TrainingSupervisor", "ENV_RESUME_DIR", "ENV_ATTEMPT",
]

_INTEGRITY_NAMES = {"IntegrityCallback", "tree_fingerprint",
                    "shard_fingerprint", "compare_digests",
                    "first_divergent_leaf", "majority_partition"}


def __getattr__(name):
    # the sentinel callback needs the hapi hook surface (through
    # observability.goodput); a lazy import keeps this package importable
    # from the bottom of the layer stack
    if name in _INTEGRITY_NAMES:
        from . import integrity

        return getattr(integrity, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

# env-gated fault injection: inert unless PADDLE_TPU_FAULTS is set
install_from_env()
