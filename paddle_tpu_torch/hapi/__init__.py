"""hapi — the high-level ``Model.fit`` API (the port of
``paddle_tpu/hapi``), with the fault-tolerant fit: ``CheckpointCallback``,
``fit(resume_from=)``, health rollback and the ``IntegrityCallback``
sentinel."""
from . import callbacks  # noqa: F401
from .callbacks import (Callback, CheckpointCallback,  # noqa: F401
                        EarlyStopping, LRScheduler, ModelCheckpoint,
                        ProfilerCallback, ProgBarLogger)
from .model import Model  # noqa: F401

# imported after callbacks and model, so the resilience package (which
# sits below hapi) finishes loading without a cycle
from ..resilience.integrity import IntegrityCallback  # noqa: E402,F401

__all__ = ["Model", "Callback", "ProgBarLogger", "ModelCheckpoint",
           "CheckpointCallback", "EarlyStopping", "LRScheduler",
           "ProfilerCallback", "IntegrityCallback", "callbacks"]
