"""hapi — the high-level ``Model.fit`` API (the port of
``paddle_tpu/hapi``)."""
from . import callbacks  # noqa: F401
from .callbacks import (Callback, CheckpointCallback,  # noqa: F401
                        EarlyStopping, LRScheduler, ModelCheckpoint,
                        ProfilerCallback, ProgBarLogger)
from .model import Model  # noqa: F401

__all__ = ["Model", "Callback", "ProgBarLogger", "ModelCheckpoint",
           "CheckpointCallback", "EarlyStopping", "LRScheduler",
           "ProfilerCallback", "callbacks"]
