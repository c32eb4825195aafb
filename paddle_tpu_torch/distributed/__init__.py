"""Training on one GPU (the single-device half of
``paddle_tpu.distributed``): ``HybridEngine`` and its ``EngineConfig``,
the model adapters and the remat policies."""
from .engine import EngineConfig, HybridEngine
from .model_adapter import GPTAdapter, ModelAdapter
from .recompute import checkpoint_policy

__all__ = ["HybridEngine", "EngineConfig", "ModelAdapter", "GPTAdapter",
           "checkpoint_policy"]
