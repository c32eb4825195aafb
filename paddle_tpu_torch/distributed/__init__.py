"""Training on one GPU (the single-device half of
``paddle_tpu.distributed``): ``HybridEngine`` and its ``EngineConfig``,
the model adapters (GPT dense or MoE, BERT), the MoE blocks and the
remat policies."""
from .engine import EngineConfig, HybridEngine
from .model_adapter import BertAdapter, GPTAdapter, ModelAdapter
from .moe import (GShardGate, MoELayer, NaiveGate, SwitchGate, moe_capacity,
                  moe_ffn, moe_gating, moe_layer, moe_route)
from .recompute import checkpoint_policy

__all__ = ["HybridEngine", "EngineConfig", "ModelAdapter", "GPTAdapter",
           "BertAdapter", "checkpoint_policy", "moe_capacity", "moe_route",
           "moe_gating", "moe_ffn", "moe_layer", "MoELayer", "NaiveGate",
           "SwitchGate", "GShardGate"]
