"""``DistributedStrategy`` (the port of
``paddle_tpu/distributed/fleet/distributed_strategy.py``): a plain
config object whose fields mirror the reference proto's sub-messages."""
from __future__ import annotations

__all__ = ["DistributedStrategy", "engine_config_from_strategy"]


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0,
            "use_pure_bf16": True,
            "custom_white_list": [],
            "custom_black_list": [],
        }
        self.recompute = False
        self.recompute_configs = {"checkpoints": [], "policy": "full"}
        self.sharding = False
        self.sharding_configs = {"stage": 2, "offload": False}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 4}
        self.dgc = False
        self.dgc_configs = {"sparsity": 0.01, "momentum": 0.9,
                            "rampup_begin_step": 0}
        self.fp16_allreduce = False
        self.lars = False
        self.lamb = False
        self.find_unused_parameters = False
        self.sep_configs = {"mode": "ring"}  # ring | ulysses

    def __repr__(self):
        return f"DistributedStrategy({dict(self.__dict__)})"


def engine_config_from_strategy(strategy, **overrides):
    """The ``HybridEngine``'s ``EngineConfig`` for ``strategy``: the
    pipeline schedule and micro-batches, the sharding stage and gradient
    merge; everything else keeps its default or ``overrides``."""
    from ..engine import EngineConfig

    kw = {}
    if strategy.pipeline:
        pc = strategy.pipeline_configs
        kw["num_microbatches"] = int(pc.get("accumulate_steps", 1))
        mode = str(pc.get("schedule_mode", "1F1B")).lower()
        kw["pipeline_schedule"] = "1f1b" if mode == "1f1b" else "gpipe"
    if strategy.sharding:
        kw["zero_stage"] = int(strategy.sharding_configs.get("stage", 2))
    if strategy.gradient_merge:
        kw["accum_steps"] = int(
            strategy.gradient_merge_configs.get("k_steps", 1))
    kw.update(overrides)
    return EngineConfig(**kw)
