"""The Fleet facade (the port of
``paddle_tpu/distributed/fleet/fleet_base.py``)."""
from __future__ import annotations

from ..collective import barrier
from ..env import get_rank, get_world_size, init_parallel_env
from ..topology import HybridCommunicateGroup
from .distributed_strategy import DistributedStrategy

__all__ = ["Fleet", "fleet", "init", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group"]

_hcg: list = [None]
_strategy: list = [None]


def get_hybrid_communicate_group():
    return _hcg[0]


class Fleet:
    def __init__(self):
        self._is_initialized = False

    def init(self, role_maker=None, is_collective=True, strategy=None):
        """Lay the world out as ``strategy.hybrid_configs``; where the
        degrees do not fill the world, dp takes the ranks the others
        leave (the default strategy on n ranks is dp = n).  Brings the
        environment up first (``init_parallel_env``)."""
        strategy = strategy or DistributedStrategy()
        init_parallel_env()
        cfg = strategy.hybrid_configs
        n = get_world_size()
        others = (cfg["mp_degree"] * cfg["pp_degree"] *
                  cfg["sharding_degree"] * cfg.get("sep_degree", 1))
        if cfg["dp_degree"] * others != n:
            cfg["dp_degree"] = max(n // max(others, 1), 1)
        _hcg[0] = HybridCommunicateGroup(
            dp_degree=cfg["dp_degree"], mp_degree=cfg["mp_degree"],
            pp_degree=cfg["pp_degree"],
            sharding_degree=cfg["sharding_degree"],
            sep_degree=cfg.get("sep_degree", 1))
        _strategy[0] = strategy
        self._is_initialized = True
        return self

    @property
    def is_initialized(self):
        return self._is_initialized

    def get_hybrid_communicate_group(self):
        return _hcg[0]

    @property
    def strategy(self):
        return _strategy[0]

    def distributed_model(self, model):
        """Wrap per parallel mode: in pipeline mode the pipeline trainer
        (``pp_layers.PipelineEngine``) of a ``PipelineLayer`` built for
        this rank's stage (``topology=`` the hcg), over the hcg's pp
        group, with ``pipeline_configs["accumulate_steps"]``
        microbatches; ``DataParallel`` over the dp group in data-parallel
        mode; other modes train through layers that hold their own
        shards (``mp_layers``) and are returned as they are.  (The JAX
        ``fleet_base`` imports a ``..pipeline`` module that its package
        does not have, so the same call raises ``ModuleNotFoundError``
        there.)"""
        hcg = _hcg[0]
        mode = hcg.get_parallel_mode()
        if mode == "pipeline_parallel":
            from ..pp_layers import PipelineEngine, PipelineLayer

            if not isinstance(model, PipelineLayer):
                raise TypeError(
                    "pipeline mode trains a PipelineLayer (build it with "
                    "topology=fleet.get_hybrid_communicate_group())")
            cfg = _strategy[0].pipeline_configs
            return PipelineEngine(
                model, num_microbatches=int(cfg.get("accumulate_steps", 1)),
                group=hcg.get_pipe_parallel_group())
        if mode == "data_parallel":
            from ..parallel import DataParallel

            return DataParallel(model, group=hcg.get_data_parallel_group())
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        from .hybrid_optimizer import HybridParallelOptimizer

        return HybridParallelOptimizer(optimizer, _hcg[0],
                                       strategy or _strategy[0])

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def is_first_worker(self):
        return get_rank() == 0

    def barrier_worker(self):
        barrier()

    def save_persistables(self, executor=None, dirname=None,
                          main_program=None):
        raise NotImplementedError(
            "use paddle_tpu_torch.distributed.checkpoint")


fleet = Fleet()
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
