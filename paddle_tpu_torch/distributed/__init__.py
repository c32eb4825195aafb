"""Training on one GPU or a world of ranks (the port of
``paddle_tpu.distributed``): the environment and the launcher's
contract, the collectives over process groups, the rank grid, the
sharding rules, the tensor-parallel layers, ``DataParallel``, Fleet,
``HybridEngine`` and its ``EngineConfig``, the model adapters (GPT
dense or MoE, BERT), the MoE blocks, the remat policies, the pipeline
layers (``pp_layers``), the host-actor pipeline (``fleet_executor``),
semi-automatic SPMD (``auto_parallel``: ``shard_tensor``, ``reshard``,
``parallelize``) and the sparse parameter server (``ps``)."""
from .env import (ParallelEnv, get_rank, get_world_size,  # noqa: F401
                  init_parallel_env, is_initialized)
from .collective import (ReduceOp, all_gather, all_reduce,  # noqa: F401
                         all_to_all, barrier, broadcast, get_group,
                         new_group, ppermute, recv, reduce, reduce_scatter,
                         scatter, send, split)
from .topology import (CommunicateTopology,  # noqa: F401
                       HybridCommunicateGroup)
from . import mesh  # noqa: F401
from .mesh import build_mesh, replica_peers  # noqa: F401
from . import fleet  # noqa: F401
from .parallel import DataParallel  # noqa: F401
from .engine import EngineConfig, HybridEngine
from .model_adapter import BertAdapter, GPTAdapter, ModelAdapter
from .moe import (GShardGate, MoELayer, NaiveGate, SwitchGate, moe_capacity,
                  moe_ffn, moe_gating, moe_layer, moe_route)
from .recompute import checkpoint_policy
from . import fleet_executor, pp_layers  # noqa: F401
from . import auto_parallel, ps  # noqa: F401
from .auto_parallel import reshard, shard_tensor  # noqa: F401

__all__ = ["HybridEngine", "EngineConfig", "ModelAdapter", "GPTAdapter",
           "BertAdapter", "checkpoint_policy", "moe_capacity", "moe_route",
           "moe_gating", "moe_ffn", "moe_layer", "MoELayer", "NaiveGate",
           "SwitchGate", "GShardGate", "init_parallel_env", "get_rank",
           "get_world_size", "is_initialized", "ParallelEnv", "ReduceOp",
           "all_gather", "all_reduce", "all_to_all", "barrier", "broadcast",
           "get_group", "new_group", "ppermute", "recv", "reduce",
           "reduce_scatter", "scatter", "send", "split",
           "CommunicateTopology", "HybridCommunicateGroup", "mesh",
           "build_mesh", "replica_peers", "fleet", "DataParallel",
           "pp_layers", "fleet_executor", "auto_parallel", "ps",
           "shard_tensor", "reshard"]
