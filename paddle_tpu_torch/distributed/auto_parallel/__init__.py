"""Semi-automatic SPMD parallelization (the port of
``paddle_tpu/distributed/auto_parallel``).

- **Completer** → :class:`ShardingPropagator` (``propagation.py``):
  sparse annotations propagate to a full PartitionSpec for every input
  (and every intermediate) over a ``make_fx`` trace of the function, by
  factor-group union-find.
- **Partitioner / Resharder** → ``api.py``: :func:`parallelize` runs
  the traced graph on every rank of a world over the rank's shards,
  each operation on its local blocks, with the collectives the layouts
  need inserted between them (the JAX package hands this to GSPMD);
  :func:`shard_tensor` / :func:`reshard` move values into each rank's
  window of a mesh, across meshes too.
"""
from .api import DistTensor, parallelize, reshard, shard_tensor
from .propagation import ShardingPropagator, complete

__all__ = ["ShardingPropagator", "complete", "shard_tensor", "reshard",
           "parallelize", "DistTensor"]
