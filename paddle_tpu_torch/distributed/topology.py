"""The hybrid-parallel rank grid (the port of
``paddle_tpu/distributed/topology.py``).

``CommunicateTopology`` is the same row-major grid of ranks as the JAX
package's; ``HybridCommunicateGroup`` lays ``dp·pp·sharding·sep·ep·mp``
ranks out in that axis order (dp slowest, mp fastest) and gives this
process one ``collective.Group`` per axis: the ranks that differ from it
on that axis alone.  Where the JAX group is a view onto a mesh axis,
this one is a ``torch.distributed`` process group over those ranks.
``group_over(axes)`` gives the group over several axes at once (the
engine reduces gradients over ``("dp", "sharding", "sep", "ep")``).
Every rank of the world makes every group, in one order, as
``torch.distributed.new_group`` requires.
"""
from __future__ import annotations

import numpy as np

from . import collective
from .env import get_rank, get_world_size

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "AXES",
           "JOINT_AXES", "axis_groups"]

#: the engine's axes, outer to inner (``paddle_tpu.distributed.engine``)
AXES = ("dp", "pp", "sharding", "sep", "ep", "mp")


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"), dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = None
        self._world = int(np.prod(self._dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        coords = [kwargs[n] for n in self._parallel_names]
        return int(np.ravel_multi_index(coords, self._dims))

    def get_coord(self, rank):
        return tuple(int(c) for c in np.unravel_index(rank, self._dims))

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r in range(self._world)
                if self.get_coord(r)[axis] == index]

    def get_comm_list(self, axis_name):
        """Every group along ``axis_name``: lists of ranks that differ on
        that axis alone."""
        return axis_groups(self._dims, [self._parallel_names.index(
            axis_name)])


def axis_groups(dims, axes):
    """The rank lists of a row-major grid of ``dims`` that vary over the
    axis indices ``axes`` (in grid order) with every other coordinate
    fixed."""
    grid = np.arange(int(np.prod(dims))).reshape(dims)
    rest = [i for i in range(len(dims)) if i not in axes]
    moved = np.transpose(grid, rest + list(axes)).reshape(
        -1, int(np.prod([dims[a] for a in axes])) if axes else 1)
    return [[int(r) for r in row] for row in moved]


#: the groups over several axes a grid makes besides one an axis: the
#: engine's loss and gradient reductions, and the check group
JOINT_AXES = (("dp", "sharding", "sep", "ep"), ("dp", "sep", "ep"),
              ("dp", "sep"), ("dp", "sharding", "sep"),
              ("pp", "sharding", "mp"))


class HybridCommunicateGroup:
    """This process's place in a ``dp·pp·sharding·sep·ep·mp`` grid and its
    group along each axis (and along the ``JOINT_AXES``).  ``ranks``: the
    global ranks of the grid, in grid order (default: the whole world;
    ``0..n-1`` of a larger world leaves the other ranks free).  Every rank
    of the world constructs it, in the same order as its other groups
    (``torch.distributed.new_group``'s rule); on a rank outside the grid
    ``member`` is False and it holds no groups."""

    def __init__(self, topology: CommunicateTopology = None, dp_degree=1,
                 mp_degree=1, pp_degree=1, sharding_degree=1, sep_degree=1,
                 ep_degree=1, ranks=None):
        if topology is not None:
            dims = dict(zip(topology.get_hybrid_group_names(),
                            topology._dims))
            dp_degree = dims.get("data", 1)
            pp_degree = dims.get("pipe", 1)
            sharding_degree = dims.get("sharding", 1)
            mp_degree = dims.get("model", 1)
            sep_degree = dims.get("sep", 1)
            ep_degree = dims.get("expert", 1)
        self.sizes = {"dp": dp_degree, "pp": pp_degree,
                      "sharding": sharding_degree, "sep": sep_degree,
                      "ep": ep_degree, "mp": mp_degree}
        self._topo = topology or CommunicateTopology(
            ("data", "pipe", "sharding", "sep", "expert", "model"),
            tuple(self.sizes[a] for a in AXES))
        n = int(np.prod(list(self.sizes.values())))
        self.ranks = list(range(n)) if ranks is None else list(ranks)
        if len(self.ranks) != n:
            raise ValueError(f"a grid of {self.sizes} needs {n} ranks, "
                             f"got {len(self.ranks)}")
        if max(self.ranks) >= get_world_size():
            raise ValueError(
                f"the grid {self.sizes} needs ranks {self.ranks} but the "
                f"world has {get_world_size()} (call init_parallel_env, or "
                f"launch with --nproc_per_node {n})")
        me = get_rank()
        self.member = me in self.ranks
        self.grid_rank = self.ranks.index(me) if self.member else None
        self.coords = None
        if self.member:
            self.coords = {a: int(c) for a, c in zip(AXES, np.unravel_index(
                self.grid_rank, [self.sizes[a] for a in AXES]))}
        self._groups = {}
        dims = [self.sizes[a] for a in AXES]
        for axes in [(a,) for a in AXES] + list(JOINT_AXES):
            name = axes[0] if len(axes) == 1 else axes
            for row in axis_groups(dims, [AXES.index(a) for a in axes]):
                g = collective.new_group([self.ranks[r] for r in row],
                                         axis_name=name)
                if self.member and self.grid_rank in row:
                    self._groups[axes] = g

    def group_over(self, axes):
        """The group of the ranks that differ from this one on ``axes``
        only (one axis, or one of ``JOINT_AXES``; member order: row-major
        over ``axes`` in grid order)."""
        return self._groups[tuple(a for a in AXES if a in axes)]

    # parallel mode, as fleet_base resolves it
    def get_parallel_mode(self):
        s = self.sizes
        if s["mp"] == 1 and s["pp"] == 1 and s["sharding"] == 1:
            return "data_parallel" if s["dp"] > 1 else "single"
        if s["mp"] > 1 and s["pp"] == 1:
            return "tensor_parallel"
        if s["pp"] > 1:
            return "pipeline_parallel"
        return "sharding_parallel"

    # degrees
    def get_data_parallel_world_size(self):
        return self.sizes["dp"]

    def get_model_parallel_world_size(self):
        return self.sizes["mp"]

    def get_pipe_parallel_world_size(self):
        return self.sizes["pp"]

    def get_sharding_parallel_world_size(self):
        return self.sizes["sharding"]

    def get_sep_parallel_world_size(self):
        return self.sizes["sep"]

    def get_expert_parallel_world_size(self):
        return self.sizes["ep"]

    # groups
    def get_data_parallel_group(self):
        return self.group_over(("dp",))

    def get_model_parallel_group(self):
        return self.group_over(("mp",))

    def get_pipe_parallel_group(self):
        return self.group_over(("pp",))

    def get_sharding_parallel_group(self):
        return self.group_over(("sharding",))

    def get_sep_parallel_group(self):
        return self.group_over(("sep",))

    def get_expert_parallel_group(self):
        return self.group_over(("ep",))

    def get_check_parallel_group(self):
        return self.group_over(("pp", "sharding", "mp"))

    # this rank's coordinates
    def get_data_parallel_rank(self):
        return self.coords["dp"]

    def get_model_parallel_rank(self):
        return self.coords["mp"]

    def get_stage_id(self):
        return self.coords["pp"]

    def get_sharding_parallel_rank(self):
        return self.coords["sharding"]

    def get_sep_parallel_rank(self):
        return self.coords["sep"]

    def get_expert_parallel_rank(self):
        return self.coords["ep"]

    def topology(self):
        return self._topo

    def get_rank_from_stage(self, stage_id, **kwargs):
        return self._topo.get_rank(**{"pipe": stage_id, **kwargs})
