"""The distributed environment (the port of
``paddle_tpu/distributed/env.py``): one process per rank.

The launcher (``python -m paddle_tpu_torch.distributed.launch``) writes
the ``PADDLE_*`` contract; ``init_parallel_env()`` reads it and calls
``torch.distributed.init_process_group``:

  PADDLE_TRAINER_ID    global rank        PADDLE_TRAINERS_NUM  world size
  PADDLE_LOCAL_RANK    rank on this node  PADDLE_MASTER        host:port
  PADDLE_DIST_BACKEND  ``nccl`` or ``gloo`` (default: chosen below)
  PADDLE_DIST_DEVICE   ``cpu`` or ``cuda`` (default: ``cuda``)
  PADDLE_MASTER_HOSTED ``1``: the launcher hosts the store at
                       PADDLE_MASTER, so rank 0 connects as a client too,
                       under the key prefix ``attempt_<N>/`` of
                       PADDLE_RESTART_ATTEMPT

Each rank's device is ``cuda:{local_rank % device_count}``, or the CPU
when the caller passes ``device="cpu"`` (or the contract says
``PADDLE_DIST_DEVICE=cpu``); a rank asked for CUDA without a usable card
raises.  The transport is one per world, chosen from the topology and
printed by rank 0: NCCL when every rank on this node has a card of its
own (``nproc_per_node <= device_count``), gloo when ranks share a card
or run on the CPU.  Over gloo the collective layer sends the CUDA
tensors gloo does not take through pinned host memory
(``collective.GLOO_CUDA``); the compute stays on the card.
"""
from __future__ import annotations

import atexit
import os
import sys
from datetime import timedelta

import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "ParallelEnv", "current_device", "transport"]

_state = {"device": None, "transport": None}


def _choose_backend(device, nproc_local):
    if device.type == "cpu":
        return "gloo"
    return "nccl" if nproc_local <= torch.cuda.device_count() else "gloo"


def init_parallel_env(backend=None, device=None, init_method=None,
                      world_size=None, rank=None, timeout_s=600):
    """Bring up the process group from the arguments or the launcher's
    contract and return ``ParallelEnv()``.  One process alone (world
    size 1 and no master) marks the environment ready without a process
    group, as the JAX function does on one chip."""
    if _state["device"] is not None:
        return ParallelEnv()
    env = os.environ
    world = int(world_size if world_size is not None else
                env.get("PADDLE_TRAINERS_NUM", "1"))
    me = int(rank if rank is not None else env.get("PADDLE_TRAINER_ID", "0"))
    local = int(env.get("PADDLE_LOCAL_RANK", me))
    nproc_local = int(env.get("PADDLE_NPROC_PER_NODE", world))
    if device is None:
        device = env.get("PADDLE_DIST_DEVICE") or None
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda":
        resolve_device("cuda")             # raises without a usable card
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or env.get("PADDLE_DIST_BACKEND") or \
        _choose_backend(dev, nproc_local)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices")
    master = env.get("PADDLE_MASTER")
    if world > 1 or master or init_method:
        extra = {"device_id": dev} if backend == "nccl" else {}
        if init_method is None and master and \
                env.get("PADDLE_MASTER_HOSTED") == "1":
            # the launcher bound this store before starting the ranks:
            # no rank binds a port of its own to rendezvous
            host, port = master.rsplit(":", 1)
            store = dist.PrefixStore(
                f"attempt_{env.get('PADDLE_RESTART_ATTEMPT', '0')}/",
                dist.TCPStore(host, int(port), world, False,
                              timeout=timedelta(seconds=timeout_s)))
            dist.init_process_group(
                backend, store=store, world_size=world, rank=me,
                timeout=timedelta(seconds=timeout_s), **extra)
        else:
            init_method = init_method or f"tcp://{master}"
            dist.init_process_group(
                backend, init_method=init_method, world_size=world,
                rank=me, timeout=timedelta(seconds=timeout_s), **extra)
        atexit.register(_end_world)
    if dev.type == "cpu":
        where = "the CPU"
    else:
        n = torch.cuda.device_count()
        where = (f"{n} card(s)" + (", sharing them"
                                   if nproc_local > n else ""))
    staged = (", CUDA tensors staged through pinned host memory for the "
              "collectives gloo does not take on CUDA"
              if backend == "gloo" and dev.type == "cuda" else "")
    _state["device"] = dev
    _state["transport"] = f"{backend}, {world} rank(s) on {where}{staged}"
    if me == 0 and world > 1:
        print(f"init_parallel_env: {_state['transport']}", file=sys.stderr,
              flush=True)
    return ParallelEnv()


def _end_world():
    """At exit, destroy the process groups while the interpreter is
    still whole.  A gloo group left to the interpreter's teardown
    aborts its process now and then after the work is done ("terminate
    called without an active exception": 2 to 3 of 150 two-rank worlds
    of plain ``torch.distributed`` on the CPU, 12 of 300 under load,
    none of 750 that destroyed it first), and the launcher then reports
    a failed rank.
    The collective layer's group cache holds the groups: it goes
    first."""
    if not dist.is_initialized():
        return
    from . import collective

    collective._groups.clear()
    collective._by_ranks.clear()
    try:
        dist.destroy_process_group()
    except (RuntimeError, ValueError):
        pass    # silent-ok: the process is exiting; a group torch
        #         already tore down has nothing left to release


def is_initialized():
    return _state["device"] is not None


def get_rank():
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def current_device():
    """This rank's device (CUDA unless ``init_parallel_env`` was told the
    CPU; ``cuda`` before it is called)."""
    return _state["device"] or resolve_device(None)


def transport():
    """The world's transport as ``init_parallel_env`` printed it."""
    return _state["transport"]


class ParallelEnv:
    """``paddle.distributed.ParallelEnv``: this process's place in the
    world."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        """Rank within this node (the launcher's contract)."""
        return int(os.environ.get("PADDLE_LOCAL_RANK", get_rank()))

    @property
    def device_id(self):
        dev = _state["device"]
        return dev.index if dev is not None and dev.type == "cuda" else 0

    @property
    def device(self):
        return current_device()

    @property
    def nranks(self):
        return get_world_size()

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")

    @property
    def current_endpoint(self):
        eps = self.trainer_endpoints
        r = self.local_rank
        return eps[r] if r < len(eps) else ""
