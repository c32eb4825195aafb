"""paddle.static — the Program/Executor facade (the port of
``paddle_tpu/static``; reference parity: python/paddle/static/ over
fluid/framework.py Program:4777 + fluid/executor.py Executor:619).

``Executor.run`` replays a recorded ``Program`` (``program.py``) after
its passes, one cache entry per (program version, fed names, fetch list,
passes).  On CUDA each entry is captured as one CUDA graph per feed
signature and replayed (``_captured.SignatureGraphs``); a program that
holds a ``cond`` or ``while`` op replays its op list eagerly on the card
instead, since those ops read their predicate on the host.  The route
each run took is ``Executor.last_route``: ``"graph"``, ``"eager"`` or,
off CUDA, ``"cpu"``.  The program reads its parameters live, so an
update in place between runs is seen by the replay and a replaced tensor
captures again.
"""
from __future__ import annotations

import numpy as np
import torch

from .._captured import SignatureGraphs
from .._device import resolve_device
from ..core.place import current_device
from . import nn, passes
from .control_flow import cond, while_loop
from .passes import new_pass
from .program import (Program, current_program, data, default_main_program,
                      program_guard)

__all__ = ["Program", "program_guard", "default_main_program", "data",
           "Executor", "CompiledProgram", "new_pass", "passes",
           "cond", "while_loop", "nn", "current_program"]


class _Entry:
    """One compiled program: the rewritten clone, its route, its graphs
    (CUDA graph route) and a strong reference to the source program, so
    its id() is not reused while the entry lives."""

    def __init__(self, prog, source, route, device):
        self.prog, self.source, self.route = prog, source, route
        self.graphs = SignatureGraphs(device) if route == "graph" else None


class Executor:
    """Compile-and-run a Program (fluid/executor.py:619 Executor.run).
    ``place``: the device (``"gpu"``, ``"cpu"``, a ``torch.device``); by
    default the device the program's feeds were declared on (the place
    of ``set_device`` then; CUDA unless asked otherwise)."""

    def __init__(self, place=None):
        self.place = place
        self._cache = {}
        self.last_route = None

    def _device(self, program):
        if self.place is None:
            return program.device or current_device()
        place = str(self.place).lower()
        return resolve_device("cuda" + place[3:] if place.startswith("gpu")
                              else self.place)

    @property
    def captures(self):
        """CUDA graphs captured so far, over every cached program."""
        return sum(e.graphs.captures for e in self._cache.values()
                   if e.graphs is not None)

    def run(self, program=None, feed=None, fetch_list=None,
            use_passes=("dead_code_elimination",)):
        program = program or default_main_program()
        feed = feed or {}
        fetch_vids = []
        for t in fetch_list or []:
            vid = program.lookup(t)
            if vid is None:
                raise ValueError("fetch target was not produced by this "
                                 "program")
            fetch_vids.append(vid)
        dev = self._device(program)
        names = tuple(sorted(feed))
        # version catches in-place mutation (appended ops, user-applied
        # passes)
        key = (id(program), program.version, tuple(fetch_vids), names,
               tuple(use_passes or ()))
        entry = self._cache.get(key)
        if entry is None:
            prog = program.clone()
            for name in (use_passes or ()):
                new_pass(name).apply(prog, fetch_vids)
            route = ("cpu" if dev.type != "cuda" else
                     "eager" if prog.has_control_flow() else "graph")
            entry = self._cache[key] = _Entry(prog, program, route, dev)
        prog = entry.prog
        arrays = [self._feed(prog, k, feed[k]) for k in names]

        def body(*xs):
            with torch.no_grad():
                return tuple(prog.replay(dict(zip(names, xs)), fetch_vids))

        self.last_route = entry.route
        if entry.route == "graph":
            sig = tuple((tuple(a.shape), a.dtype) for a in arrays)
            out = entry.graphs.run(sig, body, arrays, prog.param_refs())
        else:
            out = body(*[a.to(dev) for a in arrays])
        return [o.detach().cpu().numpy() for o in out]

    @staticmethod
    def _feed(prog, name, value):
        """A fed value as a new tensor in its variable's dtype (replay
        never writes the caller's array)."""
        dtype = prog.vars[prog._feed_names[name]].dtype
        if isinstance(value, torch.Tensor):
            return value.to(dtype)
        return torch.tensor(np.asarray(value), dtype=dtype)

    def close(self):
        for entry in self._cache.values():
            if entry.graphs is not None:
                entry.graphs.release()
        self._cache.clear()


class CompiledProgram:
    """Parity shim for fluid.compiler.CompiledProgram: a Program bundled
    with its pass pipeline."""

    def __init__(self, program, build_strategy=None):
        self.program = program
        self.build_strategy = build_strategy

    def __getattr__(self, item):
        return getattr(self.program, item)
