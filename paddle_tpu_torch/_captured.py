"""One captured CUDA graph per step function: the port's ``jax.jit``.

A step of the serving engine, of ``HybridEngine`` or of hapi's
``Model`` keeps the same shapes from call to call.  ``CapturedStep``
runs such a step's body eagerly on the CPU; on CUDA it runs the body
once eagerly on the device's capture stream (that call's real result;
the kernel builds and the libraries' first-use set-up happen there),
captures it as a ``torch.cuda.CUDAGraph`` over the same argument
tensors, and replays the graph on every later call whose ``storage`` tag
is the one it was captured with.  Capturing executes nothing, so the
call that captures returns the eager run's result and each call does
its work exactly once.  A call with another tag (a tensor the graph
reads was replaced, an input changed shape, a static setting changed)
frees the old graph and its pool and captures again.  A failed capture
raises: nothing falls back to the eager body.

Kernel launch counts: a kernel wrapper called while its stream is being
captured launches nothing and counts the call in its ``captured``
mapping; ``CapturedStep`` adds the calls each graph holds to the
wrappers' ``launches`` at every replay (``_counters``).

``StaticInputs`` holds the device buffers a graph reads its inputs from,
and ``storage_tag`` renders what a graph depends on as a short string,
which the callers pass to the compile watchdog as a static argument, so
that a re-capture shows as a rebuild there.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .core.random import begin_step, generators, step_scope

__all__ = ["CapturedStep", "StaticInputs", "SignatureGraphs", "storage_tag",
           "capture_stream"]

#: device index -> the side stream every step warms up and captures on.
#: cuBLAS keeps a workspace for each stream it has run on, for the life
#: of the process: a stream of its own per engine would leave one
#: workspace behind for every engine a fleet ever built
_CAPTURE_STREAMS = {}


def capture_stream(device):
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def _counters():
    """``(launches, launch key, captured, captured key)`` of every count
    a kernel wrapper keeps."""
    from .kernels import flash_attention as fa
    from .kernels.paged_attention import ragged_paged_attention as rpa

    ra = importlib.import_module("paddle_tpu_torch.kernels.ring_attention")
    return ([(fa.launches, k, fa.captured, k) for k in fa.launches]
            + [(ra.launches, k, ra.captured, k) for k in ra.launches]
            + [(rpa.__dict__, "launches", rpa.__dict__, "captured")])


def storage_tag(tensors, *static):
    """The addresses, shapes and dtypes of ``tensors`` and the (hashable)
    ``static`` values as a short tag: equal tags mean a graph captured on
    one call reads and writes the right memory on the other.  A hash,
    valid within the process (the tags are only compared there)."""
    parts = tuple((t.data_ptr(), t.shape, t.dtype) for t in tensors)
    return f"{hash((parts, static)) & 0xFFFFFFFFFFFF:012x}"


class CapturedStep:
    """``body(*args)`` eagerly on the CPU; on CUDA captured once per
    ``storage`` tag and replayed (see the module docstring).

    ``pool``: a ``torch.cuda.graph_pool_handle()`` shared with other
    steps that never run at the same time (``SignatureGraphs``); None
    gives the graph a pool of its own.

    ``empty_cache``: return the eager run's cached blocks to the device
    before capturing, so that they and the graph's private pool are not
    both held (a training step's activations).  Every run of the body
    is inside ``core.random.step_scope()``, and every replay starts with
    its ``begin_step()``: a ``key_stream`` or ``recompute`` in the body
    draws from generator pairs made in the eager run.  Called inside
    another step's scope (a hapi body), the body is part of that step:
    the scope and ``begin_step`` then change nothing.  The port's
    generators of the device (every stream's and every pair's,
    ``core.random.generators``; dropout layers draw from the active one)
    are registered with each graph, so a replay advances them as an
    eager call would (by nothing, where the body draws nothing).  It
    holds no
    reference to its owner beyond
    ``body``; an owner that passes a bound method should pass it
    through a ``weakref.WeakMethod``; a subclass may define ``body`` as
    a method instead (no cycle: the bound method is made at each
    call)."""

    def __init__(self, body, device, *, empty_cache=False, pool=None):
        if body is not None:
            self.body = body
        self.device = device
        self.empty_cache = empty_cache
        self.pool = pool          # a graph pool shared with other steps
        self.graph = None
        self.out = None           # the graph's static outputs
        self.storage = None       # the tag the graph was captured with
        self.launches = ()        # captured calls per entry of _counters()
        self.captures = 0
        self.pool_bytes = 0       # device memory the graph's pool holds

    def release(self):
        """Drop the graph, its static outputs and (once no caller holds
        one of them) its pool."""
        self.graph = self.out = self.storage = None
        self.launches, self.pool_bytes = (), 0

    def __call__(self, *args, storage=None):
        if self.device.type != "cuda":
            with step_scope():
                return self.body(*args)
        if self.graph is not None and storage == self.storage:
            begin_step()
            self.graph.replay()
            for (lm, lk, _, _), n in zip(_counters(), self.launches):
                lm[lk] += n
            return self.out
        if self.graph is not None:
            self.release()
            if self.empty_cache:
                torch.cuda.empty_cache()
        dev = self.device
        side = capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), step_scope():
            out = self.body(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        if self.empty_cache:
            torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        for gen in generators(dev):
            graph.register_generator_state(gen)
        counters = _counters()
        before = [cm[ck] for _, _, cm, ck in counters]
        # thread-local capture: another thread's CUDA calls do not break
        # it (the DataLoader's prefetch thread allocates pinned host
        # memory while a training step captures)
        with torch.cuda.graph(graph, pool=self.pool, stream=side,
                              capture_error_mode="thread_local"):
            # the graph's private pool takes new segments only: the
            # reserved bytes grow by what the pool holds
            reserved = torch.cuda.memory_reserved(dev)
            with step_scope():
                static = self.body(*args)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = [cm[ck] - b
                         for (_, _, cm, ck), b in zip(counters, before)]
        self.graph, self.out, self.storage = graph, static, storage
        self.captures += 1
        return out


class StaticInputs:
    """The device buffers a captured step reads its inputs from.  Each
    call copies the given arrays (numpy, or tensors on any device) into
    them, host data through one pinned buffer each, and returns them; an
    input of a shape or dtype other than the last call's gets new
    buffers (a new ``storage_tag``, so a new capture).  Before a pinned
    buffer is written again the host waits for its last copy to the
    device, so it never runs more than a step ahead of the device (on
    the CPU the buffers are plain tensors, written in place the same
    way).  ``dtype``: cast every input to it."""

    def __init__(self, device, dtype=None):
        self.device, self.dtype = device, dtype
        self._key = None
        self._dev = self._pinned = ()
        self._copied = None       # event after the last copy from pinned

    def _host(self, a):
        t = a if isinstance(a, torch.Tensor) \
            else torch.from_numpy(np.asarray(a))
        return t if self.dtype is None else t.to(self.dtype)

    def __call__(self, *arrays):
        ts = [self._host(a) for a in arrays]
        cuda = self.device.type == "cuda"
        key = [(tuple(t.shape), t.dtype) for t in ts]
        if key != self._key:
            self._key, self._copied = key, None
            self._dev = [torch.empty(s, dtype=d, device=self.device)
                         for s, d in key]
            self._pinned = [torch.empty(s, dtype=d, pin_memory=True)
                            for s, d in key] if cuda else self._dev
        elif self._copied is not None:
            self._copied.synchronize()
        if not cuda:
            for dst, t in zip(self._dev, ts):
                dst.copy_(t)
            return tuple(self._dev)
        stream = torch.cuda.current_stream(self.device)
        for dst, pin, t in zip(self._dev, self._pinned, ts):
            if t.device.type == "cuda":
                dst.copy_(t)
            else:
                pin.copy_(t)
                dst.copy_(pin, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record(stream)
        return tuple(self._dev)


class SignatureGraphs:
    """One ``CapturedStep`` per input signature, all in one graph pool:
    the deployment entry points' ``jax.jit`` cache (``jit.TracedLayer``,
    the ``inference`` predictors, ``static.Executor``), on CUDA only.

    ``run(key, body, arrays, state)``: the first call with ``key`` (the
    caller's signature: shapes, dtypes, static settings) gives it its own
    ``StaticInputs`` and ``CapturedStep`` over ``body``; every call copies
    ``arrays`` into that signature's buffers and runs the step with a
    storage tag over the buffers and ``state`` (the tensors the body
    reads besides its inputs: a replaced weight captures again, an
    update in place is seen by the replay).  The graphs share one pool:
    the signatures of one entry point never run at the same time, and
    each call returns copies of the graph's outputs, so a later replay
    of another graph cannot overwrite what a caller holds.  A failed
    capture raises, as ``CapturedStep`` does."""

    def __init__(self, device):
        self.device = device
        self.pool = None
        self._steps = {}          # key -> (StaticInputs, CapturedStep)

    def run(self, key, body, arrays, state=()):
        entry = self._steps.get(key)
        if entry is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            entry = (StaticInputs(self.device),
                     CapturedStep(body, self.device, pool=self.pool))
            self._steps[key] = entry
        inputs, step = entry
        xs = inputs(*arrays)
        out = step(*xs, storage=storage_tag([*xs, *state]))
        return pytree.tree_map_only(torch.Tensor, torch.clone, out)

    @property
    def captures(self):
        return sum(step.captures for _, step in self._steps.values())

    @property
    def pool_bytes(self):
        """Device bytes the shared pool took while capturing."""
        return sum(step.pool_bytes for _, step in self._steps.values())

    def release(self):
        for _, step in self._steps.values():
            step.release()
        self._steps.clear()
        self.pool = None
