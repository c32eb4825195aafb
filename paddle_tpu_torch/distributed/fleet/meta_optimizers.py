"""Communication-saving gradient syncs (the port of
``paddle_tpu/distributed/fleet/meta_optimizers.py``): a plain mean
all-reduce (``GradSync``), bf16 on the wire (``BF16AllreduceSync``),
Deep Gradient Compression (``DGCSync``: momentum-corrected residuals,
the top ``sparsity`` share exchanged a step) and LocalSGD (parameters
averaged every ``k_steps``).  Each all-reduces over its group, the
world when the group is None; as in the JAX package the DGC exchange is
the dense masked gradient."""
from __future__ import annotations

import math

import torch

from ..collective import ReduceOp, all_reduce, world_group

__all__ = ["GradSync", "BF16AllreduceSync", "DGCSync", "LocalSGD"]


def _group(group):
    return group or world_group()


def _live(params):
    return [p for p in params if p.requires_grad and p.grad is not None]


class GradSync:
    """Mean all-reduce of the gradients over the group."""

    def __init__(self, group=None):
        self.group = group

    @torch.no_grad()
    def sync(self, params):
        g = _group(self.group)
        for p in _live(params):
            all_reduce(p.grad, op=ReduceOp.SUM, group=g)
            if g.nranks > 1:
                p.grad /= g.nranks


class BF16AllreduceSync(GradSync):
    """Gradients cast to bf16 for the all-reduce and back to their dtype
    after it."""

    @torch.no_grad()
    def sync(self, params):
        g = _group(self.group)
        for p in _live(params):
            t = p.grad.to(torch.bfloat16)
            all_reduce(t, op=ReduceOp.SUM, group=g)
            out = t.to(p.grad.dtype)
            p.grad.copy_(out / g.nranks if g.nranks > 1 else out)


class DGCSync(GradSync):
    """Deep Gradient Compression: ``u = momentum·u + g``, ``v += u``; the
    entries of ``v`` at or above its top-``sparsity`` magnitude are sent
    (and cleared from ``v`` and ``u``), the rest wait.  Before
    ``rampup_begin_step`` steps the sync is dense."""

    def __init__(self, group=None, sparsity=0.01, momentum=0.9,
                 rampup_begin_step=0):
        super().__init__(group)
        self.sparsity = sparsity
        self.momentum = momentum
        self.rampup_begin_step = rampup_begin_step
        self._step = 0
        self._u = {}
        self._v = {}

    @torch.no_grad()
    def sync(self, params):
        self._step += 1
        if self._step <= self.rampup_begin_step:
            return super().sync(params)
        g = _group(self.group)
        for p in _live(params):
            grad = p.grad
            pid = id(p)
            u = self._u.get(pid)
            v = self._v.get(pid)
            u = grad.clone() if u is None else self.momentum * u + grad
            v = u.clone() if v is None else v + u
            k = max(1, int(math.ceil(v.numel() * self.sparsity)))
            thr = torch.topk(v.abs().reshape(-1), k).values[-1]
            mask = (v.abs() >= thr).to(v.dtype)
            send = v * mask
            v = v - send
            u = u * (1 - mask)
            self._u[pid], self._v[pid] = u, v
            all_reduce(send, op=ReduceOp.SUM, group=g)
            p.grad.copy_(send / g.nranks if g.nranks > 1 else send)


class LocalSGD:
    """Train ``k_steps`` locally, then average the parameters over the
    group (no per-step gradient all-reduce)."""

    def __init__(self, group=None, k_steps=4):
        self.group = group
        self.k_steps = k_steps
        self._step = 0

    @torch.no_grad()
    def after_step(self, params):
        self._step += 1
        if self._step % self.k_steps != 0:
            return False
        g = _group(self.group)
        for p in params:
            if not p.requires_grad:
                continue
            all_reduce(p.data, op=ReduceOp.SUM, group=g)
            if g.nranks > 1:
                p.data /= g.nranks
        return True
