"""ASP — automatic structured pruning (the port of
``paddle_tpu/contrib/sparsity.py``; parity: python/paddle/fluid/contrib/
sparsity + meta_optimizers/asp_optimizer.py: 2:4 (n:m) weight masks
computed once, re-applied after every optimizer step so pruned weights
stay zero through training).

The masks are computed on the host with numpy, as in the JAX package,
and kept on the device of their parameter.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["create_mask", "check_mask", "prune_model", "ASPHelper",
           "decorate"]


def _np(weight):
    if isinstance(weight, torch.Tensor):
        return weight.detach().float().cpu().numpy()
    return np.asarray(weight)


def create_mask(weight, n=2, m=4):
    """n:m mask along the LAST axis: keep the n largest-|w| of every m
    (reference: sparsity/utils.py create_mask, MaskAlgo_MASK_1D)."""
    arr = _np(weight)
    # groups must lie WITHIN the last axis (hardware n:m semantics): a
    # non-multiple last dim is left dense rather than silently straddled
    if arr.shape[-1] % m:
        return np.ones_like(arr)
    flat = arr.reshape(-1, m)
    order = np.argsort(-np.abs(flat), axis=1)
    mask = np.zeros_like(flat)
    rows = np.arange(flat.shape[0])[:, None]
    mask[rows, order[:, :n]] = 1.0
    return mask.reshape(arr.shape)


def check_mask(weight, n=2, m=4):
    """True iff every group of m has at most n nonzeros."""
    arr = _np(weight)
    if arr.shape[-1] % m:
        return True
    nz = (arr.reshape(-1, m) != 0).sum(axis=1)
    return bool((nz <= n).all())


class ASPHelper:
    """Holds per-parameter masks and re-applies them (the reference's
    ASPHelper + OptimizerWithSparsityGuarantee)."""

    def __init__(self, n=2, m=4):
        self.n, self.m = n, m
        self._masks = {}

    def prune(self, model, include=("weight",)):
        for name, p in model.named_parameters():
            if not any(name.endswith(s) for s in include):
                continue
            if p.ndim < 2:
                continue
            mask = create_mask(p, self.n, self.m)
            self._masks[name] = torch.as_tensor(mask).to(
                device=p.device, dtype=p.dtype)
            with torch.no_grad():
                p.mul_(self._masks[name])
        return self

    def apply_masks(self, model):
        named = dict(model.named_parameters())
        with torch.no_grad():
            for name, mask in self._masks.items():
                named[name].mul_(mask)

    def masks(self):
        return dict(self._masks)


def prune_model(model, n=2, m=4):
    """Reference: paddle.incubate.asp.prune_model."""
    helper = ASPHelper(n, m)
    helper.prune(model)
    model._asp_helper = helper
    return helper


def decorate(optimizer, model):
    """Wrap optimizer.step so masks re-apply after every update
    (reference: asp.decorate / OptimizerWithSparsityGuarantee)."""
    helper = getattr(model, "_asp_helper", None)
    if helper is None:
        helper = prune_model(model)
    orig_step = optimizer.step

    def step():
        orig_step()
        helper.apply_masks(model)

    optimizer.step = step
    return optimizer
