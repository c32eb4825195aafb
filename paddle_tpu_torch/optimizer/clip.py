"""Gradient clipping (the port of ``paddle_tpu/optimizer/clip.py``):
callables over a list of gradients, used by the eager ``step`` and by
``apply_gradients``."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grads_by_global_norm"]


class ClipGradByValue:
    def __init__(self, max, min=None):  # noqa: A002
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class ClipGradByNorm:
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        out = []
        for g in grads:
            n = torch.sqrt(torch.sum(torch.square(g.float())))
            factor = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                 max=1.0)
            out.append((g.float() * factor).to(g.dtype))
        return out


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        return clip_grads_by_global_norm(grads, self.clip_norm)


def clip_grads_by_global_norm(grads, clip_norm):
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    factor = torch.clamp(clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return [(g.float() * factor).to(g.dtype) for g in grads]
