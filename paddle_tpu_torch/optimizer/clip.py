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

    def clip_windows(self, grads, whole_sums):
        """Elementwise: a window clips as its whole gradient does."""
        return self(grads)


class ClipGradByNorm:
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        return self.clip_windows(grads, lambda sums: sums)

    def clip_windows(self, grads, whole_sums):
        """Each gradient given as a window of it (hapi over a mesh):
        ``whole_sums`` maps each window's squared sum to its whole
        gradient's."""
        out = []
        sq = whole_sums([torch.sum(torch.square(g.float())) for g in grads])
        for g, s in zip(grads, sq):
            n = torch.sqrt(s)
            factor = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                 max=1.0)
            out.append((g.float() * factor).to(g.dtype))
        return out


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        return clip_grads_by_global_norm(grads, self.clip_norm)

    def clip_windows(self, grads, whole_sums):
        """The gradients given as windows of them (hapi over a mesh):
        ``whole_sums`` maps each window's squared sum to its whole
        gradient's, so each is counted once in the global norm."""
        return clip_grads_by_global_norm(grads, self.clip_norm, whole_sums)


def clip_grads_by_global_norm(grads, clip_norm, whole_sums=None):
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    if whole_sums is not None:
        sq = whole_sums(sq)
    gn = torch.sqrt(sum(sq))
    factor = torch.clamp(clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return [(g.float() * factor).to(g.dtype) for g in grads]
