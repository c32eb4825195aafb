"""Box ops (the port of ``paddle_tpu/vision/ops.py``; reference parity:
paddle.vision.ops — box_iou, nms, box_area).

They compute on the device of the boxes they are given.  ``nms`` builds
the whole [N, N] suppression relation on the device in one pass (IoU of
the score-sorted boxes above the threshold, within a category, lower
rank only), packs it into a bitmask there, and copies that to the host
once: the greedy sweep over N boxes is then N big-integer operations on
the host, where the JAX package runs a ``lax.scan`` of N steps (a Python
loop of torch steps would launch several kernels a box on the card).
The kept indices and their order equal the JAX package's: scores sorted
by a stable descending sort, ties in index order.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["box_iou", "nms", "box_area"]


def _t(x, dtype=None):
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def box_area(boxes):
    b = _t(boxes)
    return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])


def box_iou(boxes1, boxes2):
    """Pairwise IoU of [N, 4] x [M, 4] xyxy boxes -> [N, M]."""
    a, b = _t(boxes1), _t(boxes2)
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area1[:, None] + area2[None] - inter,
                               min=1e-10)


def _suppression_bits(b, order, iou_threshold, cats):
    """Row i of the result (a Python int) has bit j set when sorted box
    i would suppress sorted box j: j ranks below i and their IoU (0
    across categories) exceeds the threshold."""
    n = b.shape[0]
    bs = b[order]
    iou = box_iou(bs, bs)
    if cats is not None:
        cs = cats[order]
        iou = torch.where(cs[:, None] == cs[None, :], iou,
                          torch.zeros((), dtype=iou.dtype,
                                      device=iou.device))
    rank = torch.arange(n, device=b.device)
    sup = (iou > iou_threshold) & (rank[None, :] > rank[:, None])
    width = -(-n // 8) * 8
    if width != n:
        sup = torch.nn.functional.pad(sup, (0, width - n))
    weights = (1 << torch.arange(8, device=b.device)).to(torch.uint8)
    packed = (sup.view(n, width // 8, 8).to(torch.uint8) * weights) \
        .sum(-1, dtype=torch.uint8)
    raw = packed.cpu().numpy()
    return [int.from_bytes(raw[i].tobytes(), "little") for i in range(n)]


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy NMS (reference vision/ops.py nms): keeps the highest-score
    box, suppresses overlaps above ``iou_threshold``, repeats.
    Category-aware when ``category_idxs`` is given (boxes of different
    categories never suppress each other).  Returns the kept indices in
    score order (int64, on the boxes' device), truncated to ``top_k``."""
    b = _t(boxes, torch.float32)
    n = b.shape[0]
    s = (_t(scores, torch.float32).to(b.device) if scores is not None
         else torch.arange(n, 0, -1, dtype=torch.float32, device=b.device))
    order = torch.sort(-s, stable=True).indices
    cats = (None if category_idxs is None
            else _t(category_idxs).to(b.device))
    rows = _suppression_bits(b, order, iou_threshold, cats)
    removed, kept = 0, []
    for i in range(n):
        if not (removed >> i) & 1:
            kept.append(i)
            removed |= rows[i]
    if top_k is not None:
        kept = kept[:top_k]
    pos = torch.as_tensor(kept, dtype=torch.int64).to(b.device)
    return order[pos]
