"""The comparisons that decide ``correct``, and the judgement against the
cell's limits.

Training: each of the first steps' loss, each leaf's gradient norm at
the first step as the optimizer got it (after the clip), and each leaf's
change from the start after the last step followed.  A leaf's gap is
the gap between the two norms over the reference's norm of that leaf or
of the median leaf, whichever is larger; the number compared is the
worst leaf's.  An element whose first-step gradient in the reference is
under a thousandth of the median leaf's root mean square moves under
Adam by rounding alone (a key's bias under softmax, which the qkv bias
leaf holds beside the query's and the value's) and is left out of the
change, on both sides.

Serving: each served token's logit in the reference against the
reference's best at the same position; the number compared is the
widest gap.
"""
from __future__ import annotations

import math
from statistics import median

#: a leaf's reference gradient under this share of the median leaf's is
#: rounding alone
ROUNDING_ONLY = 1e-3


def leaf_gaps(prog, ref, leaves):
    """Each leaf's gap: the gap between the two norms over the
    reference's norm of that leaf or of the median leaf, the larger."""
    base = median(ref[p] for p in leaves)
    return {p: abs(prog[p] - ref[p]) / max(ref[p], base, 1e-30)
            for p in leaves}


def moved_norms(change, grad1):
    """Each leaf's change norm over the elements the reference's first
    gradient moves (``change``, ``grad1``: path -> tensor)."""
    rms = median(float(g.square().mean().sqrt()) for g in grad1.values())
    out = {}
    for p, d in change.items():
        keep = grad1[p].abs() >= ROUNDING_ONLY * rms
        out[p] = float(d.to(keep.device).float()[keep].norm())
    return out


def training_gaps(prog, ref):
    """``prog``: ``{"loss": [...], "grad": {path: norm}, "change": {path:
    tensor}}``; ``ref``: ``training.follow``'s.  Returns the worst step's
    relative loss gap and each leaf's gaps of the first gradient and of
    the change."""
    leaves = sorted(ref["grad"])
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   ref["loss"]))
    return loss, {
        "grad1": leaf_gaps(prog["grad"], ref["grad"], leaves),
        "change": leaf_gaps(moved_norms(prog["change"], ref["grad1"]),
                            moved_norms(ref["change"], ref["grad1"]),
                            leaves)}


def training(prog, ref):
    """The numbers compared: the loss gap, and the worst leaf's gaps."""
    loss, gaps = training_gaps(prog, ref)
    return {"loss_rel": loss, "grad1_rel": max(gaps["grad1"].values()),
            "change_rel": max(gaps["change"].values())}


def widest_gap(ref_logits, tokens):
    """The widest gap by which a chosen token's logit lies below the
    reference's best: ``ref_logits [n, V]`` float32, ``tokens`` the n
    tokens chosen at those positions."""
    import torch

    idx = torch.as_tensor(tokens, device=ref_logits.device)[:, None]
    chosen = ref_logits.gather(1, idx)[:, 0]
    return float((ref_logits.max(dim=1).values - chosen).max())


def judge(readings, limits):
    """(correct, checks): every number is finite and at most its limit;
    ``checks`` holds each number beside its limit."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
