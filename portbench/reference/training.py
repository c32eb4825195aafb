"""The reference of a training step: the loss and its gradients from
``models.ce_sum`` and the AdamW update that the configuration states,
all in float32.

The update, as the configuration's ``optimizer`` group states it: the
gradients clipped to a global norm of ``grad_clip``; Adam's moments with
bias correction; decoupled weight decay ``weight_decay`` on every leaf
but the LayerNorm leaves (names holding ``ln``) and the biases (names
ending ``_b``); ``w -= lr · (m̂ / (√v̂ + eps) + wd · w)``.

``follow`` runs the first steps of a training run from the same
weights and batches the program had and returns what the comparison
reads: each step's loss, each leaf's gradient norm after the clip at the
first step, and each leaf's change from the start after the last step.
The batch is worked in blocks of rows, so that the float32 activations of
one block fit beside the state; the gradients of the blocks add up to
the gradient of the whole batch's mean loss.
"""
from __future__ import annotations

import torch

from . import models


def decays(path):
    leaf = path.split("/")[-1]
    return "ln" not in leaf and not path.endswith("_b")


def follow(c, w0, batches, rows_per_block, mm=models.matmul,
           keep_rows=None):
    """``w0``: ``path -> tensor`` (any dtype; cast to float32);
    ``batches``: ``(tokens, labels)`` of each step.  ``keep_rows`` (a
    fault planted for the control's tests): only the first ``keep_rows``
    rows of each batch count, the mean taken over them.  Returns
    ``{"loss": [...], "grad": {path: norm}, "grad1": {path: tensor},
    "change": {path: tensor}}``: the first step's clipped gradient, its
    norm, and the change from the start after the last step."""
    opt = c["optimizer"]
    b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
    lr, wd, clip = opt["lr"], opt["weight_decay"], opt["grad_clip"]
    w = {p: t.detach().float().clone().requires_grad_(True)
         for p, t in w0.items()}
    m = {p: torch.zeros_like(t) for p, t in w.items()}
    v = {p: torch.zeros_like(t) for p, t in w.items()}
    out = {"loss": [], "grad": {}, "grad1": {}, "change": {}}
    for step, (tokens, labels) in enumerate(batches, start=1):
        if keep_rows is not None:
            tokens, labels = tokens[:keep_rows], labels[:keep_rows]
        count = (labels != -100).sum().clamp(min=1).float()
        loss = 0.0
        for lo in range(0, tokens.shape[0], rows_per_block):
            rows = slice(lo, lo + rows_per_block)
            part = models.ce_sum(c, w, tokens[rows], labels[rows], mm) / count
            part.backward()
            loss += float(part.detach())
            del part
        out["loss"].append(loss)
        with torch.no_grad():
            grads = {p: t.grad for p, t in w.items()}
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for p, t in w.items():
                g = grads[p].mul_(scale)
                if step == 1:
                    out["grad"][p] = float(g.norm())
                    out["grad1"][p] = g.clone()
                m[p].mul_(b1).add_(g, alpha=1 - b1)
                v[p].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[p] / bc1) / (torch.sqrt(v[p] / bc2) + eps)
                if wd and decays(p):
                    upd = upd + wd * t
                t.sub_(lr * upd)
                t.grad = None
    with torch.no_grad():
        for p, t in w.items():
            out["change"][p] = t.detach() - w0[p].float()
    return out
