"""Loss ops (the port of ``paddle_tpu/ops/loss.py``).

``cross_entropy`` takes class labels of shape ``[N]`` (the JAX package
raises for ``[N, 1]``; so does this), computes ``log_softmax`` in fp32,
and its ``mean`` over an ``ignore_index`` divides by the count of valid
labels, weighted when ``weight`` is given."""
from __future__ import annotations

import torch

from ..amp.auto_cast import amp_op
from .nn_ops import _at_least_fp32

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _pick(logp, label, axis):
    """``take_along_axis(logp, label[..., None])`` along ``axis``; the
    label must have logp's rank less one, as ``jnp.take_along_axis``
    requires."""
    if label.dim() != logp.dim() - 1:
        raise ValueError(
            f"label of shape {tuple(label.shape)} does not index logits of "
            f"shape {tuple(logp.shape)} along axis {axis}")
    idx = torch.clamp(label, min=0).unsqueeze(axis)
    return torch.gather(logp, axis, idx).squeeze(axis)


@amp_op("cross_entropy")
def cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                  reduction="mean", axis=-1, weight=None, use_softmax=True):
    axis = axis % logits.dim()
    if use_softmax:
        logp = torch.log_softmax(_at_least_fp32(logits), dim=axis)
    else:
        logp = torch.log(torch.clamp(_at_least_fp32(logits), min=1e-30))
    if soft_label:
        if weight is not None:
            logp = logp * weight    # broadcast over the last axis, as JAX
        return _reduce(-(label * logp).sum(dim=axis), reduction)
    label = label.long()
    loss = -_pick(logp, label, axis)
    valid = label != ignore_index
    loss = torch.where(valid, loss, 0.0)
    if weight is not None:
        w = torch.where(valid, weight[torch.clamp(label, min=0)], 0.0)
        loss = loss * w
    if reduction == "mean":
        if weight is not None:
            denom = torch.clamp(w.sum(), min=1e-12)
        else:
            denom = torch.clamp(valid.float().sum(), min=1.0)
        return loss.sum() / denom
    return _reduce(loss, reduction)


@amp_op("softmax_with_cross_entropy")
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    axis = axis % logits.dim()
    logp = torch.log_softmax(_at_least_fp32(logits), dim=axis)
    if soft_label:
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        lbl = label.long()
        if lbl.dim() == logits.dim():
            lbl = lbl.squeeze(axis)
        loss = -_pick(logp, lbl, axis).unsqueeze(axis)
        loss = torch.where(lbl.unsqueeze(axis) != ignore_index, loss, 0.0)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


@amp_op("nll_loss")
def nll_loss(log_prob, label, weight=None, ignore_index=-100,
             reduction="mean"):
    label = label.long()
    loss = -_pick(log_prob, label, -1 % log_prob.dim())
    valid = label != ignore_index
    loss = torch.where(valid, loss, 0.0)
    if weight is not None:
        loss = loss * weight[torch.clamp(label, min=0)]
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.float().sum(), min=1.0)
    return _reduce(loss, reduction)


@amp_op("mse_loss")
def mse_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.square(input - label), reduction)


@amp_op("l1_loss")
def l1_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.abs(input - label), reduction)


@amp_op("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):  # noqa: A002
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


@amp_op("binary_cross_entropy")
def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, min=eps)) +
             (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@amp_op("binary_cross_entropy_with_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    max_val = torch.clamp(-logit, min=0)
    soft = torch.log1p(torch.exp(-logit.abs()))
    if pos_weight is not None:
        log_w = (pos_weight - 1) * label + 1
        loss = (1 - label) * logit + log_w * (soft + max_val)
    else:
        loss = (1 - label) * logit + soft + max_val
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@amp_op("kl_div")
def kl_div(input, label, reduction="mean"):  # noqa: A002
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@amp_op("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean"):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0),
                   reduction)


@amp_op("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean"):
    loss = torch.where(label == 1, input, torch.clamp(margin - input, min=0))
    return _reduce(loss, reduction)
