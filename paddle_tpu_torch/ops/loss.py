"""Loss ops (the port of ``paddle_tpu/ops/loss.py``).

``cross_entropy`` takes class labels of shape ``[N]`` (the JAX package
raises for ``[N, 1]``; so does this), computes ``log_softmax`` in fp32,
and its ``mean`` over an ``ignore_index`` divides by the count of valid
labels, weighted when ``weight`` is given."""
from __future__ import annotations

import torch

from ..core.dispatch import register_op
from .nn_ops import _at_least_fp32

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_similarity", "square_error_cost", "sigmoid_focal_loss",
           "label_smooth", "ctc_loss"]


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


@register_op("cross_entropy")
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


@register_op("softmax_with_cross_entropy")
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


@register_op("nll_loss")
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


@register_op("mse_loss")
def mse_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.square(input - label), reduction)


@register_op("l1_loss")
def l1_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.abs(input - label), reduction)


@register_op("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):  # noqa: A002
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


@register_op("binary_cross_entropy")
def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, min=eps)) +
             (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@register_op("binary_cross_entropy_with_logits")
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


@register_op("kl_div")
def kl_div(input, label, reduction="mean"):  # noqa: A002
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@register_op("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean"):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0),
                   reduction)


@register_op("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean"):
    loss = torch.where(label == 1, input, torch.clamp(margin - input, min=0))
    return _reduce(loss, reduction)


@register_op("cosine_similarity")
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.clamp_min(torch.sum(x1 * x1, dim=axis), eps * eps))
    n2 = torch.sqrt(torch.clamp_min(torch.sum(x2 * x2, dim=axis), eps * eps))
    return dot / (n1 * n2)


@register_op("square_error_cost")
def square_error_cost(input, label):  # noqa: A002
    return torch.square(input - label)


@register_op("sigmoid_focal_loss")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    p = torch.sigmoid(logit)
    ce = ((1 - label) * logit + torch.log1p(torch.exp(-logit.abs()))
          + torch.clamp_min(-logit, 0))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@register_op("label_smooth")
def label_smooth(label, prior_dist=None, epsilon=0.1):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


_NEG = -1e30


def _lse(*xs):
    """logsumexp of the stacked terms, -1e30 ("log 0") where all are."""
    st = torch.stack(xs, 0)
    m = st.amax(0)
    safe = torch.where(m <= _NEG / 2, _NEG, m)
    out = safe + torch.log(torch.exp(st - safe).sum(0))
    return torch.where(m <= _NEG / 2, _NEG, out)


@register_op("ctc_loss")
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """Connectionist Temporal Classification loss (reference: warpctc_op;
    paddle.nn.functional.ctc_loss semantics), the JAX package's alpha
    recursion in log space over the extended-label lattice [B, 2S+1]: a
    Python loop over time (the JAX ``lax.scan``), length masks freezing
    each sample past its input length.

    log_probs [T, B, C] (log-softmaxed), labels [B, S], lengths [B].
    ``mean`` divides each sample by its label length, then averages."""
    lp = log_probs.float()
    lab = labels.long()
    T, B, C = lp.shape
    S = lab.shape[1]
    dev = lp.device
    in_len = torch.as_tensor(input_lengths, device=dev).long()
    lab_len = torch.as_tensor(label_lengths, device=dev).long()
    L = 2 * S + 1
    pos = torch.arange(L, device=dev)
    ext = torch.where(pos % 2 == 0, blank,
                      lab[:, torch.clamp_max(pos // 2, S - 1)])
    ext_len = 2 * lab_len + 1
    ext_m2 = torch.cat([torch.full((B, 2), blank, dtype=ext.dtype,
                                   device=dev), ext[:, :-2]], 1)
    can_skip = (pos[None, :] % 2 == 1) & (ext != ext_m2) & (pos[None, :] >= 2)
    neg1 = torch.full((B, 1), _NEG, device=dev)
    neg2 = torch.full((B, 2), _NEG, device=dev)
    first_lab = torch.gather(lp[0], 1, lab[:, :1])[:, 0]
    alpha = torch.cat([
        lp[0, :, blank][:, None],
        torch.where(lab_len > 0, first_lab, _NEG)[:, None],
        torch.full((B, L - 2), _NEG, device=dev)], 1)
    for t in range(1, T):
        prev1 = torch.cat([neg1, alpha[:, :-1]], 1)
        prev2 = torch.where(can_skip, torch.cat([neg2, alpha[:, :-2]], 1),
                            _NEG)
        a = _lse(alpha, prev1, prev2) + torch.gather(lp[t], 1, ext)
        alpha = torch.where((t < in_len)[:, None], a, alpha)
    last = torch.gather(alpha, 1, (ext_len - 1)[:, None])[:, 0]
    last2 = torch.gather(alpha, 1, torch.clamp_min(ext_len - 2, 0)[:, None])
    nll = -_lse(last, torch.where(lab_len > 0, last2[:, 0], _NEG))
    if norm_by_times:
        nll = nll / torch.clamp_min(in_len.float(), 1.0)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    return (nll / torch.clamp_min(lab_len.float(), 1.0)).mean()
