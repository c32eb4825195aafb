"""Search and sort ops (the port of ``paddle_tpu/ops/search.py``; parity:
python/paddle/tensor/search.py), and beam search.  Orders follow the
JAX package: a descending sort or argsort is the stable ascending one
reversed (ties come out last index first); ``topk`` is ``lax.top_k``'s
(values sorted, ties lowest index first); ``mode`` is ``scipy.stats.
mode``'s (the smallest most frequent value, and its count)."""
from __future__ import annotations

import torch

from ..core.dispatch import register_op

__all__ = ["sort", "argsort", "topk", "kthvalue", "mode", "searchsorted",
           "index_of_max", "bucketize", "beam_search_step", "beam_search"]


@register_op("sort")
def sort(x, axis=-1, descending=False):
    out = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(out, [axis]) if descending else out


@register_op("argsort", differentiable=False)
def argsort(x, axis=-1, descending=False):
    idx = torch.sort(x, dim=axis, stable=True).indices
    return torch.flip(idx, [axis]) if descending else idx


@register_op("topk")
def topk(x, k, axis=-1, largest=True, sorted=True):  # noqa: A002
    xm = torch.movedim(x, axis, -1)
    # stable sort of -x: the k largest, ties by the lowest index first
    order = torch.sort(-xm if largest else xm, dim=-1, stable=True).indices
    idx = order[..., :k]
    vals = torch.gather(xm, -1, idx)
    return torch.movedim(vals, -1, axis), torch.movedim(idx, -1, axis)


@register_op("kthvalue")
def kthvalue(x, k, axis=-1, keepdim=False):
    s = torch.sort(x, dim=axis, stable=True)
    vals = s.values.select(axis, k - 1)
    idx = s.indices.select(axis, k - 1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


@register_op("mode")
def mode(x, axis=-1, keepdim=False):
    xm = torch.movedim(x, axis, -1)
    s = torch.sort(xm, dim=-1).values
    counts = (s.unsqueeze(-1) == s.unsqueeze(-2)).sum(-1)
    first = torch.argmax((counts == counts.amax(-1, keepdim=True))
                         .to(torch.int8), dim=-1, keepdim=True)
    vals = torch.gather(s, -1, first)
    cnt = torch.gather(counts, -1, first)
    if not keepdim:
        return vals.squeeze(-1), cnt.squeeze(-1)
    return torch.movedim(vals, -1, axis), torch.movedim(cnt, -1, axis)


@register_op("searchsorted", differentiable=False)
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, values, right=right,
                              out_int32=out_int32)


@register_op("index_of_max", differentiable=False)
def index_of_max(x):
    return torch.argmax(x)


@register_op("bucketize", differentiable=False)
def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, x, right=right,
                              out_int32=out_int32)


def beam_search_step(pre_scores, log_probs, beam_size, end_id,
                     finished=None):
    """One beam expansion (reference role:
    paddle/fluid/operators/beam_search_op.cc): combine accumulated beam
    scores [B, K] with next-token log-probs [B, K, V], take the global
    top-``beam_size`` over K*V, and return (token [B, beam_size], parent,
    scores, finished).  Finished beams are frozen: their only expansion
    is ``end_id`` at an unchanged score."""
    B, K, V = log_probs.shape
    if finished is None:
        finished = torch.zeros((B, K), dtype=torch.bool,
                               device=log_probs.device)
    frozen = torch.full((V,), float("-inf"), dtype=log_probs.dtype,
                        device=log_probs.device)
    frozen[end_id] = 0.0
    lp = torch.where(finished[..., None], frozen, log_probs)
    total = pre_scores[..., None] + lp
    top, idx = topk(total.reshape(B, K * V), int(beam_size))
    parent = idx // V
    token = idx % V
    new_fin = torch.gather(finished, 1, parent) | (token == end_id)
    return token, parent, top, new_fin


def beam_search(step_fn, bos_id, end_id, beam_size, max_len, batch_size=1,
                vocab_size=None, length_penalty=0.0, device=None):
    """Full beam-search decode (reference role: beam_search +
    beam_search_decode_op.cc backtrace).  ``step_fn(history, t) ->
    log_probs``: history [B, K, max_len+1] int32 token ids (prefix valid
    through position t), returns [B, K, V] next-token log-probs.  The
    history is re-gathered by parent every step, so no backtrace pass is
    needed.  A Python loop over the steps (the JAX package's ``lax.scan``).

    Returns (sequences [B, K, max_len+1], scores [B, K]) sorted
    best-first; positions past a beam's end_id are end_id."""
    from ..core.place import current_device

    dev = current_device() if device is None else torch.device(device)
    B, K = batch_size, beam_size
    hist = torch.full((B, K, max_len + 1), end_id, dtype=torch.int32,
                      device=dev)
    hist[:, :, 0] = bos_id
    # only beam 0 starts live: identical beams would duplicate the top-K
    scores = torch.where(torch.arange(K, device=dev)[None, :] == 0, 0.0,
                         float("-inf")).expand(B, K).to(torch.float32)
    fin = torch.zeros((B, K), dtype=torch.bool, device=dev)
    for t in range(max_len):
        lp = step_fn(hist, t)
        token, parent, scores, fin = beam_search_step(scores, lp, K,
                                                      end_id, fin)
        hist = torch.gather(hist, 1, parent[..., None].expand_as(hist))
        hist = hist.clone()
        hist[:, :, t + 1] = token.to(hist.dtype)
    if length_penalty:
        lengths = (hist != end_id).sum(-1).to(torch.float32)
        scores = scores / torch.pow(lengths, length_penalty)
        order = torch.sort(-scores, dim=1, stable=True).indices
        hist = torch.gather(hist, 1, order[..., None].expand_as(hist))
        scores = torch.gather(scores, 1, order)
    return hist, scores
