"""Attention ops — the naive softmax(Q Kᵀ)V route (the port of
``paddle_tpu/ops/attention.py::_naive_attention``).

``gpt_block`` and the engine take it when flash attention is unavailable
for the inputs or ``cfg.use_flash`` is False.  It is plain PyTorch and
runs on any device.
"""
from __future__ import annotations

import torch

__all__ = ["_naive_attention"]


def _naive_attention(q, k, v, mask=None, dropout_p=0.0, causal=False,
                     scale=None, training=True):
    """q, k, v ``[B, H, S, D]``.  Scores in fp32 (bf16 products are exact
    in fp32, as the JAX einsum's fp32 accumulation gives them); the
    causal mask is lower-triangular aligned to the last key
    (``tril(k=sk-sq)``); an additive ``mask`` is added after it; the
    probabilities are cast to q's dtype before the product with v.

    Attention dropout is not ported: the GPT path never uses it, and a
    positive ``dropout_p`` while training raises."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout is not ported (the GPT path runs without "
            "it); see ROADMAP.md")
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        logits = torch.where(keep, logits, -1e30)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
