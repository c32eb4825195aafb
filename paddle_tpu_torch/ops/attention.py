"""Attention ops (the port of ``paddle_tpu/ops/attention.py``).

``scaled_dot_product_attention`` routes to the port's flash attention
(hand-written CUDA kernels on the card, their plain versions on the CPU)
when ``flash_attention_available`` holds and no dropout is drawn, as the
JAX op routes to its Pallas kernel; otherwise it takes
``_naive_attention``, the softmax(Q Kᵀ)V route that ``gpt_block`` and the
engine also take when flash is unavailable or ``cfg.use_flash`` is off.
"""
from __future__ import annotations

import torch

from ..core.dispatch import register_op
from ..core.random import generator

__all__ = ["_naive_attention", "scaled_dot_product_attention"]


def _naive_attention(q, k, v, mask=None, dropout_p=0.0, causal=False,
                     scale=None, training=True):
    """q, k, v ``[B, H, S, D]``.  Scores in fp32 (bf16 products are exact
    in fp32, as the JAX einsum's fp32 accumulation gives them); the
    causal mask is lower-triangular aligned to the last key
    (``tril(k=sk-sq)``); an additive ``mask`` is added after it; the
    probabilities are cast to q's dtype before the product with v.

    Attention dropout (``dropout_p > 0`` while training) keeps each
    probability with chance 1 − p, by a mask drawn from the port's
    generator of q's device, and divides the kept ones by 1 − p."""
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
    if dropout_p > 0.0 and training:
        keep = 1.0 - dropout_p
        drop = torch.rand(probs.shape, generator=generator(q.device),
                          device=q.device) < keep
        probs = torch.where(drop, probs / keep, 0.0).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


@register_op("scaled_dot_product_attention")
def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, scale=None, training=True,
                                 use_flash=True):
    """q/k/v ``[batch, heads, seq, head_dim]``.  Attention dropout forces
    the naive route (the flash kernels are dropout-free, as in JAX)."""
    if use_flash and (dropout_p == 0.0 or not training):
        from ..kernels.flash_attention import (flash_attention,
                                               flash_attention_available)

        if flash_attention_available(q, k, v, attn_mask, causal=is_causal):
            return flash_attention(q, k, v, causal=is_causal, scale=scale)
    return _naive_attention(q, k, v, mask=attn_mask, dropout_p=dropout_p,
                            causal=is_causal, scale=scale, training=training)
