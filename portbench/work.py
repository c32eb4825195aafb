"""The benchmark's own yardstick: published peaks of the card and the
operations and bytes a piece of work needs, computed from shapes.

Nothing here reads the program.  The counts follow the conventions the
per-layer metrics state: a kernel's roofline counts every input byte
read once and every output byte written once, and the products its
inputs need (causal pairs only where the call is causal); a step's
model FLOPs count each parameter's matmul work and attention at the
shapes the step runs, with recompute not counted.
"""
from __future__ import annotations

#: NVIDIA H100 SXM, dense rates without sparsity, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def roofline_s(flops, nbytes):
    """(least seconds the card needs, which bound binds)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_work(B, H, S, D, causal, nbytes_el=2):
    """(bytes, FLOPs) of one flash call on ``[B, H, S, D]`` inputs.

    Forward: q, k, v in, out and the fp32 row logsumexp out; two products
    (Q·Kᵀ and P·V: 4·D FLOPs a live pair).  Backward: q, k, v, dO, the
    fp32 lse and δ in, dq, dk, dv out; five products (S, dP, dV, dK, dQ:
    10·D FLOPs a live pair).  A pair is live when k ≤ q under a causal
    mask."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    mat = B * H * S * D * nbytes_el
    rows = B * H * S * 4
    return {"fwd": (4 * mat + rows, 4 * D * pairs),
            "bwd": (7 * mat + 2 * rows, 10 * D * pairs)}


def block_matmul_params(c):
    """Weights of one transformer block that enter a matmul."""
    D, F = c["hidden"], c["ffn_hidden"]
    return 3 * D * D + D * D + 2 * D * F


def gpt_params(c):
    """Every parameter of the GPT decoder (tied head counted once)."""
    D, F, L = c["hidden"], c["ffn_hidden"], c["num_layers"]
    block = 4 * D + 3 * D * D + 3 * D + D * D + D + D * F + F + F * D + D
    return c["vocab_size"] * D + c["max_seq_len"] * D + L * block + 2 * D


def bert_params(c):
    """Every parameter of the BERT encoder with its MLM head."""
    D, F, L = c["hidden"], c["ffn_hidden"], c["num_layers"]
    block = 4 * D + 3 * D * D + 3 * D + D * D + D + D * F + F + F * D + D
    emb = (c["vocab_size"] + c["max_seq_len"] + c["type_vocab_size"]) * D
    return emb + 2 * D + L * block + D * D + D + 2 * D


def train_flops_per_token(c, seq_len):
    """6·N + 12·L·D·S: a training token's model FLOPs (forward and
    backward of every parameter, and the attention products over the
    full S × S square), recompute not counted."""
    n = gpt_params(c) if c["family"] == "gpt" else bert_params(c)
    return 6 * n + 12 * c["num_layers"] * c["hidden"] * seq_len


def serve_step_flops(c, rows):
    """Forward FLOPs of one serving step over ``rows``: ``(q, ctx, ...)``
    per scheduled row, ``q`` query tokens ending at context length
    ``ctx``.
    Each computed token does the blocks' matmuls and attends to every
    position up to its own (4·D FLOPs a key a layer); each row computes
    the logits of its last token against the tied vocabulary."""
    D, L, V = c["hidden"], c["num_layers"], c["vocab_size"]
    per_token = 2 * L * block_matmul_params(c)
    total = 0
    for q, ctx, *_ in rows:
        start = ctx - q
        keys = q * start + q * (q + 1) // 2
        total += q * per_token + 4 * L * D * keys + 2 * D * V
    return total


def paged_attention_work(c, rows, nbytes_el=2):
    """(bytes, FLOPs) the ragged paged-attention calls of one serving step
    need over all layers: each row's ``ctx`` cached keys and values read
    once, its ``q`` queries read and ``q`` outputs written, and the two
    products over the live (query, key) pairs."""
    D, L = c["hidden"], c["num_layers"]
    nbytes = flops = 0
    for q, ctx, *_ in rows:
        start = ctx - q
        nbytes += (2 * ctx + 2 * q) * D * nbytes_el
        flops += 4 * D * (q * start + q * (q + 1) // 2)
    return L * nbytes, L * flops
