"""GPT decoder — the serving half of ``paddle_tpu/models/gpt.py`` in PyTorch.

Parameters are a plain nested dict of tensors with the JAX package's
leaf names and its stacked ``[L, ...]`` block layout, so a JAX
``gpt_init`` tree maps onto it one to one (``models/convert.py``).  The
layer loop is a Python loop over the leading axis where JAX runs a
``lax.scan``.

This slice carries the config, ``gpt_init`` and ``gpt_ragged_step`` (the
serving engine's one step); the training forward and loss, and the MoE
blocks, are later slices of the port.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .._device import resolve_device

__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_init", "gpt_ragged_step"]


@dataclasses.dataclass(unsafe_hash=True)
class GPTConfig:
    vocab_size: int = 50304          # multiple of 128 for MXU/TP tiling
    max_seq_len: int = 1024
    hidden: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: int = 3072
    dropout: float = 0.0
    dtype: str = "bfloat16"
    use_flash: bool = True
    remat: str = "dots"              # per-block checkpoint policy
    tie_embeddings: bool = True
    # sequence parallelism flavor when the engine's sep axis > 1:
    #   "ulysses" — all_to_all head-scatter (caps sep at local head count)
    #   "ring"    — ring attention, KV blocks rotate between devices
    seq_parallel: str = "ulysses"
    # MoE (Mixtral-style): >0 replaces every block's dense FFN with a
    # moe_experts-expert MoE of the same per-expert hidden (ffn_hidden)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self):
        return self.hidden // self.num_heads

    def torch_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


GPT_CONFIGS = {
    # reference benchmark family (BASELINE.json configs)
    "gpt2-small": GPTConfig(hidden=768, num_layers=12, num_heads=12,
                            ffn_hidden=3072),
    "gpt2-medium": GPTConfig(hidden=1024, num_layers=24, num_heads=16,
                             ffn_hidden=4096),
    "gpt2-large": GPTConfig(hidden=1280, num_layers=36, num_heads=20,
                            ffn_hidden=5120),
    "gpt3-1.3b": GPTConfig(hidden=2048, num_layers=24, num_heads=16,
                           ffn_hidden=8192, max_seq_len=2048),
    "gpt3-6.7b": GPTConfig(hidden=4096, num_layers=32, num_heads=32,
                           ffn_hidden=16384, max_seq_len=2048),
    "tiny": GPTConfig(vocab_size=1024, max_seq_len=128, hidden=128,
                      num_layers=4, num_heads=4, ffn_hidden=512),
}


def _require_dense(cfg: GPTConfig):
    if cfg.moe_experts:
        raise NotImplementedError(
            "MoE blocks are not ported yet; this slice serves dense GPTs")


# ------------------------------------------------------------------ params


def gpt_init(cfg: GPTConfig, generator=None, device=None, dtype=None):
    """Random parameters with the JAX package's names, shapes and init
    stds (normal 0.02, wpe 0.01, residual projections 0.02/sqrt(2L);
    LayerNorm gains 1, biases 0).  Block params are stacked on axis 0.

    ``generator`` is a ``torch.Generator`` on ``device`` (default: one
    seeded with 0).  The draws differ from ``jax.random``'s for the same
    seed; tests that compare with JAX carry the JAX tree across instead
    (``params_from_jax``)."""
    _require_dense(cfg)
    dev = resolve_device(device)
    dt = dtype or cfg.torch_dtype()
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    D, F_, L, V = cfg.hidden, cfg.ffn_hidden, cfg.num_layers, cfg.vocab_size

    def init(shape, std=0.02):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return w.mul_(std).to(dt)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dt)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dt)

    resid_std = 0.02 / math.sqrt(2 * L)
    params = {
        "wte": init((V, D)),
        "wpe": init((cfg.max_seq_len, D), 0.01),
        "blocks": {
            "ln1_g": ones(L, D), "ln1_b": zeros(L, D),
            "qkv_w": init((L, D, 3 * D)),
            "qkv_b": zeros(L, 3 * D),
            "proj_w": init((L, D, D), resid_std),
            "proj_b": zeros(L, D),
            "ln2_g": ones(L, D), "ln2_b": zeros(L, D),
            "up_w": init((L, D, F_)),
            "up_b": zeros(L, F_),
            "down_w": init((L, F_, D), resid_std),
            "down_b": zeros(L, D),
        },
        "lnf_g": ones(D), "lnf_b": zeros(D),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init((D, V))
    return params


# ----------------------------------------------------------------- forward


def _layer_norm(x, g, b, eps=1e-5):
    """Normalise in fp32, cast back, then ``* g + b`` in the working
    dtype — the JAX package's rounding points."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


# ----------------------------------------------- KV-cache ragged step


@torch.no_grad()
def gpt_ragged_step(cfg: GPTConfig, params, tokens, row_of_token,
                    slot_of_token, query_lens, context_lens, k_pages,
                    v_pages, page_tables, *, max_q=None, attention=None):
    """Unified ragged step over the paged KV cache — one call advances
    every scheduled row, whether it is a prompt chunk or a decode token.

    Packing contract (as in the JAX package): ``tokens`` [T] holds every
    scheduled query token, row-major (row b's ``query_lens[b]`` tokens
    are contiguous and in order; rows packed in ascending batch-slot
    order).  ``row_of_token`` [T] names each token's batch row (== B for
    padding slots); ``slot_of_token`` [T] is the token's index within its
    row's chunk.  ``context_lens`` [B] counts the row's tokens *including*
    this chunk, so token t of row b sits at absolute position
    ``context_lens[b] - query_lens[b] + t``.  ``max_q`` bounds any single
    row's chunk — the padded query width of the attention call.

    ``k_pages``/``v_pages`` [L, P, page_size, H, hd] are updated **in
    place** (``index_put_``), where the JAX step returns new arrays; they
    are returned as well so the call reads like its counterpart.  JAX
    drops out-of-bounds scatter indices (``mode="drop"``) while torch
    raises on them, so padding and invalid tokens are masked out before
    every scatter: they write no page and no query slot.

    ``attention`` replaces the attention call (default: the ragged
    paged-attention kernel's wrapper) — the hook through which a caller
    runs the same step on the plain version for comparison.

    Returns (logits [B, V] at each row's last packed token — rows with
    query_len 0 return garbage the engine ignores — k_pages, v_pages)."""
    _require_dense(cfg)
    if attention is None:
        from ..kernels.paged_attention import ragged_paged_attention

        attention = ragged_paged_attention
    T = tokens.shape[0]
    B = query_lens.shape[0]
    H, hd, D = cfg.num_heads, cfg.head_dim, cfg.hidden
    page_size = k_pages.shape[2]
    Q = max_q or T
    L = k_pages.shape[0]

    tokens = tokens.long()
    row_of_token = row_of_token.long()
    slot_of_token = slot_of_token.long()
    qlens = query_lens.long()
    start = context_lens.long() - qlens

    row_c = row_of_token.clamp(max=B - 1)
    valid = (row_of_token < B) & (slot_of_token < qlens[row_c])
    pos = (start[row_c] + slot_of_token).clamp(0, cfg.max_seq_len - 1)

    x = params["wte"][tokens] + params["wpe"][pos]
    x = x.to(cfg.torch_dtype())                                    # [T, D]

    # scatter targets of the valid tokens only, computed once per step
    # (one host sync for the nonzero; no per-layer sync)
    vidx = valid.nonzero().squeeze(1)
    v_row = row_c[vidx]
    v_slot = slot_of_token[vidx]
    v_pos = pos[vidx]
    v_page = page_tables.long()[
        v_row, (v_pos // page_size).clamp(max=page_tables.shape[1] - 1)]
    v_in_page = v_pos % page_size
    gather_slot = slot_of_token.clamp(max=Q - 1)

    blocks = params["blocks"]
    for l in range(L):
        h = _layer_norm(x, blocks["ln1_g"][l], blocks["ln1_b"][l])
        qkv = h @ blocks["qkv_w"][l] + blocks["qkv_b"][l]
        # qkv columns are head-major [H, 3, hd]
        qkv = qkv.view(T, H, 3, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # [T, H, hd]
        kp, vp = k_pages[l], v_pages[l]
        kp.index_put_((v_page, v_in_page), k[vidx].to(kp.dtype))
        vp.index_put_((v_page, v_in_page), v[vidx].to(vp.dtype))
        # the attention call wants per-row padded queries; scatter the
        # valid packed tokens out, gather the outputs back flat (padding
        # tokens read a slot whose result never reaches pages or logits)
        q_pad = q.new_zeros((B, Q, H, hd))
        q_pad[v_row, v_slot] = q[vidx]
        attn = attention(q_pad, kp, vp, page_tables, query_lens,
                         context_lens)
        attn = attn[row_c, gather_slot].reshape(T, D).to(x.dtype)
        x = x + attn @ blocks["proj_w"][l] + blocks["proj_b"][l]

        h = _layer_norm(x, blocks["ln2_g"][l], blocks["ln2_b"][l])
        h = h @ blocks["up_w"][l] + blocks["up_b"][l]
        h = F.gelu(h, approximate="tanh")
        x = x + (h @ blocks["down_w"][l] + blocks["down_b"][l])

    x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
    # row b's last packed token sits at cumsum(query_lens)[b] - 1
    last = (torch.cumsum(qlens, 0) - 1).clamp(0, T - 1)
    x_last = x[last]                                               # [B, D]
    if cfg.tie_embeddings:
        logits = x_last @ params["wte"].t()
    else:
        logits = x_last @ params["lm_head"]
    return logits, k_pages, v_pages
