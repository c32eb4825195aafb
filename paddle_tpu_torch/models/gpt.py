"""GPT decoder — the serving half of ``paddle_tpu/models/gpt.py`` in PyTorch.

Parameters are a plain nested dict of tensors with the JAX package's
leaf names and its stacked ``[L, ...]`` block layout, so a JAX
``gpt_init`` tree maps onto it one to one (``models/convert.py``).  The
layer loop is a Python loop over the leading axis where JAX runs a
``lax.scan``.

The serving half is ``gpt_ragged_step`` (the serving engine's one step);
the training half is ``gpt_block`` / ``gpt_forward`` / ``gpt_loss`` with
per-block activation checkpointing (``cfg.remat``) and the ``GPT``
module facade.  MoE blocks are a later slice of the port.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device

__all__ = ["GPTConfig", "GPT_CONFIGS", "GPT", "gpt_init", "gpt_block",
           "gpt_forward", "gpt_loss", "gpt_ragged_step", "gpt_num_params",
           "gpt_flops_per_token"]


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
            "MoE blocks are not ported yet; the port runs dense GPTs")


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


def _fold(seed, *ints):
    """A 63-bit seed from ``seed`` folded with ``ints`` (splitmix64
    rounds): the port's ``jax.random.fold_in`` for dropout seeds."""
    h = int(seed) & 0xFFFFFFFFFFFFFFFF
    for i in ints:
        h = (h ^ (int(i) & 0xFFFFFFFFFFFFFFFF)) + 0x9E3779B97F4A7C15
        h &= 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h >> 1


def _dropout(x, rate, seed):
    """Inverted dropout; identity when ``rate == 0`` or ``seed`` is None
    (eval).  The mask comes from a generator made here from the integer
    ``seed``, so a recompute under activation checkpointing draws the
    same mask; masks differ from ``jax.random``'s for equal seeds."""
    if rate <= 0.0 or seed is None:
        return x
    g = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _default_attention(cfg, q, k, v, causal=True):
    """Flash attention where its gate allows, else the naive route — the
    choice ``gpt_block`` makes in the JAX package."""
    if cfg.use_flash:
        from ..kernels.flash_attention import (flash_attention,
                                               flash_attention_available)

        if flash_attention_available(q, k, v, None, causal=causal):
            return flash_attention(q, k, v, causal=causal)
    from ..ops.attention import _naive_attention

    return _naive_attention(q, k, v, causal=causal, training=False)


def gpt_block(cfg: GPTConfig, bp, x, dropout_seed=None, attention=None,
              dropout=_dropout):
    """One pre-LN transformer block (attention + dense MLP) on
    ``x [B, S, D]``; ``bp`` is this layer's slice of the stacked block
    params.  Returns the new ``x`` (a dense block has no MoE aux loss).

    ``dropout_seed`` (an int) enables residual dropout on the attention
    projection and the FFN output, drawn by ``dropout(x, rate, seed)``
    (the engine's draws a mask per sequence shard).  ``attention(q, k,
    v)`` on ``[B, H, S, hd]`` replaces the causal attention call
    (default: flash attention where available, else the naive route) —
    the hook through which a caller runs the block on the plain version
    for comparison, and the engine its sequence-parallel attention."""
    _require_dense(cfg)
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    s_attn = s_ffn = None
    if dropout_seed is not None and cfg.dropout > 0.0:
        s_attn, s_ffn = _fold(dropout_seed, 1), _fold(dropout_seed, 2)

    h = _layer_norm(x, bp["ln1_g"], bp["ln1_b"])
    qkv = h @ bp["qkv_w"] + bp["qkv_b"]
    # qkv columns are head-major [H, 3, hd]
    qkv = qkv.view(B, S, H, 3, hd)
    q = qkv[:, :, :, 0].transpose(1, 2)
    k = qkv[:, :, :, 1].transpose(1, 2)
    v = qkv[:, :, :, 2].transpose(1, 2)
    if attention is None:
        attn = _default_attention(cfg, q, k, v)
    else:
        attn = attention(q, k, v)
    attn = attn.transpose(1, 2).reshape(B, S, D)
    proj = attn @ bp["proj_w"] + bp["proj_b"]
    x = x + dropout(proj, cfg.dropout, s_attn)

    h = _layer_norm(x, bp["ln2_g"], bp["ln2_b"])
    h = h @ bp["up_w"] + bp["up_b"]
    h = F.gelu(h, approximate="tanh")
    h = h @ bp["down_w"] + bp["down_b"]
    return x + dropout(h, cfg.dropout, s_ffn)


def unbind_layers(blocks):
    """Stacked ``[L, ...]`` block leaves → one dict per layer, taken
    apart once with ``unbind(0)``: its backward stacks the per-layer
    grads once, where indexing ``blocks[k][l]`` per layer would add a
    full ``[L, ...]`` zero gradient for every layer."""
    cols = {k: v.unbind(0) for k, v in blocks.items()}
    L = len(next(iter(cols.values())))
    return [{k: c[l] for k, c in cols.items()} for l in range(L)]


def run_blocks(block_fn, blocks, x, remat="nothing", dropout_seed=None):
    """Apply ``block_fn(bp, x, seed) -> x`` over the stacked blocks, each
    under the ``remat`` checkpoint policy; the loop the JAX package runs
    as a ``lax.scan``.  Layer ``l``'s dropout seed is ``dropout_seed``
    folded with ``l``."""
    from ..distributed.recompute import checkpoint_policy

    fn = checkpoint_policy(remat)(block_fn)
    for l, bp in enumerate(unbind_layers(blocks)):
        x = fn(bp, x, None if dropout_seed is None
               else _fold(dropout_seed, l))
    return x


def gpt_forward(cfg: GPTConfig, params, tokens, *, dropout_seed=None,
                attention=None):
    """tokens ``[B, S]`` → logits ``[B, S, V]`` in the working dtype.
    Blocks run in a Python loop, each under ``cfg.remat``'s checkpoint
    policy.  ``dropout_seed`` (training only) drives embedding and
    residual dropout; ``attention`` is ``gpt_block``'s hook."""
    _require_dense(cfg)
    B, S = tokens.shape
    tokens = tokens.long()
    x = params["wte"][tokens] + params["wpe"][:S]
    x = x.to(cfg.torch_dtype())
    layers_seed = None
    if dropout_seed is not None and cfg.dropout > 0.0:
        x = _dropout(x, cfg.dropout, _fold(dropout_seed, 0, 0))
        layers_seed = _fold(dropout_seed, 0, 1)

    def block_fn(bp, x, seed):
        return gpt_block(cfg, bp, x, dropout_seed=seed, attention=attention)

    x = run_blocks(block_fn, params["blocks"], x, cfg.remat, layers_seed)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
    if cfg.tie_embeddings:
        return x @ params["wte"].t()
    return x @ params["lm_head"]


def gpt_loss(cfg: GPTConfig, params, tokens, labels=None,
             dropout_seed=None, attention=None):
    """Next-token cross entropy in fp32: log-softmax over fp32 logits,
    labels of -100 ignored, mean over the counted tokens."""
    tokens = tokens.long()
    if labels is None:
        labels = F.pad(tokens[:, 1:], (0, 1), value=-100)
    labels = labels.long()
    logits = gpt_forward(cfg, params, tokens, dropout_seed=dropout_seed,
                         attention=attention)
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels != -100).float()
    return -(picked * mask).sum() / mask.sum().clamp(min=1.0)


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


def gpt_num_params(cfg: GPTConfig):
    D, F_, L, V = cfg.hidden, cfg.ffn_hidden, cfg.num_layers, cfg.vocab_size
    attn_part = 4 * D + D * 3 * D + 3 * D + D * D + D
    if cfg.moe_experts:
        E = cfg.moe_experts
        ffn_part = D * E + E * (D * F_ + F_ + F_ * D + D)
    else:
        ffn_part = D * F_ + F_ + F_ * D + D
    n = V * D + cfg.max_seq_len * D + L * (attn_part + ffn_part) + 2 * D
    if not cfg.tie_embeddings:
        n += D * V
    return n


def gpt_flops_per_token(cfg: GPTConfig, seq_len):
    """Training FLOPs/token ≈ 6*N + attention term (per Chinchilla
    appendix)."""
    n = gpt_num_params(cfg)
    attn = 6 * cfg.num_layers * cfg.hidden * seq_len  # fwd+bwd qk/av
    return 6 * n + 2 * attn


# ----------------------------------------------------------- module facade


def _flat_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_items(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


class GPT(nn.Module):
    """``nn.Module`` facade over the functional model.  Its parameters
    are the leaves of a ``gpt_init`` tree, registered under the JAX
    facade's flat names (``blocks_qkv_w``); ``params()`` hands the same
    tensors back as the nested dict the functions take."""

    def __init__(self, config: GPTConfig = None, generator=None,
                 device=None, dtype=None, **kwargs):
        super().__init__()
        if config is None:
            config = GPTConfig(**kwargs)
        self.config = config
        raw = gpt_init(config, generator=generator, device=device,
                       dtype=dtype)
        self._paths = []
        for path, t in _flat_items(raw):
            self._paths.append(path)
            self.register_parameter(path.replace("/", "_"),
                                    nn.Parameter(t))

    def params(self):
        tree = {}
        for path in self._paths:
            *parents, leaf = path.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = getattr(self, path.replace("/", "_"))
        return tree

    def forward(self, tokens, labels=None, dropout_seed=None):
        """Logits, or the loss when ``labels`` are given."""
        if labels is None:
            return gpt_forward(self.config, self.params(), tokens,
                               dropout_seed=dropout_seed)
        return gpt_loss(self.config, self.params(), tokens, labels,
                        dropout_seed=dropout_seed)
