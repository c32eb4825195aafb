"""BERT — bidirectional encoder with a masked-LM head (the port of
``paddle_tpu/models/bert.py``).

Pre-LN blocks shared with GPT (``gpt_block`` through the engine's
``BertAdapter``, with bidirectional attention), token + position +
token-type embeddings with an embedding LayerNorm, and the canonical
MLM head: dense + GELU + LayerNorm, then logits through the TIED token
embedding.  Params are a nested dict with the JAX package's leaf names,
block params stacked ``[L, ...]``.

MLM contract: ``tokens`` are the corrupted input ids, ``labels`` the
original ids at masked positions and -100 elsewhere.  Token-type
embeddings exist in the params (``wtt``); the pretrain path feeds
segment 0 — pass ``token_type_ids`` for two-segment inputs.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .._device import resolve_device
from .gpt import _layer_norm, unbind_layers

__all__ = ["BertConfig", "bert_init", "bert_embed", "bert_mlm_transform",
           "bert_forward", "bert_loss", "BERT_CONFIGS"]


@dataclasses.dataclass(unsafe_hash=True)
class BertConfig:
    vocab_size: int = 30592          # multiple of 128
    max_seq_len: int = 512
    type_vocab_size: int = 2
    hidden: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: int = 3072
    dropout: float = 0.0
    dtype: str = "bfloat16"
    use_flash: bool = True
    remat: str = "dots"
    seq_parallel: str = "ulysses"
    # engine-protocol constants (the adapter contract): BERT has no MoE
    # and always ties the MLM vocab projection to wte
    moe_experts: int = 0
    tie_embeddings: bool = True

    @property
    def head_dim(self):
        return self.hidden // self.num_heads

    def torch_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


BERT_CONFIGS = {
    "bert-base": BertConfig(hidden=768, num_layers=12, num_heads=12,
                            ffn_hidden=3072),
    "bert-large": BertConfig(hidden=1024, num_layers=24, num_heads=16,
                             ffn_hidden=4096),
    "tiny": BertConfig(vocab_size=1024, max_seq_len=128, hidden=128,
                       num_layers=4, num_heads=4, ffn_hidden=512),
}


def bert_init(cfg: BertConfig, generator=None, device=None, dtype=None):
    """Random parameters with the JAX package's names, shapes and init
    stds (normal 0.02; ``wpe`` and ``wtt`` 0.01; residual projections
    0.02/sqrt(2L); LayerNorm gains 1, biases 0), drawn from
    ``generator`` on ``device`` (default CUDA; default generator seeded
    with 0).  The draws differ from ``jax.random``'s."""
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
    return {
        "wte": init((V, D)),
        "wpe": init((cfg.max_seq_len, D), 0.01),
        "wtt": init((cfg.type_vocab_size, D), 0.01),
        "emb_ln_g": ones(D), "emb_ln_b": zeros(D),
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
        "mlm_w": init((D, D)),
        "mlm_b": zeros(D),
        "mlm_ln_g": ones(D), "mlm_ln_b": zeros(D),
    }


def bert_embed(cfg: BertConfig, aux, tokens, token_type_ids=None,
               engine=None):
    """Token + position + token-type embedding, then the embedding LN.
    With ``engine`` the token and position lookup is the engine's
    (``_embed_core``: vocab-split over mp and the positions of the sep
    slice in a world)."""
    tokens = tokens.long()
    S = tokens.shape[1]
    if engine is not None:
        x = engine._embed_core(aux["wte"], aux["wpe"], tokens)
    else:
        x = (aux["wte"][tokens] + aux["wpe"][:S]).to(cfg.torch_dtype())
    tt = (torch.zeros_like(tokens) if token_type_ids is None
          else token_type_ids.long())
    # an embedding lookup, not an index: every token hits one of two
    # rows, and index's backward adds the duplicates of a row one by one
    x = x + F.embedding(tt, aux["wtt"]).to(x.dtype)
    return _layer_norm(x, aux["emb_ln_g"], aux["emb_ln_b"])


def bert_mlm_transform(cfg: BertConfig, aux, x):
    """The MLM head transform: dense + GELU + LN (before the tied vocab
    projection)."""
    h = x @ aux["mlm_w"] + aux["mlm_b"]
    h = F.gelu(h, approximate="tanh")
    return _layer_norm(h, aux["mlm_ln_g"], aux["mlm_ln_b"])


def _bert_block(cfg, bp, x):
    """One block of the standalone forward: bidirectional naive
    attention, no dropout, no remat (the JAX ``_bert_block_body``)."""
    from ..ops.attention import _naive_attention

    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    h = _layer_norm(x, bp["ln1_g"], bp["ln1_b"])
    qkv = (h @ bp["qkv_w"] + bp["qkv_b"]).view(B, S, H, 3, hd)
    q = qkv[:, :, :, 0].transpose(1, 2)
    k = qkv[:, :, :, 1].transpose(1, 2)
    v = qkv[:, :, :, 2].transpose(1, 2)
    attn = _naive_attention(q, k, v, causal=False, training=False)
    attn = attn.transpose(1, 2).reshape(B, S, D)
    x = x + attn @ bp["proj_w"] + bp["proj_b"]
    h = _layer_norm(x, bp["ln2_g"], bp["ln2_b"])
    h = F.gelu(h @ bp["up_w"] + bp["up_b"], approximate="tanh")
    return x + h @ bp["down_w"] + bp["down_b"]


def bert_forward(cfg: BertConfig, params, tokens, token_type_ids=None):
    """tokens ``[B, S]`` → final hidden states ``[B, S, D]`` (one device,
    bidirectional attention)."""
    x = bert_embed(cfg, params, tokens, token_type_ids)
    for bp in unbind_layers(params["blocks"]):
        x = _bert_block(cfg, bp, x)
    return x


def bert_loss(cfg: BertConfig, params, tokens, labels,
              token_type_ids=None):
    """Masked-LM cross entropy in fp32 over the -100-masked labels — the
    single-device parity oracle for ``BertAdapter``."""
    x = bert_forward(cfg, params, tokens, token_type_ids)
    x = bert_mlm_transform(cfg, params, x)
    logits = (x @ params["wte"].t()).float()
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels != -100).float()
    return -(picked * mask).sum() / mask.sum().clamp(min=1.0)
