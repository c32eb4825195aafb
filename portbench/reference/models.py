"""Plain references of the benchmark's model families, in float32.

Written from the published descriptions in plain PyTorch, with no
kernel, cache or batching of any program: GPT (Radford et al. 2019;
Brown et al. 2020: pre-LN decoder, learned positions, tanh GELU, tied
output embedding) and BERT (Devlin et al. 2018: bidirectional encoder,
token-type embeddings and an embedding LayerNorm, MLM head of dense,
GELU and LayerNorm before the tied output embedding).  Departures from
the papers, shared with the layout the benchmark's weights follow:
LayerNorm comes before each sublayer in BERT as in GPT (pre-LN), and the
qkv projection's columns are head-major ``[H, 3, hd]``.

Weights are a flat dict ``path -> tensor`` (``weights.leaves``), block
leaves stacked ``[L, ...]``.  Every product goes through ``matmul(a,
b)``: plain ``a @ b`` here, and the lower-precision control of
``lowp.py`` in its place.  Call ``exact_fp32()`` first on the card, where
float32 products would otherwise be allowed to run in TF32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def exact_fp32():
    """float32 products in float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def matmul(a, b):
    return a @ b


def layer_norm(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def attention(q, k, v, causal, mm):
    """softmax(q·kᵀ/√hd) v on ``[B, H, S, hd]``."""
    S = q.shape[-2]
    s = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return mm(torch.softmax(s, dim=-1), v)


def block(c, bp, x, causal, mm):
    """One pre-LN block on ``x [B, S, D]``; ``bp`` this layer's leaves."""
    B, S, D = x.shape
    H = c["num_heads"]
    hd = D // H
    h = layer_norm(x, bp["ln1_g"], bp["ln1_b"])
    qkv = (mm(h, bp["qkv_w"]) + bp["qkv_b"]).view(B, S, H, 3, hd)
    q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
    a = attention(q, k, v, causal, mm).transpose(1, 2).reshape(B, S, D)
    x = x + mm(a, bp["proj_w"]) + bp["proj_b"]
    h = layer_norm(x, bp["ln2_g"], bp["ln2_b"])
    h = F.gelu(mm(h, bp["up_w"]) + bp["up_b"], approximate="tanh")
    return x + mm(h, bp["down_w"]) + bp["down_b"]


def layers(w):
    """One dict of leaves per layer, the stacked leaves taken apart once."""
    cols = {k[len("blocks/"):]: v.unbind(0) for k, v in w.items()
            if k.startswith("blocks/")}
    n = len(next(iter(cols.values())))
    return [{k: col[l] for k, col in cols.items()} for l in range(n)]


def gpt_hidden(c, w, tokens, mm=matmul):
    """Final hidden states ``[B, S, D]`` of the decoder (after the final
    LayerNorm) on ``tokens [B, S]``."""
    S = tokens.shape[1]
    x = w["wte"][tokens] + w["wpe"][:S]
    for bp in layers(w):
        x = block(c, bp, x, True, mm)
    return layer_norm(x, w["lnf_g"], w["lnf_b"])


def bert_hidden(c, w, tokens, mm=matmul):
    """MLM-transformed hidden states ``[B, S, D]`` of the encoder on
    ``tokens [B, S]`` (segment 0 throughout)."""
    S = tokens.shape[1]
    x = w["wte"][tokens] + w["wpe"][:S] + w["wtt"][0]
    x = layer_norm(x, w["emb_ln_g"], w["emb_ln_b"])
    for bp in layers(w):
        x = block(c, bp, x, False, mm)
    h = F.gelu(mm(x, w["mlm_w"]) + w["mlm_b"], approximate="tanh")
    return layer_norm(h, w["mlm_ln_g"], w["mlm_ln_b"])


HIDDEN = {"gpt": gpt_hidden, "bert": bert_hidden}


def ce_sum(c, w, tokens, labels, mm=matmul):
    """Summed cross entropy over the labels that are not -100, in float32,
    against the tied output embedding."""
    x = HIDDEN[c["family"]](c, w, tokens, mm)
    logits = mm(x, w["wte"].t())
    logp = torch.log_softmax(logits, dim=-1)
    keep = labels != -100
    picked = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return -(picked * keep).sum()


@torch.no_grad()
def gpt_logits_at(c, w, tokens, positions, mm=matmul):
    """Logits ``[len(positions), V]`` of one sequence ``tokens [S]`` at the
    given positions (each the logits that choose the token after it)."""
    x = gpt_hidden(c, w, tokens[None], mm)[0, positions]
    return mm(x, w["wte"].t())
