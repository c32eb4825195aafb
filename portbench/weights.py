"""Seeded weights, made by the benchmark and handed alike to the program
and to the reference.

The tree follows the published layout of the model family as the port
stores it: block leaves stacked on a leading ``[L, ...]`` axis and the
qkv columns head-major ``[H, 3, hd]``.  Each leaf is one draw from a
``torch.Generator`` on the device, in the dtype the model is served in
(normal with the family's init std; LayerNorm gains 1, biases 0), so the
same seed on the same device gives the same bits every time: the
reference makes them again after the program's state is freed.
"""
from __future__ import annotations

import math

import torch


def _maker(c, seed, device, dtype):
    dtype = dtype or getattr(torch, c["dtype"])
    g = torch.Generator(device=device).manual_seed(int(seed))

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dtype).mul_(std)

    def const(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    return normal, const


def _blocks(c, normal, const):
    D, F, L = c["hidden"], c["ffn_hidden"], c["num_layers"]
    resid = 0.02 / math.sqrt(2 * L)
    return {
        "ln1_g": const((L, D), 1.0), "ln1_b": const((L, D), 0.0),
        "qkv_w": normal((L, D, 3 * D), 0.02), "qkv_b": const((L, 3 * D), 0.0),
        "proj_w": normal((L, D, D), resid), "proj_b": const((L, D), 0.0),
        "ln2_g": const((L, D), 1.0), "ln2_b": const((L, D), 0.0),
        "up_w": normal((L, D, F), 0.02), "up_b": const((L, F), 0.0),
        "down_w": normal((L, F, D), resid), "down_b": const((L, D), 0.0),
    }


def gpt(c, seed, device, dtype=None):
    """The GPT decoder's weights (tied embedding), in the configuration's
    dtype unless ``dtype`` is given."""
    normal, const = _maker(c, seed, device, dtype)
    D = c["hidden"]
    return {"wte": normal((c["vocab_size"], D), 0.02),
            "wpe": normal((c["max_seq_len"], D), 0.01),
            "blocks": _blocks(c, normal, const),
            "lnf_g": const((D,), 1.0), "lnf_b": const((D,), 0.0)}


def bert(c, seed, device, dtype=None):
    """The BERT encoder's weights with its MLM head (tied embedding)."""
    normal, const = _maker(c, seed, device, dtype)
    D = c["hidden"]
    return {"wte": normal((c["vocab_size"], D), 0.02),
            "wpe": normal((c["max_seq_len"], D), 0.01),
            "wtt": normal((c["type_vocab_size"], D), 0.01),
            "emb_ln_g": const((D,), 1.0), "emb_ln_b": const((D,), 0.0),
            "blocks": _blocks(c, normal, const),
            "mlm_w": normal((D, D), 0.02), "mlm_b": const((D,), 0.0),
            "mlm_ln_g": const((D,), 1.0), "mlm_ln_b": const((D,), 0.0)}


def make(c, seed, device, dtype=None):
    return {"gpt": gpt, "bert": bert}[c["family"]](c, seed, device, dtype)


def leaves(tree, prefix=""):
    """``(path, tensor)`` of every leaf, in the tree's order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}
