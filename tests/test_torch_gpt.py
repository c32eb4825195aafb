"""The port's GPT (config, init, weight carry-over, ragged step) against
the JAX package on ``tiny``.

JAX ``gpt_init`` parameters are carried across with ``params_from_jax``;
batches are made with numpy from a seed.  fp32, atol = rtol = 1e-4: the
two sides sum matrix products in different orders."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models.gpt import GPT_CONFIGS as JAX_CONFIGS
from paddle_tpu.models.gpt import gpt_init as jax_gpt_init
from paddle_tpu.models.gpt import gpt_ragged_step as jax_ragged_step
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.models import (GPT_CONFIGS, gpt_init,
                                     gpt_ragged_step, params_from_jax,
                                     params_to_numpy)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype="float32")
    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")
    jparams = jax_gpt_init(jcfg, jax.random.key(0), dtype=jnp.float32)
    return jcfg, cfg, jparams, params_from_jax(jparams, device="cpu")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_configs_are_the_jax_configs():
    for name, jc in JAX_CONFIGS.items():
        assert dataclasses.asdict(GPT_CONFIGS[name]) == \
            dataclasses.asdict(jc), name
        assert GPT_CONFIGS[name].head_dim == jc.head_dim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips(tiny, dtype):
    jcfg = tiny[0]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jparams = jax_gpt_init(jcfg, jax.random.key(3), dtype=jdt)
    params = params_from_jax(jparams, device="cpu",
                             dtype=getattr(torch, dtype))
    back = _flat(params_to_numpy(params))
    ref = _flat(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jparams))
    assert back.keys() == ref.keys()
    for k in ref:
        assert _flat(params)[k].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


@pytest.mark.parametrize("tie", [True, False])
def test_gpt_init_names_shapes_and_stds(tie):
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], tie_embeddings=tie)
    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], tie_embeddings=tie)
    ref = _flat(jax_gpt_init(jcfg, jax.random.key(0)))
    ours = _flat(gpt_init(cfg, torch.Generator().manual_seed(0),
                          device="cpu"))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape, k
        assert ours[k].dtype == torch.bfloat16, k
    L = cfg.num_layers
    stds = {"wte": 0.02, "wpe": 0.01, "blocks/qkv_w": 0.02,
            "blocks/up_w": 0.02, "blocks/proj_w": 0.02 / math.sqrt(2 * L),
            "blocks/down_w": 0.02 / math.sqrt(2 * L)}
    if not tie:
        stds["lm_head"] = 0.02
    for k, std in stds.items():
        assert abs(float(ours[k].float().std()) / std - 1) < 0.05, k
    for k in ("blocks/ln1_g", "blocks/ln2_g", "lnf_g"):
        assert bool((ours[k] == 1).all()), k
    for k in ("blocks/qkv_b", "blocks/proj_b", "blocks/up_b",
              "blocks/down_b", "blocks/ln1_b", "lnf_b"):
        assert not ours[k].any(), k


def _batch(cfg, seed=5):
    """Row 0: mid-prefill chunk (positions 4..8), row 1: decode at 14,
    row 2: idle, row 3: a fresh prompt's first chunk; three padding
    slots, one of them a token of row 1 past its query_len (invalid)."""
    rng = np.random.RandomState(seed)
    B, ps, P, max_q = 4, 4, 64, 6
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    width = cfg.max_seq_len // ps
    qlens = np.asarray([5, 1, 0, 3], np.int32)
    ctxs = np.asarray([9, 14, 0, 3], np.int32)
    rows, slots = [], []
    for b, n in enumerate(qlens):
        rows += [b] * n
        slots += list(range(n))
    rows += [1, B, B]                 # invalid token of row 1, 2 pads
    slots += [1, 0, 0]
    T = len(rows)
    live = rng.permutation(P)[:B * 4].reshape(B, 4)
    tables = np.zeros((B, width), np.int32)
    tables[:, :4] = live
    kp = rng.standard_normal((L, P, ps, H, hd)).astype(np.float32)
    vp = rng.standard_normal((L, P, ps, H, hd)).astype(np.float32)
    tokens = rng.randint(0, cfg.vocab_size, T).astype(np.int32)
    return dict(tokens=tokens, rows=np.asarray(rows, np.int32),
                slots=np.asarray(slots, np.int32), qlens=qlens, ctxs=ctxs,
                kp=kp, vp=vp, tables=tables, max_q=max_q, ps=ps)


def _with_scratch(pages):
    """The port's pool: JAX's [L, P, ...] and one scratch page after it,
    which the step writes its padding and invalid tokens to."""
    return torch.cat([pages, torch.zeros_like(pages[:, :1])], dim=1)


def _run_port(cfg, params, d, **kw):
    """The port's step on ``d``; returns the logits and the pool's first
    ``P`` pages (the scratch page cut off), as numpy."""
    t = {k: torch.from_numpy(np.array(d[k])) for k in
         ("tokens", "rows", "slots", "qlens", "ctxs", "kp", "vp", "tables")}
    P = t["kp"].shape[1]
    logits, kp, vp = gpt_ragged_step(
        cfg, params, t["tokens"], t["rows"], t["slots"], t["qlens"],
        t["ctxs"], _with_scratch(t["kp"]), _with_scratch(t["vp"]),
        t["tables"], max_q=d["max_q"], **kw)
    return logits.numpy(), kp[:, :P].numpy(), vp[:, :P].numpy()


def test_ragged_step_matches_jax(tiny):
    jcfg, cfg, jparams, params = tiny
    d = _batch(cfg)
    jl, jk, jv = jax_ragged_step(
        jcfg, jparams, *(jnp.asarray(d[k]) for k in
                         ("tokens", "rows", "slots", "qlens", "ctxs")),
        jnp.asarray(d["kp"]), jnp.asarray(d["vp"]),
        jnp.asarray(d["tables"]), max_q=d["max_q"])
    logits, kp, vp = _run_port(cfg, params, d)
    live = d["qlens"] > 0
    np.testing.assert_allclose(logits[live], np.asarray(jl)[live],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(kp, np.asarray(jk), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vp, np.asarray(jv), rtol=1e-4, atol=1e-4)
    # the attention hook: passing the plain version explicitly is the
    # same computation the CPU wrapper picks
    again, _, _ = _run_port(cfg, params, d,
                            attention=pa._ragged_attention_ref)
    np.testing.assert_array_equal(again, logits)


def test_padding_and_invalid_tokens_leave_pages_untouched(tiny):
    _, cfg, _, params = tiny
    d = _batch(cfg)
    _, kp, vp = _run_port(cfg, params, d)
    written = np.zeros(d["kp"].shape[1:3], bool)          # [P, ps]
    for b, (ql, ctx) in enumerate(zip(d["qlens"], d["ctxs"])):
        for pos in range(ctx - ql, ctx):
            written[d["tables"][b, pos // d["ps"]], pos % d["ps"]] = True
    assert written.sum() == d["qlens"].sum()
    for new, old in ((kp, d["kp"]), (vp, d["vp"])):
        np.testing.assert_array_equal(new[:, ~written], old[:, ~written])
        assert (new[:, written] != old[:, written]).any(axis=-1).all()
