"""The port's training half (``gpt_forward``/``gpt_loss``, remat,
dropout, ``HybridEngine``) against the JAX package on ``tiny`` fp32.

JAX parameters are carried across with ``params_from_jax`` and JAX
optimizer state with ``opt_from_jax``; batches are made with numpy from
a seed.  The JAX side runs flash attention as its own tests run it on
the CPU (Pallas in interpret mode); the port's takes its plain versions
on the CPU.  Tolerances are stated at each comparison."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed.engine import EngineConfig as JaxEngineConfig
from paddle_tpu.distributed.engine import HybridEngine as JaxEngine
from paddle_tpu.models.gpt import GPT_CONFIGS as JAX_CONFIGS
from paddle_tpu.models.gpt import gpt_forward as jax_gpt_forward
from paddle_tpu.models.gpt import gpt_init as jax_gpt_init
from paddle_tpu.models.gpt import gpt_loss as jax_gpt_loss
from paddle_tpu_torch.distributed import (EngineConfig, GPTAdapter,
                                          HybridEngine, checkpoint_policy)
from paddle_tpu_torch.models import (GPT, GPT_CONFIGS, gpt_flops_per_token,
                                     gpt_forward, gpt_init, gpt_loss,
                                     gpt_num_params, opt_from_jax,
                                     params_from_jax, params_to_numpy)

torch.set_num_threads(1)

# forward, loss and grads: the two sides sum matrix products in
# different orders, nothing else
TOL = dict(atol=1e-4, rtol=1e-4)
JCFG = dataclasses.replace(JAX_CONFIGS["tiny"], dtype="float32")
CFG = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")


def _batch(B=4, S=64, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, CFG.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100)],
                            axis=1).astype(np.int32)
    labels[1, :5] = -100                     # some ignored positions
    return tokens, labels


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np(tree):
    return _flat(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def tiny():
    jparams = jax_gpt_init(JCFG, jax.random.key(0), dtype=jnp.float32)
    return jparams, params_from_jax(jparams, device="cpu")


def _port_loss_and_grads(cfg, params, tokens, labels, **kw):
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = gpt_loss(cfg, params, torch.from_numpy(tokens),
                    torch.from_numpy(labels), **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def test_forward_loss_and_grads_match_jax(tiny):
    jparams, params = tiny
    tokens, labels = _batch()
    logits_j = jax_gpt_forward(JCFG, jparams, jnp.asarray(tokens))
    with torch.no_grad():
        logits = gpt_forward(CFG, params, torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)

    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_gpt_loss(JCFG, p, jnp.asarray(tokens),
                               jnp.asarray(labels)))(jparams)
    loss, grads = _port_loss_and_grads(CFG, params, tokens, labels)
    np.testing.assert_allclose(float(loss), float(loss_j), **TOL)
    grads_j = _np(grads_j)
    assert grads.keys() == grads_j.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), grads_j[k], **TOL, err_msg=k)


def test_naive_route_matches_flash_route(tiny):
    """``use_flash=False`` takes ``_naive_attention``; same loss."""
    _, params = tiny
    tokens, labels = _batch(seed=1)
    with torch.no_grad():
        a = gpt_loss(CFG, params, torch.from_numpy(tokens),
                     torch.from_numpy(labels))
        b = gpt_loss(dataclasses.replace(CFG, use_flash=False), params,
                     torch.from_numpy(tokens), torch.from_numpy(labels))
    np.testing.assert_allclose(float(a), float(b), **TOL)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_policies_agree(tiny, dropout):
    """``nothing``/``dots``/``dots_no_batch``/``full`` give identical
    losses and grads.  With dropout on, that shows each recompute draws
    the mask of the forward (there is no JAX parity for masks)."""
    _, params = tiny
    tokens, labels = _batch(seed=2)
    seed = 7 if dropout else None
    runs = {}
    for remat in ("nothing", "dots", "dots_no_batch", "full"):
        cfg = dataclasses.replace(CFG, remat=remat, dropout=dropout)
        runs[remat] = _port_loss_and_grads(cfg, params, tokens, labels,
                                           dropout_seed=seed)
    loss0, grads0 = runs["nothing"]
    for remat, (loss, grads) in runs.items():
        assert torch.equal(loss, loss0), remat
        for k in grads0:
            assert torch.equal(grads[k], grads0[k]), (remat, k)
    if dropout:
        plain, _ = _port_loss_and_grads(
            dataclasses.replace(CFG, dropout=dropout), params, tokens,
            labels)
        assert not torch.equal(plain, loss0)      # the masks did apply


def test_remat_policies_rerun_the_block():
    """Under ``dots`` and ``full`` the block runs again in backward (the
    flash forward inside it with it); under ``nothing`` it runs once."""
    calls = []

    def block(x, w):
        calls.append(1)
        return torch.tanh(x @ w) @ w

    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 8, requires_grad=True)
    for name, want in (("nothing", 1), ("dots", 2), ("full", 2)):
        calls.clear()
        checkpoint_policy(name)(block)(x, w).sum().backward()
        assert len(calls) == want, name
    with pytest.raises(ValueError):
        checkpoint_policy("everything")


def test_counts_and_module_facade(tiny):
    """``gpt_num_params`` counts every leaf ``gpt_init`` makes (each
    config's shape at a small width); the ``GPT`` module holds the same
    leaves and computes ``gpt_loss``."""
    _, params = tiny
    for name, cfg in GPT_CONFIGS.items():
        small = dataclasses.replace(cfg, vocab_size=128, max_seq_len=16,
                                    hidden=cfg.num_heads * 2, ffn_hidden=8,
                                    num_layers=2)
        n = sum(t.numel() for t in _flat(gpt_init(
            small, device="cpu", dtype=torch.float32)).values())
        assert n == gpt_num_params(small), name
    assert gpt_flops_per_token(GPT_CONFIGS["gpt3-1.3b"], 2048) == (
        6 * gpt_num_params(GPT_CONFIGS["gpt3-1.3b"]) + 12 * 24 * 2048 * 2048)
    model = GPT(CFG, torch.Generator().manual_seed(0), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == gpt_num_params(CFG)
    with torch.no_grad():
        for name, t in _flat(model.params()).items():
            t.copy_(_flat(params)[name])
        tokens, labels = _batch(seed=3)
        want = gpt_loss(CFG, params, torch.from_numpy(tokens),
                        torch.from_numpy(labels))
        got = model(torch.from_numpy(tokens), torch.from_numpy(labels))
    assert torch.equal(got, want)
    assert "blocks_qkv_w" in dict(model.named_parameters())


def test_engine_rejects_parallel_axes_and_moe():
    for axis in ("dp", "pp", "sharding", "sep", "mp", "ep"):
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            HybridEngine(CFG, device="cpu", **{axis: 2})
    with pytest.raises(NotImplementedError, match="MoE"):
        HybridEngine(dataclasses.replace(CFG, moe_experts=4), device="cpu")
    with pytest.raises(ValueError):
        EngineConfig(opt_dtype="float16")
    assert GPTAdapter(CFG).decay_this("blocks/qkv_w")
    assert not GPTAdapter(CFG).decay_this("blocks/ln1_g")
    assert not GPTAdapter(CFG).decay_this("blocks/up_b")


def test_tied_vocab_ce_chunks_like_one_block(tiny):
    """A ``ce_block_elems`` that forces 4 chunks gives the unchunked
    loss and grads."""
    jparams, _ = tiny
    tokens, labels = _batch(seed=4)
    out = []
    for elems in (1 << 29, 4 * 64 * 1024 // 4):
        eng = HybridEngine(CFG, device="cpu",
                           engine_cfg=EngineConfig(ce_block_elems=elems))
        params = params_from_jax(jparams, device="cpu")
        leaves = list(_flat(params).values())
        for t in leaves:
            t.requires_grad_(True)
        loss = eng._local_loss(params, torch.from_numpy(tokens).long(),
                               torch.from_numpy(labels).long())
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(out[0][0]), float(out[1][0]), **TOL)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# ---------------------------------------------------------------- engine

ENGINE_CASES = {
    "accum2": dict(accum_steps=2),
    "clip_binds": dict(grad_clip=0.05),
    "bf16_slots": dict(opt_dtype="bfloat16"),
}
STEPS, LR = 3, 1e-3


@pytest.fixture(scope="module", params=sorted(ENGINE_CASES))
def engine_runs(request):
    """3 steps of the JAX engine and the port's from the same params and
    batch; returns both sides' losses, params and canonical opt state."""
    kw = ENGINE_CASES[request.param]
    tokens, labels = _batch(seed=5)
    jeng = JaxEngine(JCFG, devices=jax.devices()[:1],
                     engine_cfg=JaxEngineConfig(**kw))
    jp, jo = jeng.init(seed=0)
    params = params_from_jax(jp, device="cpu")
    canon0 = opt_from_jax(jeng.opt_canonical()(jo["slots"], jp),
                          device="cpu")
    jlosses = []
    for _ in range(STEPS):
        jp, jo, loss = jeng.step(jp, jo, tokens, labels, lr=LR)
        jlosses.append(float(loss))
    jcanon = jeng.opt_canonical()(jo["slots"], jp)

    eng = HybridEngine(CFG, device="cpu", engine_cfg=EngineConfig(**kw))
    opt = eng.opt_from_canonical(
        {k: {**v} for k, v in canon0.items()}, step=0)
    if eng._opt_dtype() == torch.bfloat16:
        assert all("master" in s for s in _slot_leaves(opt["slots"]))
    p0 = {k: v.clone() for k, v in _flat(params).items()}
    losses = []
    for _ in range(STEPS):
        params, opt, loss = eng.step(params, opt, tokens, labels, lr=LR)
        losses.append(float(loss))
    assert opt["step"] == STEPS == int(jo["step"])
    canon = eng.opt_canonical(opt, params)
    return dict(case=request.param, jlosses=jlosses, losses=losses,
                jparams=_np(jp), params=_flat(params_to_numpy(params)),
                p0=p0, jcanon={k: _np(v) for k, v in jcanon.items()},
                canon={k: _flat(params_to_numpy(v))
                       for k, v in canon.items()})


def _slot_leaves(tree):
    if "m" in tree and not isinstance(tree["m"], dict):
        return [tree]
    return [s for v in tree.values() for s in _slot_leaves(v)]


def test_engine_losses_match_jax(engine_runs):
    """The JAX engine suite's own loss tolerance (atol 2e-4)."""
    np.testing.assert_allclose(engine_runs["losses"], engine_runs["jlosses"],
                               atol=2e-4, rtol=1e-4)
    assert engine_runs["losses"][-1] < engine_runs["losses"][0]


def test_engine_params_match_jax(engine_runs):
    """Each Adam step moves an element by about lr in the direction
    m̂/(√v̂ + ε).  Where |g| is far above ε that direction is the same on
    both sides; where |g| is within a few orders of ε it is set by
    summation-order noise, and the element can move by up to lr
    differently per step.  So: every element within STEPS·lr, and the
    updates (p − p0) agree to 2e-5 + 1e-2 relative on 99.9 % of the
    elements of every leaf."""
    jp, p, p0 = (engine_runs[k] for k in ("jparams", "params", "p0"))
    assert jp.keys() == p.keys()
    for k in jp:
        np.testing.assert_allclose(p[k], jp[k], atol=STEPS * LR, rtol=0,
                                   err_msg=k)
        d, dj = p[k] - p0[k].numpy(), jp[k] - p0[k].numpy()
        close = np.abs(d - dj) <= 2e-5 + 1e-2 * np.abs(dj)
        assert close.mean() >= 0.999, (k, close.mean())


def test_engine_opt_state_matches_jax(engine_runs):
    """m and v are running means of g and g² (fp32 slots: atol 1e-6 on
    m, 1e-9 on v, rtol 1e-3 — grads agree to ~1e-4 relative).  bf16
    slots round the same fp32 values to bf16, which can land one ulp
    apart (rtol 2⁻⁶).  The master follows the params."""
    canon, jcanon = engine_runs["canon"], engine_runs["jcanon"]
    bf16 = engine_runs["case"] == "bf16_slots"
    tol = {"m": dict(atol=1e-6, rtol=2 ** -6 if bf16 else 1e-3),
           "v": dict(atol=1e-9, rtol=2 ** -6 if bf16 else 1e-3),
           "master": dict(atol=STEPS * LR, rtol=2 ** -7 if bf16 else 0)}
    for name in ("m", "v", "master"):
        assert canon[name].keys() == jcanon[name].keys()
        for k in canon[name]:
            np.testing.assert_allclose(canon[name][k], jcanon[name][k],
                                       **tol[name], err_msg=f"{name}/{k}")
