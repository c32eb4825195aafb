"""The port's Mixture-of-Experts (``distributed/moe.py``, the MoE GPT in
training, loss and serving, ``HybridEngine``) against the JAX package.

The model is ``tiny`` with 4 experts at fp32.  Its capacity factor is
1.0, so an expert holds C = T/2 of T routed tokens at top-2 — the ratio
of the 8-expert, capacity-factor-2.0 configuration the card runs — and
capacity drops happen.  JAX parameters are carried across with
``params_from_jax``; inputs are made with numpy from seeds.  The JAX
side runs flash attention as its own tests do on the CPU; the port's
takes its plain versions.  Tolerances are stated at each comparison."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.distributed.moe as jax_moe
from paddle_tpu.distributed.engine import HybridEngine as JaxEngine
from paddle_tpu.models.gpt import GPT_CONFIGS as JAX_CONFIGS
from paddle_tpu.models.gpt import gpt_flops_per_token as jax_flops
from paddle_tpu.models.gpt import gpt_forward as jax_gpt_forward
from paddle_tpu.models.gpt import gpt_init as jax_gpt_init
from paddle_tpu.models.gpt import gpt_loss as jax_gpt_loss
from paddle_tpu.models.gpt import gpt_num_params as jax_num_params
from paddle_tpu.models.gpt import gpt_ragged_step as jax_ragged_step
from paddle_tpu.serving import Engine as JaxServing
from paddle_tpu.serving import SamplingParams as JaxSampling
import paddle_tpu_torch.distributed.moe as moe
from paddle_tpu_torch.distributed import HybridEngine
from paddle_tpu_torch.models import (GPT, GPT_CONFIGS, gpt_flops_per_token,
                                     gpt_forward, gpt_init, gpt_loss,
                                     gpt_num_params, gpt_ragged_step,
                                     opt_from_jax, params_from_jax,
                                     params_to_numpy)
from paddle_tpu_torch.serving import Engine, SamplingParams

torch.set_num_threads(1)

# forward, loss and grads: the two sides sum products in different orders
TOL = dict(atol=1e-4, rtol=1e-4)
MOE = dict(moe_experts=4, moe_capacity_factor=1.0)
JCFG = dataclasses.replace(JAX_CONFIGS["tiny"], dtype="float32", **MOE)
CFG = dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32", **MOE)


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


def _batch(B=4, S=64, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, CFG.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100)],
                            axis=1).astype(np.int32)
    labels[1, :5] = -100
    return tokens, labels


# ----------------------------------------------------------------- gating

GATING = {
    "top2_norm": dict(n=24, E=4, top_k=2, cf=2.0, normalize=True),
    "top2_raw": dict(n=24, E=4, top_k=2, cf=2.0, normalize=False),
    "top1": dict(n=16, E=8, top_k=1, cf=1.25, normalize=False),
    "top2_drops": dict(n=64, E=4, top_k=2, cf=0.5, normalize=True),
}


@pytest.mark.parametrize("case", sorted(GATING))
def test_gating_matches_jax(case):
    """``moe_gating`` (built from the index routing) against JAX's:
    dispatch equal; combine and aux to one fp32 ulp (the two softmaxes
    round differently).  The index routing itself names the same
    (token, expert, slot) cells."""
    c = GATING[case]
    logits = np.random.RandomState(len(case)).randn(c["n"], c["E"]) \
        .astype(np.float32)
    kw = dict(top_k=c["top_k"], capacity_factor=c["cf"],
              normalize_top_k=c["normalize"])
    jc, jd, ja = jax_moe.moe_gating(jnp.asarray(logits), **kw)
    tc, td, ta = moe.moe_gating(torch.from_numpy(logits), **kw)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-7,
                               rtol=2e-7)
    np.testing.assert_allclose(float(ta), float(ja), rtol=2e-7)
    r = moe.moe_route(torch.from_numpy(logits), **kw)
    assert r.capacity == jc.shape[-1] == moe.moe_capacity(
        c["n"], c["E"], c["cf"], c["top_k"])
    cells = np.zeros(jd.shape, bool)
    for t, k in zip(*np.nonzero(r.dispatched.numpy())):
        cells[t, r.expert[t, k], r.slot[t, k]] = True
    np.testing.assert_array_equal(cells, np.asarray(jd))
    if case == "top2_drops":
        assert bool((~r.keep).any())


def _moe_params(seed, E=4, D=16, F=32):
    rng = np.random.RandomState(seed)
    return {"gate_w": rng.randn(D, E).astype(np.float32) * 0.5,
            "up_w": rng.randn(E, D, F).astype(np.float32) * 0.1,
            "up_b": rng.randn(E, F).astype(np.float32) * 0.1,
            "down_w": rng.randn(E, F, D).astype(np.float32) * 0.1,
            "down_b": rng.randn(E, D).astype(np.float32) * 0.1}


def _moe_inputs(seed, B=3, S=8, D=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, D).astype(np.float32),
            rng.randn(B, S, D).astype(np.float32))


@pytest.mark.parametrize("cf", [1.0, 2.0])
def test_moe_layer_output_and_grads_match_jax(cf):
    """y at 1e-5 and the gradients of Σ y·r + aux (x, gate_w, every
    expert leaf) at 1e-4, with (cf 1.0) and without (2.0) drops."""
    p, (x, r) = _moe_params(1), _moe_inputs(2)
    kw = dict(top_k=2, capacity_factor=cf)

    def jloss(p, x):
        y, aux = jax_moe.moe_layer(p, x, **kw)
        return (y * r).sum() + aux, y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_layer(tp, tx, **kw)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                                [tx] + list(tp.values()))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg[1]), **TOL)
    for k, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[0][k]), **TOL,
                                   err_msg=k)


def test_index_route_equals_dense_einsum_route():
    """``moe_layer``'s gather/scatter equals dispatching and combining by
    einsum over the dense ``moe_gating`` tensors (the JAX formulation),
    in output and gradients, including a zero-weight choice that JAX's
    ``dispatch = combine > 0`` leaves undispatched."""
    p, (x, r) = _moe_params(3), _moe_inputs(4)
    p["gate_w"][:, 3] = -1e4            # expert 3's gate weight is 0
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    rt = torch.from_numpy(r)

    def dense(params, x):
        xt = x.reshape(-1, x.shape[-1])
        combine, dispatch, aux = moe.moe_gating(
            xt.float() @ params["gate_w"].float(), top_k=3,
            capacity_factor=1.0)
        expert_in = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), xt)
        out = moe.moe_ffn(params, expert_in)
        y = torch.einsum("nec,ecd->nd", combine.to(x.dtype), out)
        return y.reshape(x.shape), aux

    runs = []
    for fn in (lambda p, x: moe.moe_layer(p, x, top_k=3,
                                          capacity_factor=1.0), dense):
        y, aux = fn(tp, tx)
        runs.append([y.detach(), aux.detach()] + list(torch.autograd.grad(
            (y * rt).sum() + aux, [tx] + list(tp.values()))))
    r = moe.moe_route(tx.detach().reshape(-1, 16) @ tp["gate_w"].detach(),
                      top_k=3, capacity_factor=1.0)
    assert bool((r.keep & (r.weight == 0)).any())
    for a, b in zip(*runs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-5)


def test_moe_layer_refuses_expert_parallelism():
    """``ep_axis="ep"`` names the expert-parallel group of a world: in one
    process without ``fleet.init`` there is none, and the call says so."""
    p, (x, _) = _moe_params(5), _moe_inputs(6)
    with pytest.raises(ValueError, match="multi-GPU"):
        moe.moe_layer({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), ep_axis="ep")


@pytest.mark.parametrize("gate", ["naive", "switch", "gshard"])
def test_facades_match_jax_moelayer(gate):
    """The port's ``MoELayer`` with the JAX layer's weights carried
    across: same top_k, output (1e-5) and aux loss."""
    import paddle_tpu

    jl = jax_moe.MoELayer(d_model=8, d_hidden=16, num_experts=4, gate=gate)
    tl = moe.MoELayer(d_model=8, d_hidden=16, num_experts=4, gate=gate,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    assert type(tl.gate).__name__ == type(jl.gate).__name__
    assert tl.top_k == jl.top_k
    with torch.no_grad():
        tl.gate.weight.copy_(torch.from_numpy(np.array(
            jl.gate.weight.data)))
        for k in ("up_w", "up_b", "down_w", "down_b"):
            getattr(tl, k).copy_(torch.from_numpy(np.array(
                getattr(jl, k).data)))
    x = np.random.RandomState(7).randn(2, 6, 8).astype(np.float32)
    jy = jl(paddle_tpu.to_tensor(x))
    with torch.no_grad():
        y = tl(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy.data), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(tl.aux_loss), float(
        getattr(jl.aux_loss, "data", jl.aux_loss)), rtol=1e-6)


# ------------------------------------------------------------ the model


def test_gpt_init_moe_leaves_and_counts():
    """MoE leaves by name, shape and dtype as JAX's ``gpt_init`` (gate_w
    fp32 in a bf16 model, also through ``params_from_jax``), the ``GPT``
    module over a MoE config, and ``gpt_num_params`` /
    ``gpt_flops_per_token`` equal JAX's and the leaves' count."""
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], **MOE)
    cfg = dataclasses.replace(GPT_CONFIGS["tiny"], **MOE)
    jp = jax_gpt_init(jcfg, jax.random.key(0))
    ref = _flat(jp)
    ours = _flat(gpt_init(cfg, torch.Generator().manual_seed(0),
                          device="cpu"))
    carried = _flat(params_from_jax(jp, device="cpu", dtype=torch.bfloat16))
    assert ours.keys() == ref.keys() == carried.keys()
    for k in ref:
        want = torch.float32 if k == "blocks/gate_w" else torch.bfloat16
        assert tuple(ours[k].shape) == ref[k].shape, k
        assert ours[k].dtype == carried[k].dtype == want, k
    assert ref["blocks/gate_w"].dtype == jnp.float32
    assert abs(float(ours["blocks/gate_w"].std()) / 0.02 - 1) < 0.05
    assert abs(float(ours["blocks/up_w"].float().std()) / 0.02 - 1) < 0.05
    assert sum(t.numel() for t in ours.values()) == gpt_num_params(cfg)
    model = GPT(dataclasses.replace(cfg, dtype="float32"),
                torch.Generator().manual_seed(0), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == gpt_num_params(cfg)
    assert model.blocks_gate_w.dtype == torch.float32
    tokens, labels = _batch(B=2, S=16, seed=8)
    with torch.no_grad():
        assert torch.equal(
            model(torch.from_numpy(tokens), torch.from_numpy(labels)),
            gpt_loss(model.config, model.params(), torch.from_numpy(tokens),
                     torch.from_numpy(labels)))
    for name in ("tiny", "gpt3-1.3b", "gpt3-6.7b"):
        for E in (4, 8):
            c = dataclasses.replace(GPT_CONFIGS[name], moe_experts=E)
            jc = dataclasses.replace(JAX_CONFIGS[name], moe_experts=E)
            assert gpt_num_params(c) == jax_num_params(jc)
            assert gpt_flops_per_token(c, 2048) == jax_flops(jc, 2048)


def _port_loss_and_grads(cfg, params, tokens, labels, **kw):
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = gpt_loss(cfg, params, torch.from_numpy(tokens),
                    torch.from_numpy(labels), **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def test_forward_loss_and_grads_match_jax(tiny):
    """Logits, the summed aux, the loss (CE + weight × aux / L) and every
    gradient, gate_w included, at 1e-4."""
    jparams, params = tiny
    tokens, labels = _batch()
    jl, jaux = jax_gpt_forward(JCFG, jparams, jnp.asarray(tokens),
                               return_aux=True)
    with torch.no_grad():
        logits, aux = gpt_forward(CFG, params, torch.from_numpy(tokens),
                                  return_aux=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert float(aux) > 0
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_gpt_loss(JCFG, p, jnp.asarray(tokens),
                               jnp.asarray(labels)))(jparams)
    loss, grads = _port_loss_and_grads(CFG, params, tokens, labels)
    np.testing.assert_allclose(float(loss), float(loss_j), **TOL)
    grads_j = _np(grads_j)
    assert grads.keys() == grads_j.keys()
    assert "blocks/gate_w" in grads
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), grads_j[k], **TOL, err_msg=k)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_policies_agree(tiny, dropout):
    """Every checkpoint policy gives the same loss (aux included) and
    grads, bit for bit: the recompute routes every token as the forward
    did."""
    _, params = tiny
    tokens, labels = _batch(seed=2)
    runs = {}
    for remat in ("nothing", "dots", "dots_no_batch", "full"):
        cfg = dataclasses.replace(CFG, remat=remat, dropout=dropout)
        runs[remat] = _port_loss_and_grads(
            cfg, params, tokens, labels, dropout_seed=7 if dropout else None)
    loss0, grads0 = runs["nothing"]
    for remat, (loss, grads) in runs.items():
        assert torch.equal(loss, loss0), remat
        for k in grads0:
            assert torch.equal(grads[k], grads0[k]), (remat, k)


# ----------------------------------------------------------- serving step


def _eviction_batch(cfg, seed=3):
    """Row 0 mid-prefill (5 tokens), rows 1-2 decode, row 3 idle, then 25
    padding slots (row B) in a 32-token budget, as the serving engine
    packs a step: C = 16 per expert, and the identical padding tokens'
    1st choices fill one expert before any 2nd choice is placed."""
    rng = np.random.RandomState(seed)
    B, ps, P, max_q, T = 4, 4, 64, 8, 32
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    qlens = np.asarray([5, 1, 1, 0], np.int32)
    ctxs = np.asarray([9, 14, 7, 0], np.int32)
    rows = np.full(T, B, np.int32)
    slots = np.zeros(T, np.int32)
    off = 0
    for b, n in enumerate(qlens):
        rows[off:off + n] = b
        slots[off:off + n] = np.arange(n)
        off += n
    tables = np.zeros((B, cfg.max_seq_len // ps), np.int32)
    tables[:, :4] = rng.permutation(P)[:B * 4].reshape(B, 4)
    return dict(
        tokens=np.where(rows < B, rng.randint(0, cfg.vocab_size, T), 0)
        .astype(np.int32), rows=rows, slots=slots, qlens=qlens, ctxs=ctxs,
        kp=rng.standard_normal((L, P, ps, H, hd)).astype(np.float32),
        vp=rng.standard_normal((L, P, ps, H, hd)).astype(np.float32),
        tables=tables, max_q=max_q, n_valid=int(qlens.sum()))


def test_ragged_step_matches_jax_with_padding_evictions(tiny, monkeypatch):
    """The MoE serving step against JAX's: logits and written pages at
    1e-4, and every layer's dispatch equal.  In both, padding tokens
    take a capacity slot that a valid token's 2nd choice then misses."""
    jparams, params = tiny
    d = _eviction_batch(CFG)
    jax_seen, port_seen = [], []
    jax_layer, port_route = jax_moe.moe_layer, moe.moe_route

    def jax_spy(p, x, **kw):
        xt = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        _, dispatch, _ = jax_moe.moe_gating(
            xt @ p["gate_w"].astype(jnp.float32), top_k=kw["top_k"],
            capacity_factor=kw["capacity_factor"])
        jax.debug.callback(lambda a: jax_seen.append(np.asarray(a)),
                           dispatch)
        return jax_layer(p, x, **kw)

    def port_spy(logits, **kw):
        r = port_route(logits, **kw)
        port_seen.append(r)
        return r

    monkeypatch.setattr(jax_moe, "moe_layer", jax_spy)
    monkeypatch.setattr(moe, "moe_route", port_spy)
    args = ("tokens", "rows", "slots", "qlens", "ctxs")
    jl, jk, jv = jax_ragged_step(
        JCFG, jparams, *(jnp.asarray(d[k]) for k in args),
        jnp.asarray(d["kp"]), jnp.asarray(d["vp"]),
        jnp.asarray(d["tables"]), max_q=d["max_q"])
    t = {k: torch.from_numpy(np.array(d[k])) for k in
         args + ("kp", "vp", "tables")}
    # the port's pool has one scratch page after JAX's P pages
    P = t["kp"].shape[1]
    kp, vp = (torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
              for x in (t["kp"], t["vp"]))
    logits, kp, vp = gpt_ragged_step(
        CFG, params, *(t[k] for k in args), kp, vp, t["tables"],
        max_q=d["max_q"])
    live = d["qlens"] > 0
    np.testing.assert_allclose(logits.numpy()[live], np.asarray(jl)[live],
                               **TOL)
    np.testing.assert_allclose(kp[:, :P].numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(vp[:, :P].numpy(), np.asarray(jv), **TOL)

    assert len(jax_seen) == len(port_seen) == CFG.num_layers
    n, evicted = d["n_valid"], {"jax": 0, "port": 0}
    for jd, r in zip(jax_seen, port_seen):
        cells = np.zeros(jd.shape, bool)
        for tok, k in zip(*np.nonzero(r.dispatched.numpy())):
            cells[tok, r.expert[tok, k], r.slot[tok, k]] = True
        np.testing.assert_array_equal(cells, jd)
        # port: a valid token's 2nd choice dropped in an expert whose
        # slots hold padding tokens
        padded = set(r.expert[n:][r.dispatched[n:]].tolist())
        evicted["port"] += sum(not r.keep[i, 1] and
                               int(r.expert[i, 1]) in padded
                               for i in range(n))
        # JAX: a valid token holding one slot while an expert is full
        # and holds padding tokens
        full = [e for e in range(jd.shape[1])
                if jd[:, e].any(0).all() and jd[n:, e].any()]
        if full:
            evicted["jax"] += int((jd[:n].sum((1, 2)) < 2).sum())
    assert evicted["jax"] == evicted["port"] > 0


@pytest.fixture(scope="module")
def served(tiny):
    """The same greedy requests through the JAX engine and the port's
    (decode-heavy steps, so padding takes expert capacity)."""
    jparams, params = tiny
    rng = np.random.RandomState(11)
    prompts = [[int(t) for t in rng.randint(0, CFG.vocab_size, n)]
               for n in (5, 19, 9, 30)]
    kw = dict(page_size=8, num_pages=64, max_batch_size=4, chunk_len=8)
    out = []
    for eng, sp in ((JaxServing(JCFG, jparams, **kw), JaxSampling),
                    (Engine(CFG, params, device="cpu", **kw),
                     SamplingParams)):
        reqs = [eng.add_request(p, sp(max_new_tokens=12)) for p in prompts]
        while eng.has_work():
            eng.step()
        out.append([r.output for r in reqs])
    return out


def test_engine_greedy_tokens_match_jax(served):
    jax_out, port_out = served
    assert port_out == jax_out
    assert all(len(o) == 12 for o in port_out)


# ---------------------------------------------------------------- engine

STEPS, LR = 3, 1e-3


@pytest.fixture(scope="module")
def engine_runs():
    """3 steps of the JAX engine (ep = 1) and the port's from the same
    params and batch."""
    tokens, labels = _batch(seed=5)
    jeng = JaxEngine(JCFG, devices=jax.devices()[:1])
    jp, jo = jeng.init(seed=0)
    params = params_from_jax(jp, device="cpu")
    canon0 = opt_from_jax(jeng.opt_canonical()(jo["slots"], jp),
                          device="cpu")
    jlosses = []
    for _ in range(STEPS):
        jp, jo, loss = jeng.step(jp, jo, tokens, labels, lr=LR)
        jlosses.append(float(loss))
    jcanon = jeng.opt_canonical()(jo["slots"], jp)

    eng = HybridEngine(CFG, device="cpu")
    opt = eng.opt_from_canonical(canon0, step=0)
    p0 = {k: v.clone() for k, v in _flat(params).items()}
    losses = []
    for _ in range(STEPS):
        params, opt, loss = eng.step(params, opt, tokens, labels, lr=LR)
        losses.append(float(loss))
    canon = eng.opt_canonical(opt, params)
    return dict(jlosses=jlosses, losses=losses, jparams=_np(jp),
                params=_flat(params_to_numpy(params)), p0=p0,
                jcanon={k: _np(v) for k, v in jcanon.items()},
                canon={k: _flat(params_to_numpy(v))
                       for k, v in canon.items()})


def test_engine_losses_match_jax(engine_runs):
    """atol 2e-4 (the JAX engine suite's); the loss falls."""
    np.testing.assert_allclose(engine_runs["losses"], engine_runs["jlosses"],
                               atol=2e-4, rtol=1e-4)
    assert engine_runs["losses"][-1] < engine_runs["losses"][0]


def test_engine_params_match_jax(engine_runs):
    """As ``test_torch_train.py``: every element within STEPS·lr, and the
    updates agree to 2e-5 + 1e-2 relative on 99.9 % of every leaf's
    elements (an element whose |g| is near ε moves by noise)."""
    jp, p, p0 = (engine_runs[k] for k in ("jparams", "params", "p0"))
    assert jp.keys() == p.keys()
    assert "blocks/gate_w" in p
    for k in jp:
        np.testing.assert_allclose(p[k], jp[k], atol=STEPS * LR, rtol=0,
                                   err_msg=k)
        d, dj = p[k] - p0[k].numpy(), jp[k] - p0[k].numpy()
        close = np.abs(d - dj) <= 2e-5 + 1e-2 * np.abs(dj)
        assert close.mean() >= 0.999, (k, close.mean())


def test_engine_opt_state_matches_jax(engine_runs):
    """m (atol 1e-6) and v (atol 1e-9) at rtol 1e-3, the master within
    STEPS·lr, as ``test_torch_train.py`` holds fp32 slots."""
    canon, jcanon = engine_runs["canon"], engine_runs["jcanon"]
    tol = {"m": dict(atol=1e-6, rtol=1e-3), "v": dict(atol=1e-9, rtol=1e-3),
           "master": dict(atol=STEPS * LR, rtol=0)}
    for name in ("m", "v", "master"):
        assert canon[name].keys() == jcanon[name].keys()
        for k in canon[name]:
            np.testing.assert_allclose(canon[name][k], jcanon[name][k],
                                       **tol[name], err_msg=f"{name}/{k}")


def test_engine_keeps_gate_w_fp32_in_a_bf16_model():
    """A bf16 MoE model: gate_w, its moments and master stay fp32 across
    steps; the other leaves stay bf16; the loss is finite."""
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    eng = HybridEngine(cfg, device="cpu")
    params, opt = eng.init(seed=0)
    tokens, labels = _batch(B=2, S=32, seed=6)
    for _ in range(2):
        params, opt, loss = eng.step(params, opt, tokens, labels, lr=LR)
        assert np.isfinite(float(loss))
    slots = opt["slots"]["blocks"]["gate_w"]
    assert params["blocks"]["gate_w"].dtype == torch.float32
    assert all(s.dtype == torch.float32 for s in slots.values())
    assert params["blocks"]["up_w"].dtype == torch.bfloat16
