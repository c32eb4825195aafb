"""The port's BERT (``models/bert.py``) and ``BertAdapter`` against the
JAX package.

A small bidirectional encoder at fp32 (the JAX BERT engine suite's
shape); JAX parameters are carried across with ``params_from_jax`` and
MLM batches are made with numpy from a seed ([MASK] is the last id, as
in ``tests/test_bert_engine.py``).  The JAX side runs flash attention
as its own tests do on the CPU; the port's takes its plain versions.
Tolerances are stated at each comparison."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed.engine import HybridEngine as JaxEngine
from paddle_tpu.distributed.model_adapter import BertAdapter as JaxBert
from paddle_tpu.models.bert import BERT_CONFIGS as JAX_BERT_CONFIGS
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import bert_init as jax_bert_init
from paddle_tpu.models.bert import bert_loss as jax_bert_loss
from paddle_tpu_torch.distributed import BertAdapter, HybridEngine
from paddle_tpu_torch.kernels.flash_attention import flash_attention
from paddle_tpu_torch.models import (BERT_CONFIGS, BertConfig, bert_init,
                                     bert_loss, opt_from_jax,
                                     params_from_jax, params_to_numpy)
from paddle_tpu_torch.ops.attention import _naive_attention

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = dict(vocab_size=256, max_seq_len=128, type_vocab_size=2, hidden=64,
             num_layers=4, num_heads=4, ffn_hidden=128, dtype="float32",
             remat="nothing")


def _cfgs(**kw):
    return (JaxBertConfig(**{**SMALL, **kw}), BertConfig(**{**SMALL, **kw}))


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


def _mlm_batch(bs=8, seq=32, seed=0, mask_rate=0.2, vocab=256):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (bs, seq)).astype(np.int32)
    mask = rng.rand(bs, seq) < mask_rate
    labels = np.where(mask, tokens, -100).astype(np.int32)
    corrupted = np.where(mask, vocab - 1, tokens).astype(np.int32)
    return corrupted, labels


def test_configs_and_init_are_the_jax_ones():
    for name, jc in JAX_BERT_CONFIGS.items():
        assert dataclasses.asdict(BERT_CONFIGS[name]) == \
            dataclasses.asdict(jc), name
    jcfg, cfg = _cfgs(dtype="bfloat16")
    ref = _flat(jax_bert_init(jcfg, jax.random.key(0)))
    ours = _flat(bert_init(cfg, torch.Generator().manual_seed(0),
                           device="cpu"))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape, k
        assert ours[k].dtype == torch.bfloat16, k
    stds = {"wte": 0.02, "wpe": 0.01, "mlm_w": 0.02, "blocks/qkv_w": 0.02,
            "blocks/down_w": 0.02 / math.sqrt(2 * cfg.num_layers)}
    for k, std in stds.items():
        assert abs(float(ours[k].float().std()) / std - 1) < 0.05, k
    for k in ("emb_ln_g", "mlm_ln_g", "blocks/ln1_g"):
        assert bool((ours[k] == 1).all()), k
    for k in ("emb_ln_b", "mlm_b", "blocks/qkv_b", "blocks/up_b"):
        assert not ours[k].any(), k


@pytest.mark.parametrize("types", [False, True])
def test_bert_loss_and_grads_match_jax(types):
    """The MLM loss and every gradient at 1e-4, with segment 0 and with
    explicit two-segment ``token_type_ids``."""
    jcfg, cfg = _cfgs()
    jparams = jax_bert_init(jcfg, jax.random.key(1))
    params = params_from_jax(jparams, device="cpu")
    tokens, labels = _mlm_batch(bs=4, seq=48, seed=1)
    tt = None
    if types:
        tt = np.zeros_like(tokens)
        tt[:, 20:] = 1
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_bert_loss(jcfg, p, jnp.asarray(tokens),
                                jnp.asarray(labels),
                                None if tt is None else jnp.asarray(tt)))(
        jparams)
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = bert_loss(cfg, params, torch.from_numpy(tokens),
                     torch.from_numpy(labels),
                     None if tt is None else torch.from_numpy(tt))
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    grads_j = _np(grads_j)
    assert grads.keys() == grads_j.keys()
    assert bool(grads["wtt"][1].abs().sum() > 0) == types
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), grads_j[k], **TOL, err_msg=k)


def test_flash_noncausal_matches_naive_route():
    """Flash attention without the causal mask (the plain version on the
    CPU) against the naive route: output and q/k/v gradients at 1e-5."""
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((2, 12, 128, 64), generator=g)
                   for _ in range(4))
    outs = []
    for fn in (lambda *a: flash_attention(*a, causal=False),
               lambda *a: _naive_attention(*a, causal=False,
                                           training=False)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        outs.append([out.detach()] + list(torch.autograd.grad(
            out, leaves, do)))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)


STEPS, LR = 3, 1e-3
ENGINE_CASES = {
    # the JAX BERT engine suite's configuration (naive attention, S 32)
    "naive": (dict(use_flash=False), dict(bs=8, seq=32)),
    # the port on flash attention, non-causal (S a multiple of 128),
    # remat dots.  The JAX engine runs the same function on its naive
    # route: its interpret-mode Pallas flash fails a varying-axes check
    # inside the engine's shard_map on the CPU for this input
    "flash_dots": (dict(use_flash=True, remat="dots"), dict(bs=2, seq=128)),
}


@pytest.fixture(scope="module", params=sorted(ENGINE_CASES))
def engine_runs(request):
    """3 steps of the JAX single-device engine and the port's, from the
    same params and MLM batch."""
    ckw, bkw = ENGINE_CASES[request.param]
    cfg = _cfgs(**ckw)[1]
    jcfg = _cfgs(**{**ckw, "use_flash": False})[0]
    tokens, labels = _mlm_batch(**bkw)
    jeng = JaxEngine(JaxBert(jcfg), devices=jax.devices()[:1])
    jp, jo = jeng.init(seed=0)
    params = params_from_jax(jp, device="cpu")
    canon0 = opt_from_jax(jeng.opt_canonical()(jo["slots"], jp),
                          device="cpu")
    jlosses = []
    for _ in range(STEPS):
        jp, jo, loss = jeng.step(jp, jo, tokens, labels, lr=LR)
        jlosses.append(float(loss))
    jcanon = jeng.opt_canonical()(jo["slots"], jp)

    eng = HybridEngine(BertAdapter(cfg), device="cpu")
    opt = eng.opt_from_canonical(canon0, step=0)
    p0 = {k: v.clone() for k, v in _flat(params).items()}
    with torch.no_grad():
        ref = float(eng.model.reference_loss(params,
                                             torch.from_numpy(tokens),
                                             torch.from_numpy(labels)))
    losses = []
    for _ in range(STEPS):
        params, opt, loss = eng.step(params, opt, tokens, labels, lr=LR)
        losses.append(float(loss))
    canon = eng.opt_canonical(opt, params)
    return dict(jlosses=jlosses, losses=losses, ref=ref, jparams=_np(jp),
                params=_flat(params_to_numpy(params)), p0=p0,
                jcanon={k: _np(v) for k, v in jcanon.items()},
                canon={k: _flat(params_to_numpy(v))
                       for k, v in canon.items()})


def test_engine_losses_match_jax(engine_runs):
    """atol 2e-4 (the JAX engine suite's); the first equals the adapter's
    ``reference_loss`` (``bert_loss``) at 1e-4 and the loss falls."""
    np.testing.assert_allclose(engine_runs["losses"], engine_runs["jlosses"],
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(engine_runs["losses"][0], engine_runs["ref"],
                               **TOL)
    assert engine_runs["losses"][-1] < engine_runs["losses"][0]


def test_engine_params_match_jax(engine_runs):
    """As ``test_torch_train.py``: every element within STEPS·lr, and the
    updates agree to 2e-5 + 1e-2 relative on 99.9 % of every leaf's
    elements."""
    jp, p, p0 = (engine_runs[k] for k in ("jparams", "params", "p0"))
    assert jp.keys() == p.keys()
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
