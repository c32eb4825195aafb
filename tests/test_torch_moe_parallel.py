"""MoE and BERT across ranks, and MoE at sep > 1, against the JAX engine
(mirroring ``tests/test_moe.py``'s engine cases and ROADMAP item 4).

- Expert parallelism: ``HybridEngine(ep=2)`` (and ep 2 × dp 2, ep 4) on
  a 4-expert top-2 MoE at capacity factor 1.0, where tokens drop,
  against the JAX engine on the same mesh: each rank gates its own
  tokens, so only the same mesh is the same function.
- MoE at sep = 2 (the ring): the port's one-device ring and its ring
  across ranks against the JAX engine at sep = 2, at the same dropping
  capacity.  Each sep shard is gated on its own (its capacity from its
  own tokens, the aux loss averaged over shards); gating the whole
  sequence at once is a different function, which the last test shows.
- BERT at Ulysses sep = 2 (the ring is causal-only) against the JAX
  engine at sep = 2.

Losses at the JAX tests' 2e-4 absolute / 1e-4 relative, gathered params
at 1e-4.  The port's ranks are one 4-rank CPU world (gloo)."""
import dataclasses

import numpy as np
import pytest

import jax

from paddle_tpu.distributed.engine import HybridEngine as JaxEngine
from paddle_tpu.distributed.model_adapter import BertAdapter as JaxBert
from paddle_tpu.models.bert import BERT_CONFIGS as JAX_BERT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig

from paddle_tpu_torch.distributed import HybridEngine
from paddle_tpu_torch.models import params_from_jax, params_to_numpy
from torch_dist_cases import model_of
from torch_world import World

KW = dict(vocab_size=256, max_seq_len=64, hidden=64, num_layers=4,
          num_heads=4, ffn_hidden=128, dtype="float32", use_flash=False,
          remat="nothing", moe_experts=4, moe_capacity_factor=1.0)
RING_KW = dict(KW, max_seq_len=256, seq_parallel="ring")
BERT_KW = dict(dtype="float32", use_flash=False, remat="nothing")
LOSS_TOL = dict(atol=2e-4, rtol=1e-4)


def _batch(bs, seq, vocab=256, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (bs, seq)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((bs, 1), -100)],
                            axis=1).astype(np.int32)
    return tokens, labels


def _mlm_batch(bs=8, seq=32, seed=0, mask_rate=0.2, vocab=256):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (bs, seq)).astype(np.int32)
    mask = rng.rand(bs, seq) < mask_rate
    labels = np.where(mask, tokens, -100).astype(np.int32)
    return np.where(mask, vocab - 1, tokens).astype(np.int32), labels


def _jax_run(model, batch, **mesh):
    n = int(np.prod(list(mesh.values()) or [1]))
    eng = JaxEngine(model, **mesh, devices=jax.devices()[:n])
    params, opt = eng.init(seed=0)
    params0 = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                     params)
    losses = []
    for _ in range(3):
        params, opt, loss = eng.step(params, opt, *batch, lr=1e-3)
        losses.append(float(loss))
    return losses, params0, jax.tree_util.tree_map(
        np.asarray, eng.gather_params(params))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _close(got, want, atol=1e-4):
    got, want = _flat(got), _flat(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol,
                                   rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


def _world_run(world, model, axes, params, batch):
    return world.run("torch_dist_cases", "engine_steps", model, axes,
                     params, *batch)


@pytest.mark.parametrize("axes", [dict(ep=2), dict(dp=2, ep=2), dict(ep=4),
                                  dict(ep=2, mp=2)],
                         ids=["ep2", "dp2xep2", "ep4", "ep2xmp2"])
def test_expert_parallel_matches_jax_engine(world, axes):
    batch = _batch(8, 32)
    losses, params0, final = _jax_run(JaxGPTConfig(**KW), batch, **axes)
    res = _world_run(world, ("gpt", "tiny", KW), axes, params0, batch)
    for r in res[:int(np.prod(list(axes.values())))]:
        np.testing.assert_allclose(r["losses"], losses, **LOSS_TOL)
    _close(res[0]["params"], final)


@pytest.fixture(scope="module")
def moe_sep2():
    return _jax_run(JaxGPTConfig(**RING_KW), _batch(4, 256), sep=2)


def _one_device(model, params, batch, sep):
    eng = HybridEngine(model_of(model), sep=sep, device="cpu")
    p = params_from_jax(params, device="cpu")
    o = eng.init_opt(p)
    losses = []
    for _ in range(3):
        p, o, loss = eng.step(p, o, *batch, lr=1e-3)
        losses.append(float(loss))
    return losses, params_to_numpy(p)


def test_moe_sep2_one_device_ring_matches_jax(moe_sep2):
    """Item 4 on one device: each of the two ring shards gated on its
    own, on the flash/ring route of one process."""
    losses, params0, final = moe_sep2
    got, params = _one_device(("gpt", "tiny", RING_KW), params0,
                              _batch(4, 256), 2)
    np.testing.assert_allclose(got, losses, **LOSS_TOL)
    _close(params, final)


@pytest.mark.parametrize("axes", [dict(sep=2), dict(sep=2, dp=2),
                                  dict(sep=2, ep=2)],
                         ids=["sep2", "sep2xdp2", "sep2xep2"])
def test_moe_sep2_across_ranks_matches_jax(world, moe_sep2, axes):
    """Item 4 across ranks: the ring passes K/V between the sep ranks and
    each rank gates its own shard.  At sep 2 × dp 2 / ep 2 the JAX engine
    runs the same mesh."""
    batch = _batch(4, 256)
    if axes == dict(sep=2):
        losses, params0, final = moe_sep2
    else:
        losses, params0, final = _jax_run(JaxGPTConfig(**RING_KW), batch,
                                          **axes)
    res = _world_run(world, ("gpt", "tiny", RING_KW), axes, params0, batch)
    for r in res[:int(np.prod(list(axes.values())))]:
        np.testing.assert_allclose(r["losses"], losses, **LOSS_TOL)
    _close(res[0]["params"], final)


def test_moe_gating_is_per_shard(moe_sep2):
    """Gating the whole sequence at once (sep 1) is a different function
    at this capacity: its losses leave the JAX sep = 2 run's tolerance,
    so the sep = 2 matches above are the per-shard gating's."""
    losses, params0, final = moe_sep2
    got, params = _one_device(("gpt", "tiny", dict(
        RING_KW, seq_parallel="ulysses")), params0, _batch(4, 256), 1)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, losses, **LOSS_TOL)
    with pytest.raises(AssertionError):
        _close(params, final)


@pytest.mark.parametrize("axes", [dict(sep=2), dict(sep=2, dp=2),
                                  dict(sep=2, mp=2)],
                         ids=["sep2", "sep2xdp2", "sep2xmp2"])
def test_bert_ulysses_sep2_matches_jax(world, axes):
    jmodel = JaxBert(dataclasses.replace(JAX_BERT["tiny"], **BERT_KW))
    batch = _mlm_batch()
    losses, params0, final = _jax_run(jmodel, batch, **axes)
    res = _world_run(world, ("bert", "tiny", BERT_KW), axes, params0, batch)
    for r in res[:int(np.prod(list(axes.values())))]:
        np.testing.assert_allclose(r["losses"], losses, **LOSS_TOL)
    _close(res[0]["params"], final)
