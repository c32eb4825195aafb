"""The port's ``HybridEngine`` across a world of ranks against the JAX
engine, mirroring ``tests/test_hybrid_engine.py``: at that file's
``CFG`` over 3 steps every mesh must match the single-device JAX
baseline (losses at the JAX tests' 2e-4 absolute / 1e-4 relative, the
gathered params at 5e-4 as ``test_params_stay_synced`` holds them), and
one mesh, dp 2 × mp 2, matches the JAX engine on the same mesh (gathered
params at 1e-4).

The port's ranks are one 4-rank CPU world (gloo, ``torch_world``); a
2-rank mesh runs on ranks 0-1.  Parameters come from the JAX engine's
``init(seed=0)`` through ``params_from_jax`` and the engine's
``shard_params``.  The ring (``seq_parallel="ring"``) needs 128 tokens a
shard, so it runs on ``CFG`` with 256 positions against its own JAX
baseline."""

import numpy as np
import pytest

import jax

from paddle_tpu.distributed.engine import HybridEngine as JaxEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig

import torch

from paddle_tpu_torch.distributed import EngineConfig, HybridEngine
from paddle_tpu_torch.models import (gpt_init, params_from_jax,
                                     params_to_numpy)
from torch_dist_cases import model_of
from torch_world import World

KW = dict(vocab_size=256, max_seq_len=64, hidden=64, num_layers=4,
          num_heads=4, ffn_hidden=128, dtype="float32", use_flash=False,
          remat="nothing")
RING_KW = dict(KW, max_seq_len=256, seq_parallel="ring")
MODEL = ("gpt", "tiny", KW)
RING = ("gpt", "tiny", RING_KW)
LOSS_TOL = dict(atol=2e-4, rtol=1e-4)


def _batch(bs=8, seq=32, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, KW["vocab_size"], (bs, seq)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((bs, 1), -100)],
                            axis=1).astype(np.int32)
    return tokens, labels


def _jax_run(kw, batch, steps=3, **mesh):
    """Losses, initial params and gathered final params of the JAX
    engine (seed 0, lr 1e-3)."""
    eng = JaxEngine(JaxGPTConfig(**kw), **mesh,
                    devices=jax.devices()[:int(np.prod(
                        list(mesh.values()) or [1]))])
    params, opt = eng.init(seed=0)
    params0 = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                     params)
    losses = []
    for _ in range(steps):
        params, opt, loss = eng.step(params, opt, *batch, lr=1e-3)
        losses.append(float(loss))
    final = jax.tree_util.tree_map(np.asarray, eng.gather_params(params))
    return losses, params0, final


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


@pytest.fixture(scope="module")
def baseline():
    return _jax_run(KW, _batch())


@pytest.fixture(scope="module")
def ring_baseline():
    return _jax_run(RING_KW, _batch(4, 256))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _close_params(got, want, atol):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol,
                                   rtol=0, err_msg=k)


def _run(world, model, axes, params, batch, **kw):
    return world.run("torch_dist_cases", "engine_steps", model, axes,
                     params, *batch, 3, 1e-3, kw.get("ec"), False,
                     kw.get("out", "params"))


def test_one_process_engine_matches_jax_baseline(baseline):
    """The oracle: the port's one-process engine on the JAX baseline's
    params and batch."""
    losses, params0, final = baseline
    eng = HybridEngine(model_of(MODEL), device="cpu")
    p = params_from_jax(params0, device="cpu")
    o = eng.init_opt(p)
    got = []
    for _ in range(3):
        p, o, loss = eng.step(p, o, *_batch(), lr=1e-3)
        got.append(float(loss))
    np.testing.assert_allclose(got, losses, **LOSS_TOL)
    assert abs(losses[0] - np.log(KW["vocab_size"])) < 1.0
    assert got[-1] < got[0]
    _close_params(params_to_numpy(p), final, 5e-4)


MESHES = [dict(dp=4), dict(mp=2), dict(mp=4), dict(sharding=2),
          dict(sharding=4), dict(sep=2), dict(dp=2, sharding=2),
          dict(sharding=2, mp=2), dict(dp=2, mp=2), dict(dp=2, sep=2),
          dict(sep=2, mp=2), dict(dp=2, sharding=2, sep=1, mp=1)]


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
def test_mesh_matches_single_device_baseline(world, baseline, axes):
    losses, params0, final = baseline
    res = _run(world, MODEL, axes, params0, _batch())
    n = int(np.prod(list(axes.values())))
    for r in res[:n]:
        np.testing.assert_allclose(r["losses"], losses, **LOSS_TOL)
    _close_params(res[0]["params"], final, 5e-4)


@pytest.mark.parametrize("axes", [dict(sep=2), dict(sep=2, dp=2),
                                  dict(sep=2, mp=2)],
                         ids=["sep2", "sep2xdp2", "sep2xmp2"])
def test_ring_across_ranks_matches_baseline(world, ring_baseline, axes):
    """The ring across ranks (K/V and their dK/dV sums passed rank to
    rank) on 256 positions, 128 a shard."""
    losses, params0, final = ring_baseline
    res = _run(world, RING, axes, params0, _batch(4, 256))
    n = int(np.prod(list(axes.values())))
    for r in res[:n]:
        np.testing.assert_allclose(r["losses"], losses, **LOSS_TOL)
    _close_params(res[0]["params"], final, 5e-4)


def test_ring_four_ranks_matches_one_device(world):
    """sep = 4 across ranks equals the port's one-device ring at sep = 4
    (PR 3's engine) on 512 positions."""
    model = ("gpt", "tiny", dict(RING_KW, max_seq_len=512))
    params = params_to_numpy(gpt_init(model_of(model),
                                      torch.Generator().manual_seed(0),
                                      device="cpu"))
    batch = _batch(2, 512)
    eng = HybridEngine(model_of(model), sep=4, device="cpu")
    assert eng.local_sep == 4 and not eng.distributed
    p = params_from_jax(params, device="cpu")
    o = eng.init_opt(p)
    want = []
    for _ in range(3):
        p, o, loss = eng.step(p, o, *batch, lr=1e-3)
        want.append(float(loss))
    res = _run(world, model, dict(sep=4), params, batch)
    for r in res:
        np.testing.assert_allclose(r["losses"], want, **LOSS_TOL)
    _close_params(res[0]["params"], params_to_numpy(p), 1e-4)


@pytest.mark.parametrize("axes,accum", [(dict(dp=2, mp=2), 2),
                                        (dict(sharding=2, mp=2), 2),
                                        (dict(dp=4), 2)],
                         ids=["dp2xmp2", "sharding2xmp2", "dp4"])
def test_grad_accum_matches(world, baseline, axes, accum):
    losses, params0, _ = baseline
    res = _run(world, MODEL, axes, params0, _batch(),
               ec={"accum_steps": accum})
    for r in res[:int(np.prod(list(axes.values())))]:
        np.testing.assert_allclose(r["losses"], losses, **LOSS_TOL)


def test_params_stay_synced(world, baseline):
    """dp replicas hold bitwise-equal shards after 3 steps; mp ranks hold
    different ones; the gathered params match the baseline."""
    losses, params0, final = baseline
    res = _run(world, MODEL, dict(dp=2, mp=2), params0, _batch(),
               out="both")
    by = {(r["coords"]["dp"], r["coords"]["mp"]): r for r in res}
    for mp_i in range(2):
        a, b = _flat(by[(0, mp_i)]["shards"]), _flat(by[(1, mp_i)]["shards"])
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    a, b = _flat(by[(0, 0)]["shards"]), _flat(by[(0, 1)]["shards"])
    assert not np.array_equal(a["blocks/qkv_w"], b["blocks/qkv_w"])
    _close_params(res[0]["params"], final, 5e-4)


def test_dp2_mp2_matches_jax_engine_on_the_same_mesh(world):
    """The same mesh on both sides: losses and gathered params at 1e-4."""
    losses, params0, final = _jax_run(KW, _batch(), dp=2, mp=2)
    res = _run(world, MODEL, dict(dp=2, mp=2), params0, _batch())
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, **LOSS_TOL)
        _close_params(r["params"], final, 1e-4)


def test_dropout_masks_follow_data_coordinates(world, baseline):
    """With dropout the key is folded with the dp coordinate and never
    with mp: mp ranks draw the same mask, dp ranks different ones."""
    _, params0, _ = baseline
    model = ("gpt", "tiny", dict(KW, dropout=0.1))
    res = world.run("torch_dist_cases", "dropout_masks", model,
                    dict(dp=2, mp=2), params0, *_batch())
    by = {(r["coords"]["dp"], r["coords"]["mp"]): r for r in res}
    for dp_i in range(2):
        np.testing.assert_array_equal(by[(dp_i, 0)]["mask"],
                                      by[(dp_i, 1)]["mask"])
    assert not np.array_equal(by[(0, 0)]["mask"], by[(1, 0)]["mask"])
    assert 0.8 < by[(0, 0)]["mask"].mean() < 0.98


def test_pipeline_and_zero3_raise_naming_the_next_slice():
    cfg = model_of(MODEL)
    with pytest.raises(NotImplementedError, match="next multi-GPU slice"):
        HybridEngine(cfg, pp=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ZeRO-3"):
        HybridEngine(cfg, sharding=2, device="cpu",
                     engine_cfg=EngineConfig(zero_stage=3))
    with pytest.raises(NotImplementedError, match="needs 2 ranks"):
        HybridEngine(cfg, dp=2, device="cpu")
