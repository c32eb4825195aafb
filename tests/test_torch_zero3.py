"""The port's ZeRO-3 (``HybridEngine(zero_stage=3)`` at sharding > 1 over
a world of ranks) against the JAX engine, mirroring
``tests/test_hybrid_engine.py``'s ZeRO-3 tests and
``tests/test_1f1b.py::test_pp2_zero3_matches`` with their meshes cut to
at most 4 ranks: 3 steps against the single-device JAX baseline (losses
at 2e-4 absolute / 1e-4 relative, gathered params at 5e-4), each matrix
leaf held as this rank's ``1/sharding`` slice, and less persistent state
a rank than ZeRO-2's.

One 4-rank CPU world (gloo, ``torch_world``); parameters from the JAX
engine's ``init(seed=0)`` through ``params_from_jax`` and
``shard_params``."""

import numpy as np
import pytest

import jax

from paddle_tpu.distributed.engine import EngineConfig as JaxEngineConfig
from paddle_tpu.distributed.engine import HybridEngine as JaxEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig

from torch_world import World

KW = dict(vocab_size=256, max_seq_len=64, hidden=64, num_layers=4,
          num_heads=4, ffn_hidden=128, dtype="float32", use_flash=False,
          remat="nothing")
MODEL = ("gpt", "tiny", KW)
LOSS_TOL = dict(atol=2e-4, rtol=1e-4)


def _batch(bs=8, seq=32, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, KW["vocab_size"], (bs, seq)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((bs, 1), -100)],
                            axis=1).astype(np.int32)
    return tokens, labels


def _jax_run(kw, batch, steps=3, ec=None, **mesh):
    eng = JaxEngine(JaxGPTConfig(**kw), **mesh,
                    engine_cfg=JaxEngineConfig(**(ec or {})),
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


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


@pytest.fixture(scope="module")
def baseline():
    return _jax_run(KW, _batch())


Z3 = {"zero_stage": 3}


@pytest.mark.parametrize("axes,ec", [
    (dict(sharding=4), Z3),
    (dict(sharding=2, mp=2), Z3),
    (dict(pp=2, sharding=2), dict(Z3, num_microbatches=2)),
    (dict(sharding=2, mp=2), dict(Z3, accum_steps=2)),
    (dict(dp=2, sharding=2), Z3),
], ids=["sharding4", "sharding2xmp2", "pp2xsharding2",
        "sharding2xmp2-accum2", "dp2xsharding2"])
def test_zero3_matches_single_device_baseline(world, baseline, axes, ec):
    losses, params0, final = baseline
    res = world.run("torch_dist_cases", "engine_steps", MODEL, axes,
                    params0, *_batch(), 3, 1e-3, ec, False, "params")
    for r in res[:int(np.prod(list(axes.values())))]:
        np.testing.assert_allclose(r["losses"], losses, **LOSS_TOL)
    _close_params(res[0]["params"], final, 5e-4)


def test_zero3_matches_jax_engine_on_the_same_mesh(world):
    """sharding 2 × mp 2 at ZeRO-3 against the JAX engine on that mesh:
    losses and gathered params at 1e-4."""
    losses, params0, final = _jax_run(KW, _batch(), ec=Z3, sharding=2,
                                      mp=2)
    res = world.run("torch_dist_cases", "engine_steps", MODEL,
                    dict(sharding=2, mp=2), params0, *_batch(), 3, 1e-3,
                    Z3, False, "params")
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, **LOSS_TOL)
        _close_params(r["params"], final, 1e-4)


def test_zero3_param_leaves_are_slices(world, baseline):
    """Each rank holds 1/4 of ``qkv_w`` (its hidden dim over sharding),
    as ``test_zero3_param_leaves_sharded`` holds the JAX engine to."""
    _, params0, _ = baseline
    res = world.run("torch_dist_cases", "state_bytes", MODEL,
                    dict(sharding=4), params0, Z3)
    L, D = KW["num_layers"], KW["hidden"]
    for r in res:
        assert r["qkv_w"] == [L, D // 4, 3 * D]


def test_zero3_persistent_bytes_smaller_than_zero2(world, baseline):
    """Params and optimizer state a rank at sharding = 4: ZeRO-3 holds
    less than 0.65 of ZeRO-2's (``test_zero3_persistent_memory_smaller``'s
    bound; the matrix leaves go from (4 + 12/4) to (4 + 12)/4 bytes a
    parameter)."""
    _, params0, _ = baseline
    b2 = world.run("torch_dist_cases", "state_bytes", MODEL,
                   dict(sharding=4), params0, {"zero_stage": 2})
    b3 = world.run("torch_dist_cases", "state_bytes", MODEL,
                   dict(sharding=4), params0, Z3)
    for r2, r3 in zip(b2, b3):
        assert r3["bytes"] < 0.65 * r2["bytes"], (r3, r2)
