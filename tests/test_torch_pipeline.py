"""The port's pipeline parallelism (``HybridEngine`` at pp > 1, GPipe and
1F1B over a world of ranks) against the JAX engine, mirroring
``tests/test_1f1b.py``: at that file's ``CFG`` over 3 steps every mesh
matches the single-device JAX baseline (losses at the JAX tests' 2e-4
absolute / 1e-4 relative, gathered params at 5e-4), the static tick grid
is the JAX one, and 1F1B's saved stage inputs stay flat in the number of
microbatches while GPipe's grow.

The port's ranks are one 4-rank CPU world (gloo, ``torch_world``);
parameters come from the JAX engine's ``init(seed=0)`` through
``params_from_jax`` and the engine's ``shard_params``."""

import numpy as np
import pytest

import jax

from paddle_tpu.distributed.engine import EngineConfig as JaxEngineConfig
from paddle_tpu.distributed.engine import HybridEngine as JaxEngine
from paddle_tpu.distributed.engine import \
    _1f1b_schedule as jax_1f1b_schedule
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig

from paddle_tpu_torch.distributed.engine import _1f1b_schedule
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


def _run(world, axes, params, ec, model=MODEL, batch=None, dropout=False,
         out="params"):
    return world.run("torch_dist_cases", "engine_steps", model, axes,
                     params, *(batch or _batch()), 3, 1e-3, ec, dropout,
                     out)


@pytest.mark.parametrize("pp,M", [(2, 2), (2, 4), (2, 8), (3, 3), (3, 6),
                                  (4, 4), (4, 8), (4, 16), (8, 8), (8, 32)])
def test_schedule_is_the_jax_schedule(pp, M):
    """The tick grid, copied: equal to JAX's, every microbatch once a
    stage, at most ``pp - i`` in flight on stage i, and one mailbox per
    direction enough (``_check_mailboxes`` raises otherwise)."""
    f, b = _1f1b_schedule(pp, M)
    jf, jb = jax_1f1b_schedule(pp, M)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(b, jb)
    for i in range(pp):
        assert sorted(m for m in f[:, i] if m >= 0) == list(range(M))
        infl = peak = 0
        for t in range(f.shape[0]):
            infl += int(f[t, i] >= 0) - int(b[t, i] >= 0)
            peak = max(peak, infl)
        assert peak <= pp - i


@pytest.mark.parametrize("pp,schedule,M", [
    (2, "1f1b", 4), (2, "gpipe", 4), (4, "1f1b", 8), (4, "gpipe", 8)],
    ids=["pp2-1f1b", "pp2-gpipe", "pp4-1f1b", "pp4-gpipe"])
def test_pipeline_matches_single_device_baseline(world, baseline, pp,
                                                 schedule, M):
    losses, params0, final = baseline
    res = _run(world, dict(pp=pp), params0,
               {"num_microbatches": M, "pipeline_schedule": schedule},
               out="both")
    for r in res[:pp]:
        np.testing.assert_allclose(r["losses"], losses, **LOSS_TOL)
    _close_params(res[0]["params"], final, 5e-4)
    # each stage holds its L/pp layers only
    for r in res[:pp]:
        assert r["shards"]["blocks"]["qkv_w"].shape[0] == \
            KW["num_layers"] // pp


def test_pp4_1f1b_matches_gpipe(world, baseline):
    _, params0, _ = baseline
    a = _run(world, dict(pp=4), params0, {"num_microbatches": 8})
    b = _run(world, dict(pp=4), params0, {"num_microbatches": 8,
                                          "pipeline_schedule": "gpipe"})
    np.testing.assert_allclose(a[0]["losses"], b[0]["losses"], **LOSS_TOL)
    _close_params(a[0]["params"], b[0]["params"], 1e-4)


@pytest.mark.parametrize("axes", [dict(pp=2, mp=2), dict(dp=2, pp=2)],
                         ids=["pp2xmp2", "dp2xpp2"])
def test_pipeline_with_other_axes_matches(world, baseline, axes):
    losses, params0, final = baseline
    res = _run(world, axes, params0, {"num_microbatches": 2})
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, **LOSS_TOL)
    _close_params(res[0]["params"], final, 5e-4)


def test_pp2_mp2_matches_jax_engine_on_the_same_mesh(world):
    """pp 2 × mp 2 against the JAX engine's own pp 2 × mp 2 (1F1B)."""
    ec = {"num_microbatches": 4}
    losses, params0, final = _jax_run(KW, _batch(), ec=ec, pp=2, mp=2)
    res = _run(world, dict(pp=2, mp=2), params0, ec)
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, **LOSS_TOL)
    _close_params(res[0]["params"], final, 1e-4)


def test_moe_gpt_trains_at_pp2_gpipe(world):
    """A MoE GPT (4 experts, top-2) at pp = 2 takes the GPipe loop (as
    ``_use_1f1b`` says, also under ``pipeline_schedule="1f1b"``) and
    matches the JAX engine at pp = 2: each microbatch gates on its own
    tokens and the aux loss is averaged over the microbatches, so the
    oracle is the JAX pipeline, not one device."""
    kw = dict(KW, moe_experts=4, moe_capacity_factor=2.0)
    ec = {"num_microbatches": 2}
    losses, params0, final = _jax_run(kw, _batch(), ec=ec, pp=2)
    res = _run(world, dict(pp=2), params0, ec, model=("gpt", "tiny", kw))
    for r in res[:2]:
        np.testing.assert_allclose(r["losses"], losses, **LOSS_TOL)
    _close_params(res[0]["params"], final, 1e-4)
    one, _, _ = _jax_run(kw, _batch())
    np.testing.assert_allclose(res[0]["losses"], one, **LOSS_TOL)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_dropout_masks_follow_the_microbatch(world, baseline, schedule):
    """With dropout, a block's mask is drawn from the step's key folded
    with the microbatch and then the GLOBAL layer index, never the rank:
    pp = 2 and pp = 4 over the same microbatches train to the same
    losses and params."""
    _, params0, _ = baseline
    model = ("gpt", "tiny", dict(KW, dropout=0.1))
    ec = {"num_microbatches": 4, "pipeline_schedule": schedule}
    two = _run(world, dict(pp=2), params0, ec, model=model, dropout=True)
    four = _run(world, dict(pp=4), params0, ec, model=model, dropout=True)
    np.testing.assert_allclose(two[0]["losses"], four[0]["losses"],
                               **LOSS_TOL)
    _close_params(two[0]["params"], four[0]["params"], 1e-4)
    # and the masks do act: the losses differ from the dropout-free run
    plain = _run(world, dict(pp=2), params0, ec)
    assert abs(plain[0]["losses"][0] - two[0]["losses"][0]) > 1e-3


def test_1f1b_activation_memory_flat_in_num_microbatches(world, baseline):
    """At a fixed microbatch size, 4× the microbatches leaves 1F1B's
    ring of saved stage inputs where it was (at most pp - i on stage i)
    while GPipe keeps every microbatch's stage graph alive."""
    _, params0, _ = baseline
    peaks = {}
    for schedule in ("1f1b", "gpipe"):
        for M in (4, 16):
            res = world.run("torch_dist_cases", "pipeline_stats", MODEL,
                            dict(pp=2), params0, *_batch(2 * M),
                            {"num_microbatches": M,
                             "pipeline_schedule": schedule})
            peaks[schedule, M] = [r["live_peak"] for r in res[:2]]
    assert peaks["1f1b", 4] == peaks["1f1b", 16] == [2, 1]
    assert peaks["gpipe", 4] == [4, 4] and peaks["gpipe", 16] == [16, 16]
