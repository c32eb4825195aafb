"""Fleet across ranks (``paddle_tpu_torch.distributed.{fleet,parallel}``)
against the JAX package's rules and ``tests/test_meta_optimizers.py``'s
expectations, in one 4-rank CPU world (gloo):

- ``fleet.init``: dp absorbs the ranks the other degrees leave
  (``fleet_base.py``'s rule), the parallel mode and the dp groups;
- ``DataParallel``: the averaged gradient equals the whole batch's on
  one process (1e-6);
- ``HybridParallelOptimizer`` with each sync: the plain mean, bf16 on
  the wire (the mean of bf16-rounded gradients, to bf16's precision), DGC
  (what is sent plus what stays equals the gradient, the top quarter
  sent) and LocalSGD (params averaged every k steps); every one trains
  (finite, falling losses) and leaves the ranks with equal params where
  it syncs every step;
- ``engine_config_from_strategy`` equals the JAX mapping."""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.fleet import DistributedStrategy as JaxStrategy
from paddle_tpu.distributed.fleet import \
    engine_config_from_strategy as jax_engine_config

import paddle_tpu_torch as paddle
from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                engine_config_from_strategy)
from torch_dist_cases import _mlp
from torch_world import World

N = 4


@pytest.fixture(scope="module")
def world():
    w = World(N)
    yield w
    w.close()


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    return (rng.randn(16, 8).astype(np.float32),
            rng.randint(0, 4, (16,)).astype(np.int64))


@pytest.mark.parametrize("hybrid,want", [
    ({}, dict(dp_degree=4)),
    ({"mp_degree": 2}, dict(dp_degree=2, mp_degree=2)),
    ({"dp_degree": 4}, dict(dp_degree=4)),
    ({"sharding_degree": 2, "dp_degree": 8}, dict(dp_degree=2,
                                                  sharding_degree=2)),
    ({"sep_degree": 4}, dict(dp_degree=1, sep_degree=4))],
    ids=["default", "mp2", "dp4", "sharding2", "sep4"])
def test_fleet_init_degrees(world, hybrid, want):
    """dp takes what the others leave of the world (4), as the JAX
    ``Fleet.init`` does with the device count (the default strategy is
    dp over the world)."""
    res = world.run("torch_dist_cases", "fleet_init_case", hybrid)
    for r, got in enumerate(res):
        for k, v in want.items():
            assert got["degrees"][k] == v, (k, got["degrees"])
        assert got["worker"] == (r, N)
    mode = res[0]["mode"]
    assert mode == ("tensor_parallel" if "mp_degree" in want else
                    "sharding_parallel" if "sharding_degree" in want else
                    "single" if want.get("sep_degree") else "data_parallel")
    dp = want["dp_degree"]
    for r, got in enumerate(res):
        assert got["dp_group"] == list(range(r % (N // dp), N, N // dp))


def _full_batch_grads(x, y):
    paddle.set_device("cpu")
    m = _mlp(paddle, 7)
    loss = torch.nn.functional.cross_entropy(m(torch.from_numpy(x)),
                                             torch.from_numpy(y))
    return [g.numpy() for g in torch.autograd.grad(loss, list(
        m.parameters()))]


def test_data_parallel_grads_equal_the_whole_batch(world, data):
    x, y = data
    want = _full_batch_grads(x, y)
    res = world.run("torch_dist_cases", "fleet_train_case", None, x, y)
    for r in res:
        for g, w in zip(r["first_grads"], want):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("knob", [None, "fp16_allreduce", "dgc",
                                  "localsgd"])
def test_hybrid_optimizer_syncs_train(world, data, knob):
    x, y = data
    res = world.run("torch_dist_cases", "fleet_train_case", knob, x, y, 4)
    for r in res:
        assert all(np.isfinite(r["losses"])), knob
        assert r["losses"][-1] < r["losses"][0], knob
    # every sync but LocalSGD's leaves equal grads on every rank each
    # step; LocalSGD averages the params at step 4 (k = 2)
    for r in res[1:]:
        for a, b in zip(r["params"], res[0]["params"]):
            np.testing.assert_array_equal(a, b)


def _rank_grads(seed=1):
    rng = np.random.RandomState(seed)
    return [[rng.randn(4, 8).astype(np.float32),
             rng.randn(8).astype(np.float32)] for _ in range(N)]


def test_plain_and_bf16_syncs_give_the_mean(world):
    grads = _rank_grads()
    mean = [np.mean([g[i] for g in grads], axis=0) for i in range(2)]
    res = world.run("torch_dist_cases", "meta_sync_case", "plain", grads)
    for r in res:
        for a, b in zip(r["grads"], mean):
            np.testing.assert_allclose(a, b, atol=1e-6)
    res = world.run("torch_dist_cases", "meta_sync_case", "bf16", grads)
    for r in res:
        for a, b in zip(r["grads"], mean):
            # bf16 on the wire: 8 mantissa bits for each of 4 terms
            np.testing.assert_allclose(a, b, atol=4e-2, rtol=2e-2)
            assert not np.array_equal(a, b)


def test_dgc_sends_the_top_share_and_keeps_the_rest(world):
    """Each rank's residual plus what it sent equals its gradient (the
    sent parts summed over ranks and averaged are the synced grad), and
    at most the top quarter of each leaf (ties aside) leaves a rank."""
    grads = _rank_grads(2)
    res = world.run("torch_dist_cases", "meta_sync_case", "dgc", grads)
    sent = [[g - r for g, r in zip(grads[k], res[k]["residual"])]
            for k in range(N)]
    for k in range(N):
        for i, s in enumerate(sent[k]):
            assert (s != 0).sum() <= int(np.ceil(s.size * 0.25)) + 1
            np.testing.assert_allclose(s + res[k]["residual"][i],
                                       grads[k][i], atol=1e-7)
    for r in res:
        for i in range(2):
            np.testing.assert_allclose(
                r["grads"][i], np.mean([sent[k][i] for k in range(N)], 0),
                atol=1e-6)


def test_strategy_maps_onto_the_engine_config_as_jax():
    for setup in (lambda s: None,
                  lambda s: (setattr(s, "pipeline", True),
                             s.pipeline_configs.update(
                                 accumulate_steps=4,
                                 schedule_mode="F-then-B")),
                  lambda s: (setattr(s, "sharding", True),
                             s.sharding_configs.update(stage=3)),
                  lambda s: (setattr(s, "gradient_merge", True),
                             s.gradient_merge_configs.update(k_steps=3))):
        js, ps = JaxStrategy(), DistributedStrategy()
        setup(js)
        setup(ps)
        assert dataclasses.asdict(engine_config_from_strategy(ps)) == \
            dataclasses.asdict(jax_engine_config(js))
        assert ps.hybrid_configs == js.hybrid_configs


def test_pipeline_mode_raises_naming_the_next_slice(world):
    """``distributed_model`` on a pipeline layout is the next slice."""
    from paddle_tpu_torch.distributed import fleet

    with pytest.raises(NotImplementedError, match="next slice"):
        class _HCG:
            def get_parallel_mode(self):
                return "pipeline_parallel"
        saved = fleet.fleet_base._hcg[0]
        fleet.fleet_base._hcg[0] = _HCG()
        try:
            fleet.distributed_model(None)
        finally:
            fleet.fleet_base._hcg[0] = saved
