"""The port's pipeline layer API (``pp_layers``), fleet's pipeline mode
and the host-actor pipeline (``fleet_executor``) against the JAX
package, mirroring ``tests/test_pp_layers.py`` and
``tests/test_fleet_executor.py``: segment bounds equal to JAX's, the
staged layer equal to the sequential list, ``PipelineEngine`` at pp = 2
and 4 (one process a stage) within 2e-4 / 1e-4 of the JAX one-device
engine on the same weights, tied layers trained as one, and the
two-process ``PipelineStageExecutor`` within 1e-5 of the same two
stages run in one process.

The port's ranks are one 4-rank CPU world (gloo, ``torch_world``); the
JAX side's weights are carried into the port by layer and name."""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed.pp_layers import PipelineEngine as JaxEngine
from paddle_tpu.distributed.pp_layers import PipelineLayer as JaxLayer
from paddle_tpu.distributed.pp_layers import SegmentLayers as JaxSegment

import paddle_tpu_torch as paddle
from paddle_tpu_torch.distributed.fleet_executor import MessageBus
from paddle_tpu_torch.distributed.pp_layers import (PipelineEngine,
                                                    PipelineLayer,
                                                    SegmentLayers)
from paddle_tpu_torch.distributed.store import TCPStore
from torch_dist_cases import cnn_descs, tied_descs
from torch_world import World

paddle.set_device("cpu")
TOL = dict(atol=2e-4, rtol=1e-4)


def _batch(bs=8):
    rng = np.random.RandomState(0)
    x = rng.randn(bs, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, (bs,)).astype(np.int64)
    return x, y


def _jax_state(descs, seed, loss, x, y, lr, M=4, steps=3):
    """The JAX one-device engine's losses and its layers' starting
    weights (a logical per-layer list of numpy arrays)."""
    jpaddle.seed(seed)
    pl = JaxLayer(descs, num_stages=1, loss_fn=loss)
    eng = JaxEngine(pl, num_microbatches=M, devices=jax.devices()[:1])
    state0 = [{k: np.asarray(v) for k, v in d.items()} for d in eng.state()]
    state, losses = None, []
    for _ in range(steps):
        state, l = eng.train_batch(x, y, state, lr=lr)
        losses.append(float(l))
    return state0, losses


def _jax_cnn():
    from paddle_tpu.distributed.pp_layers import LayerDesc as D

    return [D(jnn.Conv2D, 1, 6, 5, padding=2), D(jnn.ReLU),
            D(jnn.MaxPool2D, kernel_size=2, stride=2),
            D(jnn.Conv2D, 6, 16, 5), D(jnn.ReLU),
            D(jnn.MaxPool2D, kernel_size=2, stride=2), D(jnn.Flatten),
            D(jnn.Linear, 16 * 5 * 5, 64), D(jnn.ReLU),
            D(jnn.Linear, 64, 10)]


def _jax_tied():
    from paddle_tpu.distributed.pp_layers import LayerDesc as D
    from paddle_tpu.distributed.pp_layers import SharedLayerDesc as S

    return [S("tied", jnn.Linear, 16, 16), D(jnn.ReLU),
            D(jnn.Linear, 16, 16), S("tied", jnn.Linear, 16, 16)]


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


@pytest.fixture(scope="module")
def cnn():
    x, y = _batch()
    state, losses = _jax_state(_jax_cnn(), 123, jnn.CrossEntropyLoss(),
                               x, y, 0.01)
    return state, losses, x, y


@pytest.mark.parametrize("parts", [2, 3, 4, 5])
@pytest.mark.parametrize("method", ["uniform", "parameter"])
def test_segment_bounds_equal_jax(method, parts):
    layers = [paddle.nn.Linear(64, 64), paddle.nn.Linear(4, 4),
              paddle.nn.Linear(4, 4), paddle.nn.Linear(4, 4),
              paddle.nn.Linear(8, 8)]
    jlayers = [jnn.Linear(64, 64), jnn.Linear(4, 4), jnn.Linear(4, 4),
               jnn.Linear(4, 4), jnn.Linear(8, 8)]
    got = SegmentLayers(layers, parts, method=method).do_segment()
    assert got == JaxSegment(jlayers, parts, method=method).do_segment()
    assert len(got) == parts + 1
    assert all(got[i] < got[i + 1] for i in range(parts))


def test_forward_matches_sequential_and_jax(cnn):
    """The one-device ``PipelineLayer`` runs its layers in order: equal to
    calling them one by one, and to the JAX layer on the same weights
    (1e-5)."""
    state, _, x, _ = cnn
    pl = PipelineLayer(cnn_descs(paddle.nn), num_stages=2,
                       loss_fn=paddle.nn.CrossEntropyLoss())
    pl.load_state(state)
    xt = torch.from_numpy(x[:4])
    ref = xt
    for layer in pl.run_funcs:
        ref = layer(ref)
    out = pl(xt)
    assert torch.equal(out, ref)
    jpaddle.seed(123)
    jl = JaxLayer(_jax_cnn(), num_stages=2)
    jout = jl(jpaddle.to_tensor(x[:4]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout.data),
                               atol=1e-5, rtol=1e-5)


def test_shared_desc_ties_and_a_stage_builds_only_its_layers():
    descs = tied_descs(paddle.nn)
    pl = PipelineLayer(descs, num_stages=2, loss_fn=paddle.nn.MSELoss())
    assert pl.run_funcs[0] is pl.run_funcs[3]
    one = PipelineLayer(cnn_descs(paddle.nn), num_stages=2, stage=1)
    lo = one.segment_bounds()[1]
    assert all(l is None for l in one.run_funcs[:lo])
    assert all(l is not None for l in one.run_funcs[lo:])


def test_one_stage_engine_matches_jax(cnn):
    state, losses, x, y = cnn
    eng = PipelineEngine(PipelineLayer(cnn_descs(paddle.nn), num_stages=1,
                                       loss_fn=paddle.nn.CrossEntropyLoss()),
                         num_microbatches=4)
    eng.load_state(state)
    got = [float(eng.train_batch(x, y, lr=0.01)[1]) for _ in range(3)]
    np.testing.assert_allclose(got, losses, **TOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("stages,seg", [(2, "uniform"), (4, "parameter")])
def test_pipeline_engine_matches_one_device(world, cnn, stages, seg):
    """pp = 2 and pp = 4 (parameter-balanced), each rank building and
    running its own stage, within the JAX tests' tolerance of the JAX
    one-device engine; the final weights of each stage equal the
    one-stage port engine's (1e-5)."""
    state, losses, x, y = cnn
    res = world.run("torch_dist_cases", "pipeline_layers_case", "cnn",
                    stages, seg, state, x, y, 4, 0.01)
    one = PipelineEngine(PipelineLayer(cnn_descs(paddle.nn), num_stages=1,
                                       loss_fn=paddle.nn.CrossEntropyLoss()),
                         num_microbatches=4)
    one.load_state(state)
    for _ in range(3):
        final, _ = one.train_batch(x, y, lr=0.01)
    for r in res[:stages]:
        np.testing.assert_allclose(r["losses"], losses, **TOL)
        for got, want in zip(r["state"], final):
            for k, v in got.items():
                np.testing.assert_allclose(v, want[k].numpy(), atol=1e-5)
    assert sum(bool(d) for r in res[:stages] for d in r["state"]) == \
        sum(bool(d) for d in final)
    assert "pp" in res[0]["bytes"]


def test_shared_layer_grads_summed_over_stages(world):
    """A tied layer on the first and last stage trains as the one layer
    it is: 2 stages equal the JAX one-device run (1e-5)."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 16).astype(np.float32)
    y = rng.randn(4, 16).astype(np.float32)
    state, losses = _jax_state(_jax_tied(), 77, jnn.MSELoss(), x, y, 0.05,
                               M=2)
    res = world.run("torch_dist_cases", "pipeline_layers_case", "tied", 2,
                    "uniform", state, x, y, 2, 0.05)
    for r in res[:2]:
        np.testing.assert_allclose(r["losses"], losses, atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_array_equal(res[0]["state"][0]["weight"],
                                  res[1]["state"][0]["weight"])


def test_fleet_distributed_model_in_pipeline_mode(world, cnn):
    """``fleet.init(pp_degree=4)`` + ``distributed_model`` of a
    ``PipelineLayer(topology=hcg)`` gives the pipeline trainer over the
    hcg's pp group, ``accumulate_steps`` microbatches."""
    state, losses, x, y = cnn
    res = world.run("torch_dist_cases", "pipeline_layers_case", "cnn", 4,
                    "uniform", state, x, y, 4, 0.01, 3, True)
    assert [r["stage"] for r in res] == [0, 1, 2, 3]
    for r in res:
        assert r["type"] == "PipelineEngine"
        np.testing.assert_allclose(r["losses"], losses, **TOL)


def test_jax_fleet_pipeline_mode_raises_module_not_found():
    """The reference fault the port repairs: the JAX ``fleet_base``
    imports ``..pipeline``, which its package does not have."""
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed.fleet import fleet_base

    saved = (fleet_base._hcg[0], fleet_base._strategy[0])
    try:
        s = jfleet.DistributedStrategy()
        s.hybrid_configs.update(pp_degree=2, dp_degree=4)
        jfleet.init(is_collective=True, strategy=s)
        assert jfleet.get_hybrid_communicate_group().get_parallel_mode() \
            == "pipeline_parallel"
        with pytest.raises(ModuleNotFoundError, match="pipeline"):
            jfleet.distributed_model(jnn.Linear(4, 4))
    finally:
        fleet_base._hcg[0], fleet_base._strategy[0] = saved


def test_message_bus_preserves_bfloat16():
    store = TCPStore("127.0.0.1", 0, is_master=True)
    bus = MessageBus(store)
    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "b": np.float32([1.5, 2.5]), "c": [torch.ones(2, dtype=torch.int64)]}
    bus.send(0, 1, "t0", tree)
    out = bus.recv(0, 1, "t0")
    assert out["a"].dtype == torch.bfloat16
    assert torch.equal(out["a"], tree["a"])
    np.testing.assert_array_equal(out["b"].numpy(), tree["b"])
    assert torch.equal(out["c"][0], tree["c"][0])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_stage_executor_two_processes_match_one(world):
    """Two processes, one stage each, over the store's message bus:
    losses within 1e-5 of the same two stages in one process (JAX's
    reference math, ``test_fleet_executor.py:_reference_losses``)."""
    D = 8
    rng = np.random.RandomState(0)
    w0 = (rng.randn(D, D) * 0.3).astype(np.float32)
    w1 = (rng.randn(D, 1) * 0.3).astype(np.float32)
    data = rng.randn(4, 8, D).astype(np.float32)
    target = rng.randn(4, 8, 1).astype(np.float32)
    res = world.run("torch_dist_cases", "stage_executor_case", _free_port(),
                    data, target, w0, w1)

    def full_loss(ws, x, y):
        return jnp.mean((jnp.tanh(x @ ws[0]) @ ws[1] - y) ** 2)

    ws, ref = (jnp.asarray(w0), jnp.asarray(w1)), []
    for _ in range(5):
        per, g = [], None
        for m in range(4):
            l, gm = jax.value_and_grad(full_loss)(ws, data[m], target[m])
            per.append(float(l))
            g = gm if g is None else jax.tree_util.tree_map(jnp.add, g, gm)
        ws = tuple(w - 0.05 * gi / 4 for w, gi in zip(ws, g))
        ref.append(float(np.mean(per)))
    np.testing.assert_allclose(res[1]["losses"], ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res[0]["w"], np.asarray(ws[0]), atol=1e-5)
    np.testing.assert_allclose(res[1]["w"], np.asarray(ws[1]), atol=1e-5)
    assert res[1]["losses"][-1] < res[1]["losses"][0]
