"""hapi over a world of ranks keeps each parameter in the JAX layout
through a step, ``eval_batch`` and ``predict_batch``: a weight the rule
table splits over mp is held, multiplied and differentiated as its mp
window (``param_specs``), never gathered whole, as under the JAX
package's ``jit`` with ``in_shardings`` pinned to the specs
(``paddle_tpu/hapi/model.py``).

On the toy 8-16-2 MLP of ``tests/test_hapi.py::TestDistributedFit``
(3 epochs of batches of 16, per-step ``train_batch``, the gradient norm
logged): at dp 2 x mp 2 (the Megatron pair, and one column split) and at
dp 2 x sharding 2, a hook on the network records every parameter's
shape at each forward and each gradient's shape, and the per-step
losses, gradient norms, final params, ``eval_batch`` (15 rows: dp trims
them to 14, as JAX's ``_shard_batch``) and ``predict_batch`` equal the
JAX engine on the same mesh and rules and one device, at
``test_torch_hapi_mesh.py``'s ``TOL``.  ``ClipGradByGlobalNorm``,
``ClipGradByNorm``, ``ClipGradByValue``, coupled decay and ``Lamb``
(whose trust ratio takes the whole parameter's and update's norms) run
on the windows and equal the JAX fit.

The Paddle-style GPT of ``paddle_tpu_torch/models/paddle_gpt.py``
(2 layers at hidden 64) fits through hapi at dp 2 x mp 2 (``qkv`` and
``up`` split by columns, ``proj`` and ``down`` by rows) within ``TOL``
of the JAX one-device hapi fit of the same program, and of the JAX mesh
fit: the JAX side's ``scaled_dot_product_attention`` takes its naive
route on the CPU, so its ``jit`` over the mesh runs (the interpret-mode
flash kernel, which fails ``shard_map``'s checks for BERT, is not on
that route).

The port's ranks are one 4-rank CPU world (gloo, ``torch_world``); the
JAX side runs on the virtual CPU devices of ``tests/conftest.py``."""

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.metric import Accuracy as JAccuracy

from torch_dist_cases import hapi_optimizer
from torch_world import World

TOL = dict(rtol=1e-5, atol=1e-6)
EPOCHS, BS = 3, 16
PAIR = [(r"^0\.weight$", (None, "mp")), (r"^2\.weight$", ("mp", None))]
COLUMN = [(r"^0\.weight$", (None, "mp"))]
DP_MP, DP_SHARDING = dict(dp=2, mp=2), dict(dp=2, sharding=2)


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, (n,)).astype(np.int64)
    x = (rng.randn(n, 8) * 0.3 + y[:, None].astype(np.float32) * 2.0
         ).astype(np.float32)
    return x, y


def _jrules(rules):
    return [(pat, jax_mesh.P(*spec)) for pat, spec in rules]


def _jax_run(seed, axes=None, rules=(), kind="adam", clip=None, wd=None):
    """The JAX side of ``hapi_layout_case`` (one device when ``axes`` is
    None): its starting weights and what the case returns."""
    jpaddle.seed(seed)
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 2))
    w0 = {k: np.array(v.data) for k, v in net.state_dict().items()}
    model = JModel(net)
    model.prepare(hapi_optimizer(jpaddle, kind, model.parameters(), clip,
                                 wd),
                  jnn.CrossEntropyLoss(), JAccuracy(),
                  device_mesh=(None if axes is None
                               else jax_mesh.build_mesh(**axes)),
                  sharding_rules=_jrules(rules))
    model.enable_grad_norm_logging()
    x, y = _data()
    losses, gnorms = [], []
    for _ in range(EPOCHS):
        for i in range(0, len(x), BS):
            loss, res = model.train_batch(x[i:i + BS], y[i:i + BS])
            losses.append(loss)
            gnorms.append(res["grad_norm"])
    for m in model._metrics:
        m.reset()
    ev_loss, ev = model.eval_batch(x[:15], y[:15])
    pred = model.predict_batch(x[:16])
    final = {k: np.asarray(p.data) for k, p in net.named_parameters()}
    return w0, {"losses": losses, "gnorms": gnorms, "params": final,
                "eval": [ev_loss, ev["acc"]], "predict": pred}


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


def _window(whole, spec, axes):
    return [n // axes.get(a, 1) if a else n
            for n, a in zip(whole, tuple(spec) + (None,) * len(whole))]


def _assert_equal_runs(got, want, what, trimmed=True):
    """``trimmed``: both evaluated the 15 rows trimmed to dp's 14 (one
    device evaluates all 15)."""
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL,
                               err_msg=f"{what} losses")
    np.testing.assert_allclose(got["gnorms"], want["gnorms"], **TOL,
                               err_msg=f"{what} grad norms")
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, atol=1e-5,
                                   err_msg=f"{what} {k}")
    if trimmed:
        np.testing.assert_allclose(got["eval"], want["eval"], **TOL,
                                   err_msg=f"{what} eval")
    np.testing.assert_allclose(got["predict"], want["predict"], atol=1e-5,
                               err_msg=f"{what} predict")


@pytest.mark.parametrize("axes,rules", [(DP_MP, PAIR), (DP_MP, COLUMN),
                                        (DP_SHARDING, [])],
                         ids=["dp_mp_pair", "dp_mp_column", "dp_sharding"])
def test_parameters_stay_in_the_jax_layout(world, axes, rules):
    """Inside every step, eval and predict each split weight and its
    gradient have its mp window's shape, and no parameter the specs
    split is ever whole-sized; a parameter no spec splits (every one at
    dp 2 x sharding 2, whose slots alone are split) is whole in the step.
    The run equals the JAX engine on the same mesh and one device."""
    w0, one = _jax_run(21, kind="adam")
    _, mesh = _jax_run(21, axes, rules, kind="adam")
    _assert_equal_runs(mesh, one, "JAX mesh vs one device", trimmed=False)
    x, y = _data()
    res = world.run("torch_dist_cases", "hapi_layout_case", w0, x, y, axes,
                    rules)
    split = {pat.strip("^$").replace("\\", ""): spec
             for pat, spec in rules}
    for r in res:
        _assert_equal_runs(r, mesh, f"rank {r['coords']} vs JAX mesh")
        _assert_equal_runs(r, one, f"rank {r['coords']} vs one device",
                           trimmed=False)
        lay = r["layout"]
        assert set(lay["forward"]) == {"train", "eval", "predict"}
        for k, whole in r["whole"].items():
            want = [tuple(_window(whole, split.get(k, ()), axes))]
            for phase, seen in lay["forward"].items():
                assert seen[k] == want, (phase, k, seen[k], want)
            assert lay["grads"][k] == want, (k, lay["grads"][k], want)
            if k in split:
                assert list(want[0]) != whole
        # between steps the sharding axis windows the parameters too
        if "sharding" in axes:
            assert r["step_shapes"]["0.weight"] == [8, 8]


@pytest.mark.parametrize("kind,clip,wd,axes", [
    ("adam", "global", None, DP_MP),
    ("adam", "norm", None, DP_MP),
    ("adam", "value", None, DP_MP),
    ("adam", "global", 0.01, DP_MP),
    ("lamb", None, None, DP_MP),
    ("lamb", "global", None, DP_MP),
    ("lamb", "norm", None, DP_SHARDING),
], ids=["adam_global", "adam_norm", "adam_value", "adam_decay_global",
        "lamb", "lamb_global", "lamb_norm_sharding"])
def test_clip_decay_and_lamb_on_windows_match_jax(world, kind, clip, wd,
                                                  axes):
    """The norms a clip or Lamb's trust ratio takes are those of the
    whole gradient and parameter (each window's squared sum counted once
    over its mp or sharding group), so the fits equal the JAX engine on
    the same mesh and one device."""
    rules = PAIR if "mp" in axes else []
    w0, one = _jax_run(23, kind=kind, clip=clip, wd=wd)
    _, mesh = _jax_run(23, axes, rules, kind=kind, clip=clip, wd=wd)
    _assert_equal_runs(mesh, one, "JAX mesh vs one device", trimmed=False)
    x, y = _data()
    res = world.run("torch_dist_cases", "hapi_layout_case", w0, x, y, axes,
                    rules, kind, clip, wd)
    for r in res:
        _assert_equal_runs(r, mesh, f"rank {r['coords']} vs JAX mesh")
    for r in res[1:]:
        for k, v in res[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)


# ------------------------------------------------- the Paddle-style GPT

V, D, H, FFN, L, S, B = 128, 64, 4, 256, 2, 32, 2
GPT_RULES = [(r"qkv\.weight$", (None, "mp")), (r"up\.weight$", (None, "mp")),
             (r"proj\.weight$", ("mp", None)),
             (r"down\.weight$", ("mp", None))]


def _gpt_state(seed=0):
    """A ``gpt_init``-shaped tree (its init stds) as the program's
    ``state_dict``."""
    from paddle_tpu_torch.models import paddle_gpt as prog

    rng = np.random.default_rng(seed)

    def n(*shape, std=0.02):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    resid = 0.02 / np.sqrt(2 * L)
    params = {
        "wte": n(V, D), "wpe": n(S, D, std=0.01),
        "lnf_g": 1 + n(D), "lnf_b": n(D),
        "blocks": {
            "ln1_g": 1 + n(L, D), "ln1_b": n(L, D),
            "qkv_w": n(L, D, 3 * D), "qkv_b": n(L, 3 * D),
            "proj_w": n(L, D, D, std=resid), "proj_b": n(L, D),
            "ln2_g": 1 + n(L, D), "ln2_b": n(L, D),
            "up_w": n(L, D, FFN), "up_b": n(L, FFN),
            "down_w": n(L, FFN, D, std=resid), "down_b": n(L, D)}}
    return prog.gpt_state_from_params(params, L)


def _jax_gpt(state, tokens, labels, axes=None, steps=3):
    from paddle_tpu_torch.models import paddle_gpt as prog

    jpaddle.seed(0)
    net = prog.build_gpt(jpaddle, V, D, H, FFN, L, S)
    net.set_state_dict(state)

    def loss(out, y):
        return jpaddle.nn.functional.cross_entropy(
            jpaddle.reshape(out, [-1, V]), jpaddle.reshape(y, [-1]),
            ignore_index=-100)

    model = JModel(net)
    model.prepare(jpaddle.optimizer.AdamW(learning_rate=1e-3,
                                          weight_decay=0.01,
                                          parameters=model.parameters()),
                  loss, device_mesh=(None if axes is None
                                     else jax_mesh.build_mesh(**axes)),
                  sharding_rules=_jrules(GPT_RULES))
    losses = [model.train_batch(tokens, labels)[0] for _ in range(steps)]
    ev_loss, _ = model.eval_batch(tokens, labels)
    pred = model.predict_batch(tokens)
    final = {k: np.asarray(p.data) for k, p in net.named_parameters()}
    return {"losses": losses, "eval": ev_loss, "predict": pred,
            "params": final}


def _port_gpt_one(state, tokens, labels, steps=3):
    """The port's one-process hapi fit of the same program (CPU)."""
    import torch

    import paddle_tpu_torch as tpaddle
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import paddle_gpt as prog

    tpaddle.set_device("cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        net = prog.build_gpt(tpaddle, V, D, H, FFN, L, S)
        net.set_state_dict({k: np.array(v) for k, v in state.items()})

        def loss(out, y):
            return tpaddle.nn.functional.cross_entropy(
                tpaddle.reshape(out, [-1, V]), tpaddle.reshape(y, [-1]),
                ignore_index=-100)

        model = Model(net)
        model.prepare(tpaddle.optimizer.AdamW(
            learning_rate=1e-3, weight_decay=0.01,
            parameters=net.parameters()), loss)
        for _ in range(steps):
            model.train_batch(tokens, labels)
        return {k: p.detach().numpy().copy()
                for k, p in net.named_parameters()}
    finally:
        torch.set_num_threads(prev)


def test_paddle_style_gpt_fits_over_dp_mp_like_jax(world):
    """The Paddle-style GPT through hapi at dp 2 x mp 2: the losses of
    three AdamW steps, ``eval_batch`` and ``predict_batch`` equal the JAX
    one-device hapi fit of the same program and the JAX mesh fit at
    ``TOL`` (predictions at 1e-5), each linear of the four split ones held
    as its window throughout.

    Params: Adam divides each gradient by its running RMS, so an element
    whose gradient is near zero moves by the sign of rounding noise, and
    the fits' summation orders differ.  Here the element that differs
    most (``blocks.1.up.weight``) is 6.8e-6 apart between the JAX
    one-device and mesh fits, 1.19e-5 between the port's one-process fit
    and JAX's, and 2.04e-5 between this world and JAX's one device.  So
    each parameter's difference from the JAX fits is held, as a whole, to
    1e-2 of its update over the three steps (L2; 1.01e-3 and 1.29e-3 at
    most, ``blocks.1.qkv.bias``), and the params element by element to
    the port's one-process hapi fit at 1e-5 (8.5e-6 at most)."""
    from paddle_tpu_torch.models import paddle_gpt as prog

    state = _gpt_state()
    tokens = np.random.default_rng(1).integers(0, V, (B, S)).astype(
        np.int64)
    labels = prog.next_token_labels(tokens)
    one = _jax_gpt(state, tokens, labels)
    mesh = _jax_gpt(state, tokens, labels, DP_MP)
    port_one = _port_gpt_one(state, tokens, labels)
    res = world.run("torch_dist_cases", "hapi_gpt_case", state, tokens,
                    labels, (V, D, H, FFN, L, S), GPT_RULES)
    for want, what in ((one, "one device"), (mesh, "JAX mesh")):
        for r in res:
            np.testing.assert_allclose(r["losses"], want["losses"], **TOL,
                                       err_msg=what)
            np.testing.assert_allclose(r["eval"], want["eval"], **TOL,
                                       err_msg=what)
            np.testing.assert_allclose(r["predict"], want["predict"],
                                       atol=1e-5, err_msg=what)
            for k, v in want["params"].items():
                update = np.linalg.norm(v - np.asarray(state[k]))
                off = np.linalg.norm(r["params"][k] - v)
                assert off <= 1e-2 * update, (what, k, off / update)
    for r in res:
        for k, v in port_one.items():
            np.testing.assert_allclose(r["params"][k], v, atol=1e-5,
                                       err_msg=f"port one process {k}")
    windows = {"qkv": [D, 3 * D // 2], "up": [D, FFN // 2],
               "proj": [D // 2, D], "down": [FFN // 2, D]}
    for r in res:
        kinds = {"qkv": "column", "proj": "row", "up": "column",
                 "down": "row"}
        assert dict(r["tp"]) == {f"blocks.{i}.{n}": kind
                                 for i in range(L)
                                 for n, kind in kinds.items()}
        lay = r["layout"]
        for i in range(L):
            for name, shape in windows.items():
                k = f"blocks.{i}.{name}.weight"
                for phase in ("train", "eval", "predict"):
                    assert lay["forward"][phase][k] == [tuple(shape)], k
                assert lay["grads"][k] == [tuple(shape)], k
    for r in res[1:]:
        for k, v in res[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)
