"""The port's ``hapi.Model.prepare(device_mesh=)`` over a world of ranks
against the JAX package, mirroring ``tests/test_hapi.py::
TestDistributedFit``: on that file's toy data and 8-16-2 MLP (SGD 0.1,
batch 16, 3 epochs, no shuffle) ``"auto"`` (dp over 4 ranks) and
dp 2 × mp 2 meshes with ``sharding_rules`` (a column split, and a
column-row pair whose products run split over mp) fit to the JAX
single-device losses (1e-5 relative, 1e-6 absolute) and to the JAX
``prepare(device_mesh=)`` on the same mesh; the params stay bitwise equal
across the ranks; each rank's optimizer slots are its window of the
parameter (the rule table's split plus the ZeRO split).

The port's ranks are one 4-rank CPU world (gloo, ``torch_world``); the
JAX side runs on the virtual CPU devices of ``tests/conftest.py``."""

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.io import Dataset as JDataset
from paddle_tpu.metric import Accuracy as JAccuracy

from torch_world import World

TOL = dict(rtol=1e-5, atol=1e-6)


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, (n,)).astype(np.int64)
    x = (rng.randn(n, 8) * 0.3 + y[:, None].astype(np.float32) * 2.0
         ).astype(np.float32)
    return x, y


def _jax_fit(seed, mesh=None, rules=(), opt="sgd"):
    """The JAX toy fit: epoch losses, starting weights, final params."""
    jpaddle.seed(seed)
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 2))
    w0 = {k: np.array(v.data) for k, v in net.state_dict().items()}
    model = JModel(net)
    o = (jpaddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
         if opt == "sgd" else jpaddle.optimizer.Adam(
             learning_rate=0.1, parameters=model.parameters()))
    model.prepare(o, jnn.CrossEntropyLoss(), JAccuracy(), device_mesh=mesh,
                  sharding_rules=rules)
    x, y = _data()

    class Data(JDataset):
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return x[i], y[i]

    hist = model.fit(Data(), batch_size=16, epochs=3, shuffle=False,
                     verbose=0)
    final = {k: np.asarray(p.data) for k, p in net.named_parameters()}
    return [h["loss"] for h in hist], w0, final


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


def _bitwise_equal_across(res):
    for r in res[1:]:
        for k, v in res[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)


def test_auto_mesh_matches_single_device(world):
    """``"auto"``: dp over the 4 ranks, each on 4 of the 16 rows."""
    losses, w0, final = _jax_fit(7)
    x, y = _data()
    res = world.run("torch_dist_cases", "hapi_mesh_case", w0, x, y, None,
                    [])
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, **TOL)
    _bitwise_equal_across(res)
    for k, v in final.items():
        np.testing.assert_allclose(res[0]["params"][k], v, atol=1e-5,
                                   err_msg=k)
    assert "acc" in res[0]["eval"]


def test_dp_mp_mesh_with_rules_matches_jax_mesh(world):
    """dp 2 × mp 2 with a rule splitting the first weight's columns over
    mp (Adam, so the slots are windows): the JAX engine on the same mesh
    and rules, and one device, fit to the same losses; each rank's slots
    are its quarter or half of the parameter."""
    rules = [(r"^0\.weight$", (None, "mp"))]
    jrules = [(pat, jax_mesh.P(*spec)) for pat, spec in rules]
    one, w0, _ = _jax_fit(9, opt="adam")
    mesh_losses, _, final = _jax_fit(9, jax_mesh.build_mesh(dp=2, mp=2),
                                     jrules, opt="adam")
    np.testing.assert_allclose(mesh_losses, one, **TOL)
    x, y = _data()
    res = world.run("torch_dist_cases", "hapi_mesh_case", w0, x, y,
                    dict(dp=2, mp=2), rules, 3, 0.1, 16, "adam")
    for r in res:
        np.testing.assert_allclose(r["losses"], mesh_losses, **TOL)
        # [8, 16] split on mp by the rule; the moments carry no sharding
        # axis here (the mesh has none), so they are the same window
        assert r["slots"]["0.weight"]["moment1"] == [8, 8]
        assert r["slots"]["2.weight"]["moment1"] == [16, 2]
    _bitwise_equal_across(res)
    for k, v in final.items():
        np.testing.assert_allclose(res[0]["params"][k], v, atol=1e-5,
                                   err_msg=k)
    wins = {tuple(r["windows"]["0.weight"].split(",")) for r in res}
    assert wins == {("0:8", "0:8"), ("0:8", "8:16")}
    # IntegrityCallback(fingerprint_shards=True) digests each rank's
    # windows: the dp replicas of a window agree, the mp halves differ
    by = {(r["coords"]["dp"], r["coords"]["mp"]): r["fingerprint"]
          for r in res}
    assert "params/0.weight@0:8,8:16" in by[(0, 1)]
    assert by[(0, 0)] == by[(1, 0)] and by[(0, 1)] == by[(1, 1)]
    assert by[(0, 0)]["params/0.weight@0:8,0:8"] != \
        by[(0, 1)]["params/0.weight@0:8,8:16"]


def test_megatron_pair_over_mp_matches_jax_mesh(world):
    """dp 2 × mp 2 with the first weight split by columns and the second
    by rows (Megatron's pair): each mp rank multiplies by its half of
    each weight (the column split's output gathered, the row split's
    product all-reduced over mp), and the fit equals the JAX engine on
    the same mesh and rules, and one device."""
    rules = [(r"^0\.weight$", (None, "mp")), (r"^2\.weight$", ("mp", None))]
    jrules = [(pat, jax_mesh.P(*spec)) for pat, spec in rules]
    one, w0, _ = _jax_fit(11, opt="adam")
    mesh_losses, _, final = _jax_fit(11, jax_mesh.build_mesh(dp=2, mp=2),
                                     jrules, opt="adam")
    np.testing.assert_allclose(mesh_losses, one, **TOL)
    x, y = _data()
    res = world.run("torch_dist_cases", "hapi_mesh_case", w0, x, y,
                    dict(dp=2, mp=2), rules, 3, 0.1, 16, "adam")
    for r in res:
        np.testing.assert_allclose(r["losses"], mesh_losses, **TOL)
        m = r["coords"]["mp"]
        assert r["tp"] == {"0": ["column", 8 * m, 8 * m + 8],
                           "2": ["row", 8 * m, 8 * m + 8]}
        assert r["mp_bytes"] > 0
    _bitwise_equal_across(res)
    for k, v in final.items():
        np.testing.assert_allclose(res[0]["params"][k], v, atol=1e-5,
                                   err_msg=k)


def test_mp_split_outside_a_linear_weight_raises(world):
    """The mp axis splits only an ``nn.Linear``'s weight; a rule that
    splits a bias over mp is refused at the first step, on every
    rank."""
    res = world.run("torch_dist_cases", "hapi_mp_refusal_case",
                    [(r"^0\.bias$", ("mp",))])
    for msg in res:
        assert msg is not None and "0.bias is split over mp" in msg


def test_sharding_axis_windows_the_slots(world):
    """A dp 2 × sharding 2 mesh: the slots of each weight are split over
    sharding (``zero_opt_specs``' largest free dim), and the fit still
    equals one device."""
    losses, w0, _ = _jax_fit(5, opt="adam")
    x, y = _data()
    res = world.run("torch_dist_cases", "hapi_mesh_case", w0, x, y,
                    dict(dp=2, sharding=2), [], 3, 0.1, 16, "adam")
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, **TOL)
        assert r["slots"]["0.weight"]["moment1"] == [8, 8]
        assert r["slots"]["2.weight"]["moment1"] == [8, 2]
    _bitwise_equal_across(res)


@pytest.mark.parametrize("axes,rules", [
    (dict(dp=2, mp=2), [(r"^0\.weight$", (None, "mp")),
                        (r"^2\.weight$", ("mp", None))]),
    (dict(dp=2, sharding=2), [])])
def test_split_parameters_are_held_split(world, axes, rules):
    """Between steps each parameter holds only this rank's window (the
    rule table's split plus the ZeRO split: the optimizer slots'
    window), so a rank's parameter bytes are the windows' and fall below
    one process's; the fit still equals one device's losses."""
    one, w0, _ = _jax_fit(13, opt="adam")
    x, y = _data()
    res = world.run("torch_dist_cases", "hapi_mesh_case", w0, x, y, axes,
                    rules, 3, 0.1, 16, "adam")
    whole = sum(np.asarray(v).size for v in w0.values()) * 4
    for r in res:
        np.testing.assert_allclose(r["losses"], one, **TOL)
        windows = sum(int(np.prod(s["moment1"]))
                      for s in r["slots"].values()) * 4
        assert r["param_bytes"] == windows < whole
    _bitwise_equal_across(res)


def test_whole_state_readers_under_held_windows(world, tmp_path):
    """dp 2 × mp 2 with Adam and a column split, each rank holding its
    windows between steps: the files ``fit(save_dir=)`` writes and the
    default (unsharded) ``IntegrityCallback`` digest hold the whole
    parameters, the same on every rank (no false cross-rank
    divergence); a model that ``load``s ``Model.save``'s files and one
    restored from a ``CheckpointCallback`` checkpoint train on exactly
    as the fitted model does (their optimizer slots whole in the files,
    windows again on the ranks)."""
    rules = [(r"^0\.weight$", (None, "mp"))]
    jrules = [(pat, jax_mesh.P(*spec)) for pat, spec in rules]
    mesh_losses, w0, _ = _jax_fit(17, jax_mesh.build_mesh(dp=2, mp=2),
                                  jrules, opt="adam")
    x, y = _data()
    res = world.run("torch_dist_cases", "hapi_mesh_io_case", w0, x, y,
                    dict(dp=2, mp=2), rules, str(tmp_path))
    whole = sum(np.asarray(v).size for v in w0.values()) * 4
    for r in res:
        np.testing.assert_allclose(r["losses"], mesh_losses[:2], **TOL)
        assert r["param_bytes"] < whole
        assert r["digest"] == res[0]["digest"]
        assert r["resumed_step"] == 8
        for k, v in w0.items():
            assert r["saved"][k].shape == np.asarray(v).shape, k
            np.testing.assert_array_equal(r["saved"][k], r["params"][k],
                                          err_msg=k)
        for n in ("b", "c"):
            assert r["more"][n] == r["more"]["a"], n
            for k, v in r["after"]["a"].items():
                np.testing.assert_array_equal(r["after"][n][k], v,
                                              err_msg=f"{n} {k}")
    _bitwise_equal_across(res)
