"""The port's auto-parallel (``distributed/auto_parallel``) against the
JAX package's, mirroring ``tests/test_auto_parallel.py``: the completed
specs equal JAX ``complete()``'s (the MLP from two annotations, ``tiny``
GPT from the three, on a dp 2 × mp 2 mesh and on the JAX test's 2 × 4),
an indivisible dim stays replicated, annotation errors; then, on a
4-rank gloo world of the port's ranks at dp 2 × mp 2, ``parallelize``
trains the MLP for 5 SGD steps (losses 2e-5 relative / 2e-6 absolute,
params 2e-4 / 2e-5, the JAX test's tolerances) and ``tiny`` GPT in fp32
for 3 (losses 1e-4 / 1e-5) against the JAX single-device steps on the
same data, each rank holding only its blocks of the split leaves; and
``shard_tensor`` / ``reshard`` move values between layouts and meshes.
The JAX side runs on the virtual CPU devices of ``tests/conftest.py``;
its GPT uses the naive attention, the port's the flash operator (the
plain version on the CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from paddle_tpu.distributed.auto_parallel import complete as jcomplete
from paddle_tpu.models.gpt import GPT_CONFIGS as JGPT_CONFIGS
from paddle_tpu.models.gpt import gpt_forward as jgpt_forward
from paddle_tpu.models.gpt import gpt_init as jgpt_init
from paddle_tpu_torch.distributed.auto_parallel import (ShardingPropagator,
                                                        complete)
from paddle_tpu_torch.distributed.mesh import P
from paddle_tpu_torch.models import GPT_CONFIGS, params_from_jax

import torch_dist_cases as cases
from torch_world import World

MESHES = {"2x2": (2, 2), "2x4": (2, 4)}


def _jmesh(dp, mp):
    return Mesh(np.array(jax.devices()[:dp * mp]).reshape(dp, mp),
                ("dp", "mp"))


def jmlp_loss(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    h = h @ params["w2"] + params["b2"]
    return (h.astype(jnp.float32) ** 2).mean()


def _mlp_params(seed=0, w1=(16, 32)):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=w1) * 0.3).astype(np.float32),
            "b1": (rng.normal(size=w1[1]) * 0.1).astype(np.float32),
            "w2": (rng.normal(size=w1[::-1]) * 0.3).astype(np.float32),
            "b2": (rng.normal(size=w1[0]) * 0.1).astype(np.float32)}


def _jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tx(tree):
    return {k: _tx(v) if isinstance(v, dict) else torch.from_numpy(
        np.array(v)) for k, v in tree.items()}


def _flat(tree, prefix=""):
    """{path: spec as a tuple} of either package's spec tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, (JP, P)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tuple(tree)}


MLP_ANN = {"*w1": (None, "mp"), "1": ("dp",)}
GPT_ANN = {"0/blocks/qkv_w": (None, None, "mp"),
           "0/blocks/up_w": (None, None, "mp"), "1": ("dp",)}


def _jann(ann):
    return {k: JP(*v) for k, v in ann.items()}


def _pann(ann):
    return {k: P(*v) for k, v in ann.items()}


def _jgpt_cfg():
    return dataclasses.replace(JGPT_CONFIGS["tiny"], use_flash=False,
                               dtype="float32")


def _pgpt_cfg():
    return dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32")


def _jgpt_loss(cfg):
    def loss(params, tokens):
        logits = jgpt_forward(cfg, params, tokens)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        tgt = jnp.roll(tokens, -1, 1)
        return -jnp.take_along_axis(logp, tgt[..., None], -1).mean()
    return loss


# ---------------------------------------------------------- completion


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mlp_specs_equal_jax(mesh):
    dp, mp = MESHES[mesh]
    p = _mlp_params()
    x = np.ones((8, 16), np.float32)
    want = jcomplete(jmlp_loss, (_jx(p), jnp.asarray(x)), _jann(MLP_ANN),
                     _jmesh(dp, mp))
    got = complete(cases.mlp_loss, (_tx(p), torch.from_numpy(x)),
                   _pann(MLP_ANN), {"dp": dp, "mp": mp})
    assert _flat(got) == _flat(want)
    assert tuple(got[0]["w2"]) == ("mp",) and tuple(got[1]) == ("dp",)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gpt_specs_equal_jax(mesh):
    """tokens → dp and qkv_w / up_w → column complete the whole Megatron
    block layout, every leaf equal to the JAX completion's."""
    dp, mp = MESHES[mesh]
    jp = jgpt_init(_jgpt_cfg(), dtype=jnp.float32)
    want, _ = jcomplete(_jgpt_loss(_jgpt_cfg()),
                        (jp, jnp.zeros((4, 32), jnp.int32)), _jann(GPT_ANN),
                        _jmesh(dp, mp))
    params = params_from_jax(jp, device="cpu")
    got, _ = complete(cases.gpt_ap_loss(_pgpt_cfg()),
                      (params, torch.zeros((4, 32), dtype=torch.int64)),
                      _pann(GPT_ANN), {"dp": dp, "mp": mp})
    assert _flat(got) == _flat(want)
    b = got["blocks"]
    assert tuple(b["proj_w"]) == (None, "mp")
    assert tuple(b["down_w"]) == (None, "mp")
    assert tuple(b["qkv_b"]) == (None, "mp")


def test_indivisible_dim_stays_replicated():
    params = {"w1": np.ones((16, 32), np.float32),
              "b1": np.zeros((32,), np.float32),
              "g": np.ones((2, 16), np.float32)}
    x = np.ones((8, 16), np.float32)

    def jloss(params, x):
        h = jnp.tanh(x @ params["w1"] + params["b1"])
        return ((h.reshape(8, 2, 16) * params["g"]) ** 2).mean()

    def tloss(params, x):
        h = torch.tanh(x @ params["w1"] + params["b1"])
        return ((h.reshape(8, 2, 16) * params["g"]) ** 2).mean()

    want = jcomplete(jloss, (_jx(params), jnp.asarray(x)),
                     {"*w1": JP(None, "mp")}, _jmesh(2, 4))
    got = complete(tloss, (_tx(params), torch.from_numpy(x)),
                   {"*w1": P(None, "mp")}, {"dp": 2, "mp": 4})
    assert _flat(got) == _flat(want)
    assert tuple(got[0]["g"]) == ()


@pytest.mark.parametrize("ann,match", [
    ({"*nope": ("mp",)}, "matches no input"),
    ({"*w1": (None, "tp")}, "unknown mesh axis"),
    ({"*w1": (None, "mp"), "*b1": ("dp",)}, "conflicting"),
    ({"*b1": (None, "mp")}, "longer than rank")])
def test_annotation_errors(ann, match):
    p = _tx(_mlp_params())
    x = torch.ones(8, 16)
    with pytest.raises(ValueError, match=match):
        complete(cases.mlp_loss, (p, x), _pann(ann), {"dp": 2, "mp": 4})
    if match != "longer than rank":
        with pytest.raises(ValueError, match=match):
            jcomplete(jmlp_loss, (_jx(_mlp_params()), jnp.ones((8, 16))),
                      _jann(ann), _jmesh(2, 4))


def test_indivisible_annotation_raises():
    p = _tx(_mlp_params(w1=(16, 33)))
    with pytest.raises(ValueError, match="not divisible"):
        complete(cases.mlp_loss, (p, torch.ones(8, 16)),
                 {"*w1": P(None, "mp")}, {"dp": 2, "mp": 4})


def test_out_specs_and_intermediates():
    """``return_out_specs`` gives the outputs' layouts; the completion
    also lays out the intermediates (the hidden activation is split
    over mp on its columns, dp on its rows)."""
    prop = ShardingPropagator({"dp": 2, "mp": 2})
    p = _tx(_mlp_params())
    specs, outs = prop.complete(cases.mlp_loss, (p, torch.ones(8, 16)),
                                _pann(MLP_ANN), return_out_specs=True)
    assert outs == [P()]
    from paddle_tpu_torch.distributed.auto_parallel.propagation import \
        trace

    gm, leaves = trace(cases.mlp_loss, (p, torch.ones(8, 16)))
    comp = prop.complete_graph(gm, leaves, _pann(MLP_ANN))
    tanh = next(n for n in gm.graph.nodes if "tanh" in str(n.target))
    assert comp.spec_of(tanh, (8, 32)) == ("dp", "mp")


# ---------------------------------------------------- parity on a world


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


def _jsgd(loss_fn, lr):
    def step(params, x):
        l, g = jax.value_and_grad(loss_fn)(params, x)
        return jax.tree_util.tree_map(lambda p, g: p - lr * g, params,
                                      g), l
    return jax.jit(step)


def test_mlp_train_parity(world):
    params = _mlp_params()
    x = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
    batches = [x + i for i in range(5)]
    step = _jsgd(jmlp_loss, 0.1)
    ref, ref_losses = _jx(params), []
    for b in batches:
        ref, l = step(ref, jnp.asarray(b))
        ref_losses.append(float(l))
    out = world.run("torch_dist_cases", "auto_parallel_case", "mlp",
                    {"dp": 2, "mp": 2}, params, batches, MLP_ANN, 0.1)
    for r in out:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=2e-5,
                                   atol=2e-6)
        for k in params:
            np.testing.assert_allclose(r["params"][k], np.asarray(ref[k]),
                                       rtol=2e-4, atol=2e-5)
        assert tuple(r["specs"][0]["w2"]) == ("mp",)
        # w1, b1, w2 are split over mp: this rank holds half of them
        assert r["local_bytes"] < r["whole_bytes"]
        assert r["whole_ops"] == {}, r["whole_ops"]


def test_gpt_train_parity_three_annotations(world):
    jcfg = _jgpt_cfg()
    jp = jgpt_init(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, jcfg.vocab_size, (8, 32)).astype(np.int64)
               for _ in range(3)]
    step = _jsgd(_jgpt_loss(jcfg), 0.01)
    ref, ref_losses = jp, []
    for b in batches:
        ref, l = step(ref, jnp.asarray(b, jnp.int32))
        ref_losses.append(float(l))
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jp)
    out = world.run("torch_dist_cases", "auto_parallel_case",
                    ("gpt", "tiny", {"dtype": "float32"}),
                    {"dp": 2, "mp": 2}, params, batches, GPT_ANN, 0.01)
    for r in out:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=1e-4,
                                   atol=1e-5)
        assert tuple(r["specs"][0]["blocks"]["proj_w"]) == (None, "mp")
        assert r["local_bytes"] < r["whole_bytes"]
    qkv_ref = np.asarray(ref["blocks"]["qkv_w"])
    np.testing.assert_allclose(out[0]["params"]["blocks"]["qkv_w"], qkv_ref,
                               rtol=1e-3, atol=1e-5)


def test_shard_tensor_and_reshard(world):
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    out = world.run("torch_dist_cases", "reshard_case", x)
    for rank, r in enumerate(out):
        dp, mp = divmod(rank, 2)
        assert r["window"] == [(4 * dp, 4 * dp + 4), (4 * mp, 4 * mp + 4)]
        np.testing.assert_array_equal(
            r["local"], x[4 * dp:4 * dp + 4, 4 * mp:4 * mp + 4])
        np.testing.assert_array_equal(r["full"], x)
        np.testing.assert_array_equal(r["a_w"], x)
        np.testing.assert_array_equal(r["a2_w"], x)
        np.testing.assert_array_equal(
            r["a2_w_local"], x[4 * mp:4 * mp + 4, 4 * dp:4 * dp + 4])
        # onto the 4 × 1 mesh: columns split four ways
        np.testing.assert_array_equal(r["b_w_local"],
                                      x[:, 2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(r["b_w"], x)
        np.testing.assert_array_equal(r["b_b"], x[0])
        assert r["one_spec"] == [("dp", None), ("dp", None)]
        np.testing.assert_array_equal(r["one_local"][0],
                                      x[4 * dp:4 * dp + 4])
        np.testing.assert_array_equal(r["one_local"][1],
                                      x[2 * dp:2 * dp + 2])
