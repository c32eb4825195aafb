"""Sharded checkpoint windows and window fingerprints of a world of ranks
against the JAX package: a pp = 4 world (``tests/test_1f1b.py``'s
``CFG``) writes only its own index windows, each window once, and the
checkpoint restores onto a dp 2 × mp 2 world, one process and the JAX
engine on a dp 2 × mp 2 mesh, whose next step matches the uninterrupted
run (losses at 2e-4 absolute / 1e-4 relative, params at 1e-4); a pp = 4
resume is bitwise.  ``shard_fingerprint`` of a world's shards names the
windows, and digests, the JAX package gives the same shards on the same
mesh; a bit flipped in one rank's shard is named by rank and window and
repaired from a replica where a majority of the window's holders agree,
and left for the rollback where two replicas disagree.

The port's ranks are one 4-rank CPU world (gloo, ``torch_world``)."""


import os
import socket

import jax
import numpy as np
import pytest

from paddle_tpu.distributed import checkpoint as jax_ck
from paddle_tpu.distributed.engine import EngineConfig as JaxEngineConfig
from paddle_tpu.distributed.engine import HybridEngine as JaxEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.resilience.integrity import \
    shard_fingerprint as jax_shard_fingerprint

from paddle_tpu_torch.distributed import checkpoint as ck
from paddle_tpu_torch.distributed import HybridEngine
from paddle_tpu_torch.models import GPTConfig
from torch_world import World

KW = dict(vocab_size=256, max_seq_len=64, hidden=64, num_layers=4,
          num_heads=4, ffn_hidden=128, dtype="float32", use_flash=False,
          remat="nothing")
MODEL = ("gpt", "tiny", KW)
LOSS_TOL = dict(atol=2e-4, rtol=1e-4)
PP4 = {"num_microbatches": 4}


def _batch(bs=8, seq=32, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, KW["vocab_size"], (bs, seq)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((bs, 1), -100)],
                            axis=1).astype(np.int32)
    return tokens, labels


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _close(got, want, atol):
    got, want = _flat(got), _flat(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=atol, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


@pytest.fixture(scope="module")
def saved(world, tmp_path_factory):
    """The pp = 4 world after 2 steps, saved; and its step 3."""
    eng = JaxEngine(JaxGPTConfig(**KW), devices=jax.devices()[:1])
    params, _ = eng.init(seed=0)
    params = jax.tree_util.tree_map(np.asarray, params)
    path = str(tmp_path_factory.mktemp("ck") / "step2")
    res = world.run("torch_dist_cases", "save_windows_case", MODEL,
                    dict(pp=4), params, *_batch(), path, PP4)
    return path, res


def test_each_window_written_once_by_its_owner(saved):
    """Every rank wrote its own manifest; over the four, each leaf's
    windows are disjoint and cover it exactly once: the block leaves by
    pp layer range (each stage its own), the replicated leaves once."""
    path, res = saved
    union = {}
    for r in res:
        for leaf in r["manifest"]["leaves"]:
            union.setdefault(leaf["path"], (leaf["shape"], []))[1].extend(
                s["index"] for s in leaf["shards"])
    for p, (shape, wins) in union.items():
        cover = np.zeros(shape, np.int32)
        for w in wins:
            cover[tuple(slice(a, b) for a, b in w)] += 1
        assert (cover == 1).all(), p
    qkv = {tuple(map(tuple, s["index"]))[0] for r in res
           for leaf in r["manifest"]["leaves"]
           if leaf["path"] == "params/blocks/qkv_w" for s in leaf["shards"]}
    assert qkv == {(0, 1), (1, 2), (2, 3), (3, 4)}
    # the replicated embedding: rank 0 alone
    owners = [r["manifest"]["leaves"] for r in res]
    wte = [any(l["path"] == "params/wte" and l["shards"] for l in ls)
           for ls in owners]
    assert wte == [True, False, False, False]


def test_load_at_dp2_mp2_world_matches_uninterrupted(world, saved):
    path, res = saved
    got = world.run("torch_dist_cases", "load_windows_case", MODEL,
                    dict(dp=2, mp=2), *_batch(), path, {})
    for r in got:
        assert r["step0"] == 2
        np.testing.assert_allclose(r["loss"], res[0]["loss"], **LOSS_TOL)
    _close(got[0]["params"], res[0]["params"], 1e-4)


def test_pp4_resume_is_bitwise(world, saved):
    path, res = saved
    got = world.run("torch_dist_cases", "load_windows_case", MODEL,
                    dict(pp=4), *_batch(), path, PP4)
    assert got[0]["loss"] == res[0]["loss"]
    for k, v in _flat(res[0]["params"]).items():
        np.testing.assert_array_equal(_flat(got[0]["params"])[k], v,
                                      err_msg=k)


def test_one_process_and_jax_engine_load_the_world_checkpoint(saved):
    path, res = saved
    tokens, labels = _batch()
    eng = HybridEngine(GPTConfig(**KW), device="cpu")
    p, o = ck.load_engine_state(path, eng)
    p, o, loss = eng.step(p, o, tokens, labels, lr=1e-3)
    np.testing.assert_allclose(float(loss), res[0]["loss"], **LOSS_TOL)
    jeng = JaxEngine(JaxGPTConfig(**KW), dp=2, mp=2,
                     devices=jax.devices()[:4],
                     engine_cfg=JaxEngineConfig())
    jp, jo = jax_ck.load_engine_state(path, jeng)
    assert int(jo["step"]) == 2
    jp, jo, jloss = jeng.step(jp, jo, tokens, labels, lr=1e-3)
    np.testing.assert_allclose(float(jloss), res[0]["loss"], **LOSS_TOL)
    _close(jax.tree_util.tree_map(np.asarray, jeng.gather_params(jp)),
           res[0]["params"], 1e-4)
    # the JAX reader assembles every leaf whole from the windows
    tree, _ = jax_ck.load_sharded(path)
    assert tree["params/blocks/qkv_w"].shape == (4, 64, 192)


def test_shard_fingerprint_windows_equal_jax_on_the_same_mesh(world):
    eng = JaxEngine(JaxGPTConfig(**KW), dp=2, mp=2,
                    devices=jax.devices()[:4])
    params, _ = eng.init(seed=0)
    host = jax.tree_util.tree_map(np.asarray, params)
    res = world.run("torch_dist_cases", "fingerprint_case", MODEL,
                    dict(dp=2, mp=2), host)
    devices = eng.mesh.devices.reshape(-1)
    for rank, r in enumerate(res):
        want = jax_shard_fingerprint(params, devices=[devices[rank]])
        assert r["digest"] == want
    assert "blocks/qkv_w@0:4,0:64,0:96" in res[0]["digest"]
    assert "blocks/qkv_w@0:4,0:64,96:192" in res[1]["digest"]


def _flip_run(world, axes, flip):
    eng = JaxEngine(JaxGPTConfig(**KW), devices=jax.devices()[:1])
    params, _ = eng.init(seed=0)
    host = jax.tree_util.tree_map(np.asarray, params)
    return world.run("torch_dist_cases", "fingerprint_case", MODEL, axes,
                     host, flip)


def test_bit_flip_named_by_rank_and_window_and_repaired(world):
    """dp 4: every window has four holders, so the three that agree are
    its majority; the flipped rank is named and repaired from the lowest
    of them."""
    res = _flip_run(world, dict(dp=4), (1, "blocks/qkv_w", 17))
    for r in res:
        assert r["before"] == [{"rank": 1, "leaf": "blocks/qkv_w",
                                "window": "0:4,0:64,0:192",
                                "majority_ranks": [0, 2, 3]}]
        assert r["after"] == []
        assert r["digest_after"] == res[0]["digest"]
    assert res[1]["repaired"] == ["blocks/qkv_w@0:4,0:64,0:192"]
    assert [r["repaired"] for r in (res[0], res[2], res[3])] == [[]] * 3


@pytest.mark.parametrize("flipped", [1, 3])
def test_bit_flip_between_two_replicas_names_both_and_copies_nothing(
        world, flipped):
    """dp 2 x mp 2: the mp-1 half of ``qkv_w`` has two holders (ranks 1
    and 3), so a flip on either leaves no majority.  Both are named, no
    window is copied (the lower rank's flipped copy never overwrites the
    healthy one), and the divergence is still reported afterwards."""
    res = _flip_run(world, dict(dp=2, mp=2), (flipped, "blocks/qkv_w", 17))
    named = [{"rank": r, "leaf": "blocks/qkv_w", "window": "0:4,0:64,96:192",
              "majority_ranks": []} for r in (1, 3)]
    healthy = 4 - flipped
    for r in res:
        assert r["before"] == named
        assert r["repaired"] == []
        assert r["after"] == named
    assert res[healthy]["digest_after"] == res[healthy]["digest"]
    assert res[flipped]["digest_after"] != res[flipped]["digest"]


def _coverage(res):
    union = {}
    for r in res:
        if r is None:
            continue
        for leaf in r["manifest"]["leaves"]:
            union.setdefault(leaf["path"], (leaf["shape"], []))[1].extend(
                s["index"] for s in leaf["shards"])
    for p, (shape, wins) in union.items():
        cover = np.zeros(shape, np.int32)
        for w in wins:
            cover[tuple(slice(a, b) for a, b in w)] += 1
        assert (cover == 1).all(), p
    return union


@pytest.mark.parametrize("axes,ec", [
    (dict(sharding=2, mp=2), {}),
    (dict(pp=2, sharding=2), {"zero_stage": 3, "num_microbatches": 2})],
    ids=["zero2-sharding2xmp2", "zero3-pp2xsharding2"])
def test_zero_windows_save_once_and_load_elsewhere(world, tmp_path, axes,
                                                   ec):
    """ZeRO-2 writes each sharding rank's optimizer chunk as its block of
    rows (no gather), ZeRO-3 each rank's parameter slice; either
    checkpoint covers every leaf once and a dp 2 × mp 2 world resumes
    it to the uninterrupted step."""
    eng = JaxEngine(JaxGPTConfig(**KW), devices=jax.devices()[:1])
    params, _ = eng.init(seed=0)
    params = jax.tree_util.tree_map(np.asarray, params)
    path = str(tmp_path / "ck")
    res = world.run("torch_dist_cases", "save_windows_case", MODEL, axes,
                    params, *_batch(), path, ec)
    union = _coverage(res)
    m = union["opt/m/blocks/qkv_w"][1]
    assert len(m) == 4 and all(w[0][1] - w[0][0] == 2 for w in m)
    got = world.run("torch_dist_cases", "load_windows_case", MODEL,
                    dict(dp=2, mp=2), *_batch(), path, {})
    for r in got:
        np.testing.assert_allclose(r["loss"], res[0]["loss"], **LOSS_TOL)
    _close(got[0]["params"], res[0]["params"], 1e-4)


def test_save_commits_through_the_barrier(world, tmp_path):
    """With a ``CommitBarrier`` over a ``TCPStore`` each rank's manifest
    lands as ``.pending``, and rank 0 commits them all once every rank
    acked its windows' CRCs: every manifest is final, none pending."""
    eng = JaxEngine(JaxGPTConfig(**KW), devices=jax.devices()[:1])
    params, _ = eng.init(seed=0)
    params = jax.tree_util.tree_map(np.asarray, params)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = str(tmp_path / "ck")
    res = world.run("torch_dist_cases", "save_windows_case", MODEL,
                    dict(pp=4), params, *_batch(), path, PP4, 2, port)
    assert res[0]["barrier"]["tokens"] == {"ck": "committed"}
    _coverage(res)
    names = sorted(os.listdir(path))
    assert [n for n in names if n.startswith("manifest")] == [
        f"manifest.{r}.json" for r in range(4)]
