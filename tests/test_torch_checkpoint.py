"""The port's sharded checkpoints (``distributed.checkpoint``) against the
JAX package's.

- The format is the JAX package's byte for byte: for the same fp32,
  bf16 and int tree the two packages write the same shard files, CRCs
  and manifest leaves, and each loads the other's (bf16 included: JAX
  writes ``ml_dtypes.bfloat16`` as ``'<V2'``, the port its uint16 bits
  under that header).
- A checkpoint the JAX engine wrote at dp = 2, mp = 2 on virtual CPU
  devices (windows over 4 devices) loads into the port's one-device
  ``HybridEngine`` and its losses continue the JAX run's at
  ``tests/test_checkpoint.py``'s 2e-4 / 1e-4; a port checkpoint loads
  into the JAX engine and continues at the same tolerances.
- The port's own resume is bitwise: a new engine from the checkpoint,
  and an in-place restore into the live tensors (which keep their
  storage).
- ``tests/test_commit_barrier.py`` (the multi-host commit barrier:
  protocol, kill matrix, status, bounded waits) on the port, ranks as
  threads over one ``TCPStore``.
"""
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.distributed.engine import HybridEngine as JaxEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch.distributed import EngineConfig, HybridEngine
from paddle_tpu_torch.distributed import checkpoint as ck
from paddle_tpu_torch.distributed.checkpoint import (CommitBarrier,
                                                     CommitBarrierError)
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.models import GPTConfig, params_from_jax
from paddle_tpu_torch.resilience.checkpoint_manager import CheckpointManager
from paddle_tpu_torch.resilience.faults import (FaultSpec, injected_faults)

# tests/test_checkpoint.py's model and tolerances
KW = dict(vocab_size=256, max_seq_len=64, hidden=64, num_layers=4,
          num_heads=4, ffn_hidden=128, dtype="float32", use_flash=False,
          remat="nothing")
JCFG, CFG = JaxGPTConfig(**KW), GPTConfig(**KW)
TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(bs=8, seq=32, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, CFG.vocab_size, (bs, seq)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((bs, 1), -100)],
                            axis=1).astype(np.int32)
    return tokens, labels


def _train(engine, params, opt, n, lr=1e-3):
    tokens, labels = _batch()
    losses = []
    for _ in range(n):
        params, opt, loss = engine.step(params, opt, tokens, labels, lr=lr)
        losses.append(float(loss))
    return params, opt, losses


def _flat(tree):
    return dict(ck.tree_items(tree))


def _tree_pair(kind):
    """The same tree in both packages: (jax tree, port tree)."""
    rng = np.random.RandomState(3)
    w = rng.randn(8, 8).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    if kind == "bfloat16":
        jt = {"w": jnp.asarray(w).astype(jnp.bfloat16),
              "nested": {"b": jnp.asarray(b).astype(jnp.bfloat16)}}
        pt = {"w": torch.from_numpy(w).bfloat16(),
              "nested": {"b": torch.from_numpy(b).bfloat16()}}
    else:
        dt = np.dtype(kind)
        jt = {"w": jnp.asarray(w.astype(dt)),
              "nested": {"b": jnp.asarray(b.astype(dt))}}
        pt = {"w": torch.from_numpy(w.astype(dt)),
              "nested": {"b": torch.from_numpy(b.astype(dt))}}
    jt["step"] = jnp.asarray(7, jnp.int32)
    pt["step"] = 7                     # a Python int saves as int32
    return jt, pt


# ----------------------------------------------------------- the format


class TestFormat:
    def test_plain_tree_roundtrip(self, tmp_path):
        tree = {"x": torch.arange(64.0).reshape(8, 8),
                "y": torch.arange(6, dtype=torch.int64), "n": 3}
        ck.save_sharded(str(tmp_path / "ck"), tree, step=5)
        host, manifest = ck.load_sharded(str(tmp_path / "ck"))
        assert manifest["step"] == 5
        assert manifest["format"] == "paddle_tpu.sharded_checkpoint.v2"
        np.testing.assert_array_equal(host["x"], tree["x"].numpy())
        np.testing.assert_array_equal(host["y"], tree["y"].numpy())
        assert host["n"].dtype == np.int32 and int(host["n"]) == 3

    @pytest.mark.parametrize("kind", ["float32", "bfloat16", "int32"])
    def test_files_and_crcs_equal_jax(self, tmp_path, kind):
        jt, pt = _tree_pair(kind)
        jm = jck.save_sharded(str(tmp_path / "jax"), jt, step=2,
                              extra={"k": 1})
        pm = ck.save_sharded(str(tmp_path / "port"), pt, step=2,
                             extra={"k": 1})
        assert pm == jm                  # leaves, CRCs, windows, dtypes
        for leaf in jm["leaves"]:
            for sh in leaf["shards"]:
                rel = os.path.join(leaf["id"], sh["file"])
                with open(tmp_path / "jax" / rel, "rb") as f, \
                        open(tmp_path / "port" / rel, "rb") as g:
                    assert f.read() == g.read(), rel

    def test_bf16_crosses_both_ways(self, tmp_path):
        jt, pt = _tree_pair("bfloat16")
        jck.save_sharded(str(tmp_path / "jax"), jt)
        host, _ = ck.load_sharded(str(tmp_path / "jax"))
        assert host["w"].dtype == torch.bfloat16
        assert torch.equal(host["w"].view(torch.int16),
                           pt["w"].view(torch.int16))
        ck.save_sharded(str(tmp_path / "port"), pt)
        jhost, _ = jck.load_sharded(str(tmp_path / "port"))
        assert jhost["nested/b"].dtype == np.dtype(jnp.bfloat16)
        np.testing.assert_array_equal(
            jhost["nested/b"].view(np.uint16),
            pt["nested"]["b"].view(torch.uint16).numpy())

    def test_jax_sharded_windows_union(self, tmp_path):
        """A tree JAX saved as 2 x 2 windows (and a replicated leaf)
        loads whole in the port, host form and onto a template."""
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("a", "b"))
        x = jax.device_put(np.arange(64.0, dtype=np.float32).reshape(8, 8),
                           NamedSharding(mesh, P("a", "b")))
        y = jax.device_put(np.arange(6.0, dtype=np.float32),
                           NamedSharding(mesh, P()))
        m = jck.save_sharded(str(tmp_path / "ck"), {"x": x, "y": y}, step=5)
        assert len(next(l for l in m["leaves"]
                        if l["path"] == "x")["shards"]) == 4
        host, manifest = ck.load_sharded(str(tmp_path / "ck"))
        assert manifest["step"] == 5
        np.testing.assert_array_equal(host["x"], np.asarray(x))
        np.testing.assert_array_equal(host["y"], np.asarray(y))
        like = {"x": torch.zeros(8, 8, dtype=torch.float64),
                "y": torch.zeros(6)}
        tree, _ = ck.load_sharded(str(tmp_path / "ck"), like_tree=like)
        assert tree["x"].dtype == torch.float64
        np.testing.assert_array_equal(tree["x"].numpy(), np.asarray(x))

    def test_missing_window_is_an_error(self, tmp_path):
        """A leaf whose saved windows do not cover it does not load."""
        import json

        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.array(jax.devices()[:2]), ("a",))
        x = jax.device_put(np.ones((4, 4), np.float32),
                           NamedSharding(mesh, P("a")))
        jck.save_sharded(str(tmp_path / "ck"), {"x": x})
        mpath = tmp_path / "ck" / "manifest.0.json"
        m = json.loads(mpath.read_text())
        del m["leaves"][0]["shards"][1]
        mpath.write_text(json.dumps(m))
        with pytest.raises(ValueError, match="cover only"):
            ck.load_sharded(str(tmp_path / "ck"))


# ------------------------------------------------------- engine state


class TestPortEngineResume:
    def _engine(self):
        return HybridEngine(CFG, engine_cfg=EngineConfig(), device="cpu")

    def test_new_engine_resume_is_bitwise(self, tmp_path):
        eng = self._engine()
        params, opt = eng.init(seed=0)
        ref_params, _, ref = _train(eng, params, opt, 4)
        eng = self._engine()
        params, opt = eng.init(seed=0)
        params, opt, l01 = _train(eng, params, opt, 2)
        ck.save_engine_state(str(tmp_path / "ck"), eng, params, opt)
        eng2 = self._engine()
        params2, opt2 = ck.load_engine_state(str(tmp_path / "ck"), eng2)
        assert opt2["step"] == 2
        params2, _, l23 = _train(eng2, params2, opt2, 2)
        assert l01 + l23 == ref
        for k, t in _flat(ref_params).items():
            assert torch.equal(t, _flat(params2)[k]), k

    def test_state_template_allocates_nothing(self):
        eng = self._engine()
        params_t, canon_t = eng.state_template()
        params, opt = eng.init(seed=0)
        canon = eng.opt_canonical(opt, params)
        for tmpl, live in ((params_t, params), (canon_t, canon)):
            lt = _flat(live)
            for k, t in _flat(tmpl).items():
                assert not isinstance(t, torch.Tensor)
                assert (t.shape, t.dtype, t.device) == \
                    (tuple(lt[k].shape), lt[k].dtype, lt[k].device), k

    def test_in_place_restore_keeps_storage(self, tmp_path):
        """``into=``: values copied into the live tensors, whose storage
        (what a captured step reads) does not move; the continued run
        equals the uninterrupted one."""
        eng = self._engine()
        params, opt = eng.init(seed=0)
        params, opt, _ = _train(eng, params, opt, 2)
        ck.save_engine_state(str(tmp_path / "ck"), eng, params, opt)
        _, _, l23 = _train(eng, params, opt, 2)
        ptrs = {k: t.data_ptr() for k, t in
                _flat({"p": params, "s": opt["slots"]}).items()}
        ck.load_engine_state(str(tmp_path / "ck"), eng, into=(params, opt))
        assert opt["step"] == 2 and float(eng._step) == 2
        assert ptrs == {k: t.data_ptr() for k, t in
                        _flat({"p": params, "s": opt["slots"]}).items()}
        _, _, again = _train(eng, params, opt, 2)
        assert again == l23


# ------------------------------------------- across the two packages


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine at dp = 2, mp = 2: four steps uninterrupted, and a
    checkpoint after two (of a second run from the same seed)."""
    eng = JaxEngine(JCFG, dp=2, mp=2, devices=jax.devices()[:4])
    params, opt = eng.init(seed=0)
    init = jax.tree_util.tree_map(np.asarray, params)
    _, _, ref = _train(eng, params, opt, 4)
    params, opt = eng.init(seed=0)
    params, opt, _ = _train(eng, params, opt, 2)
    path = str(tmp_path_factory.mktemp("jaxck") / "ck")
    jck.save_engine_state(path, eng, params, opt)
    return {"engine": eng, "init": init, "ref": ref, "path": path}


class TestAcrossPackages:
    def test_jax_dp2_mp2_checkpoint_continues_in_port(self, jax_run):
        eng = HybridEngine(CFG, engine_cfg=EngineConfig(), device="cpu")
        params, opt = ck.load_engine_state(jax_run["path"], eng)
        assert opt["step"] == 2
        _, _, l23 = _train(eng, params, opt, 2)
        np.testing.assert_allclose(l23, jax_run["ref"][2:], **TOL)

    def test_port_checkpoint_continues_in_jax(self, jax_run, tmp_path):
        eng = HybridEngine(CFG, engine_cfg=EngineConfig(), device="cpu")
        params = params_from_jax(jax_run["init"], device="cpu")
        opt = eng.init_opt(params)
        params, opt, l01 = _train(eng, params, opt, 2)
        np.testing.assert_allclose(l01, jax_run["ref"][:2], **TOL)
        ck.save_engine_state(str(tmp_path / "ck"), eng, params, opt)
        jeng = jax_run["engine"]
        jparams, jopt = jck.load_engine_state(str(tmp_path / "ck"), jeng)
        assert int(jopt["step"]) == 2
        _, _, l23 = _train(jeng, jparams, jopt, 2)
        np.testing.assert_allclose(l23, jax_run["ref"][2:], **TOL)

    def test_restored_state_is_the_jax_canonical_state(self, jax_run):
        """Leaf for leaf, the port's restored params and canonical
        optimizer state are the arrays the JAX engine saved."""
        eng = HybridEngine(CFG, engine_cfg=EngineConfig(), device="cpu")
        params, opt = ck.load_engine_state(jax_run["path"], eng)
        host, _ = jck.load_sharded(jax_run["path"])
        mine = _flat({"params": params,
                      "opt": eng.opt_canonical(opt, params)})
        assert set(mine) == set(host)
        for k, t in mine.items():
            np.testing.assert_array_equal(t.numpy(), host[k])


# ----------------------------------------------- the commit barrier

WORLD = 2


@pytest.fixture
def master_store():
    yield TCPStore(is_master=True, world_size=WORLD)


def _client(master):
    return TCPStore(port=master.port, world_size=WORLD)


def _ctree(step):
    return {"w": np.arange(16.0) + step, "b": np.full((4,), float(step))}


def _run_ranks(fn, world=WORLD):
    results = {}

    def wrap(r):
        try:
            results[r] = ("ok", fn(r))
        except BaseException as e:     # noqa: BLE001 - SimulatedCrash IS the point
            results[r] = (type(e).__name__, None)

    threads = [threading.Thread(target=wrap, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return results


def _save_step(master, d, r, step, timeout):
    mgr = CheckpointManager(
        d, barrier=CommitBarrier(_client(master), r, WORLD, timeout=timeout))
    mgr.save(_ctree(step), step)
    return mgr.latest()


class TestCommitBarrier:
    def test_all_ranks_commit_and_agree(self, master_store, tmp_path):
        d = str(tmp_path / "ck")
        results = _run_ranks(lambda r: _save_step(master_store, d, r, 1,
                                                  10.0))
        assert results == {0: ("ok", 1), 1: ("ok", 1)}
        names = sorted(os.listdir(os.path.join(d, "step_0000000001")))
        assert "manifest.0.json" in names and "manifest.1.json" in names

    def test_bare_save_sharded_barrier_commit(self, master_store,
                                              tmp_path):
        d = str(tmp_path / "raw")

        def rank(r):
            ck.save_sharded(d, _ctree(3), step=3,
                            barrier=CommitBarrier(_client(master_store), r,
                                                  WORLD, timeout=10.0))
            return True

        results = _run_ranks(rank)
        assert all(v == ("ok", True) for v in results.values())
        host, manifest = ck.load_sharded(d)
        assert manifest["step"] == 3
        np.testing.assert_array_equal(host["w"], _ctree(3)["w"])
        assert not [n for n in os.listdir(d) if n.endswith(".pending")]

    def test_retry_after_failed_attempt_uses_new_generation(
            self, master_store, tmp_path):
        d = str(tmp_path / "ck")
        results = _run_ranks(lambda r: _save_step(master_store, d, r, 1,
                                                  1.0), world=1)
        assert results[0][0] == "CommitBarrierError"
        assert CheckpointManager(d, sweep_orphans=False).latest() is None
        results = _run_ranks(lambda r: _save_step(master_store, d, r, 1,
                                                  10.0))
        assert results == {0: ("ok", 1), 1: ("ok", 1)}

    def _committed_step_then(self, master_store, d, faults, timeout=2.0):
        results = _run_ranks(lambda r: _save_step(master_store, d, r, 1,
                                                  10.0))
        assert results == {0: ("ok", 1), 1: ("ok", 1)}
        with injected_faults(*faults):
            return _run_ranks(lambda r: _save_step(master_store, d, r, 2,
                                                   timeout))

    def test_rank_killed_before_ack_never_advances_latest(
            self, master_store, tmp_path):
        d = str(tmp_path / "ck")
        results = self._committed_step_then(
            master_store, d,
            [FaultSpec("checkpoint.shard_ack", "kill", occurrence=1)])
        assert sorted(k for k, _ in results.values()) == \
            ["CommitBarrierError", "SimulatedCrash"]
        reader = CheckpointManager(d, sweep_orphans=False)
        assert reader.latest() == 1
        _, tree, manifest = reader.restore()
        assert manifest["step"] == 1
        np.testing.assert_array_equal(tree["w"], _ctree(1)["w"])

    def test_committer_killed_before_barrier_commit(self, master_store,
                                                    tmp_path):
        d = str(tmp_path / "ck")
        results = self._committed_step_then(
            master_store, d,
            [FaultSpec("checkpoint.before_barrier_commit", "kill",
                       occurrence=1)])
        kinds = {r: kind for r, (kind, _) in results.items()}
        assert kinds == {0: "SimulatedCrash", 1: "CommitBarrierError"}
        assert CheckpointManager(d, sweep_orphans=False).latest() == 1

    def test_ack_stall_is_tolerated_within_timeout(self, master_store,
                                                   tmp_path):
        d = str(tmp_path / "ck")
        results = self._committed_step_then(
            master_store, d,
            [FaultSpec("checkpoint.shard_ack", "stall", occurrence=1,
                       stall_s=0.3)], timeout=10.0)
        assert results == {0: ("ok", 2), 1: ("ok", 2)}

    def test_crashed_attempt_resumes_from_previous_everywhere(
            self, master_store, tmp_path):
        d = str(tmp_path / "ck")
        self._committed_step_then(
            master_store, d,
            [FaultSpec("checkpoint.shard_ack", "kill", occurrence=1)])
        results = _run_ranks(lambda r: _save_step(master_store, d, r, 2,
                                                  10.0))
        assert results == {0: ("ok", 2), 1: ("ok", 2)}
        _, tree, _ = CheckpointManager(d, sweep_orphans=False).restore()
        np.testing.assert_array_equal(tree["w"], _ctree(2)["w"])

    def test_status_snapshot(self, master_store, tmp_path):
        def rank(r):
            b = CommitBarrier(_client(master_store), r, WORLD, timeout=10.0)
            CheckpointManager(str(tmp_path / "ck"), barrier=b).save(
                _ctree(1), 1)
            return b.status()

        results = _run_ranks(rank)
        assert results[0][1]["tokens"] == {"step_0000000001": "committed"}
        assert results[0][1]["acked_ranks"] == {"step_0000000001": [0, 1]}
        assert results[1][1]["tokens"] == {"step_0000000001": "committed"}

    def test_begin_join_miss_is_protocol_error(self, master_store):
        import time

        b = CommitBarrier(_client(master_store), 1, WORLD, timeout=0.4)
        t0 = time.monotonic()
        with pytest.raises(CommitBarrierError):
            b.begin("orphan_token")
        assert time.monotonic() - t0 < 2.0

    def test_collect_acks_aborts_promptly_at_scale(self, master_store):
        import time

        b = CommitBarrier(_client(master_store), 0, 16, timeout=0.4)
        b.begin("tok_scale")
        t0 = time.monotonic()
        with pytest.raises(CommitBarrierError):
            b.commit("tok_scale", fn=lambda: None)
        assert time.monotonic() - t0 < 1.1

