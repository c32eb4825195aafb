"""The port's silent-corruption sentinel (``resilience.integrity``) against
the JAX package's: ``tests/test_integrity.py``'s fingerprints, step
replay, cross-rank divergence with its rewind-and-replay repair, and the
supervisor's resume evidence, on the port at their sizes.

- The digests are the JAX package's: for the same fp32 and int tree
  (and scalar leaves) ``tree_fingerprint`` and ``shard_fingerprint`` give
  equal CRCs in both packages.  The JAX digest raises on a bf16 leaf (it
  cannot read an ``ml_dtypes`` buffer); the port's bf16 digest is the
  JAX formula over the same bytes.
- Under ``TestCrossRankDivergence``'s protocol (sequential dp ranks over
  one ``TCPStore``, rank 1 with a ``bitflip`` of ``0.weight`` at global
  step 5, fingerprints every 2 steps) the port names the rank, the step
  and the leaf the JAX package names on the same protocol (which is
  ``params/0.bias``: the compare runs at step 6, after one more step has
  spread the flip into the bias, and the first divergent leaf is the
  first in sorted order; the reference test's ``params/0.weight`` is a
  quirk of that test, not of the sentinel).
- With the monitor on, rank 1 is repaired and its final parameters equal
  rank 0's bit for bit.

Left out, each testing a part of the JAX package the port has not taken
over: ``TestIntegrityEndpoints`` (the telemetry server),
``TestExceptsLint`` (a lint tool), ``TestSentinelOverheadSmoke``
(``bench.py``'s JAX bench; its port is the card test
``test_sentinel_overhead_under_bound_on_the_card`` in
``tests/test_torch_kernels_cuda.py``, and ``chip_smoke.py`` phase 19 (f)
checks the amortized share on the card; the device CRC's plain version
is held to zlib in ``tests/test_torch_crc32.py``), and the GSPMD cases of
``TestShardFingerprint`` (a port tensor is one window).  The ``bitflip``
fault itself is held to the JAX package's in ``tests/test_torch_faults.py``.
"""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed.store import TCPStore as JaxStore
from paddle_tpu.hapi import Callback as JCallback
from paddle_tpu.hapi import CheckpointCallback as JCheckpointCallback
from paddle_tpu.hapi import IntegrityCallback as JIntegrityCallback
from paddle_tpu.io import Dataset as JDataset
from paddle_tpu.observability import MetricsRegistry as JMetricsRegistry
from paddle_tpu.observability import Tracer as JTracer
from paddle_tpu.resilience import FaultSpec as JFaultSpec
from paddle_tpu.resilience import injected_faults as jinjected_faults
from paddle_tpu.resilience.integrity import \
    shard_fingerprint as jshard_fingerprint
from paddle_tpu.resilience.integrity import \
    tree_fingerprint as jtree_fingerprint

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.hapi import CheckpointCallback, IntegrityCallback
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.observability import (HealthMonitor, MetricsRegistry,
                                            Tracer, default_registry)
from paddle_tpu_torch.resilience import (CheckpointManager, FaultSpec,
                                         injected_faults)
from paddle_tpu_torch.resilience.integrity import (compare_digests,
                                                   first_divergent_leaf,
                                                   majority_partition,
                                                   shard_fingerprint,
                                                   tree_fingerprint)
from torch_eager_ref import carry


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ fingerprints


class TestTreeFingerprint:
    def test_leaf_paths_and_stability(self):
        tree = {"a": {"w": np.arange(4, dtype=np.float32)},
                "b": [torch.ones(2, dtype=torch.int32), None, 7]}
        fp = tree_fingerprint(tree)
        assert set(fp) == {"a/w", "b/0", "b/2"}
        assert fp == tree_fingerprint(tree)

    def test_shape_and_dtype_ride_in_the_digest(self):
        flat = torch.zeros(4)
        assert tree_fingerprint({"x": flat}) != \
            tree_fingerprint({"x": flat.reshape(2, 2)})
        assert tree_fingerprint({"x": torch.zeros(4)}) != \
            tree_fingerprint({"x": torch.zeros(8, dtype=torch.float16)})

    def test_one_bit_changes_the_leaf_digest(self):
        a = torch.arange(64, dtype=torch.float32)
        b = a.clone()
        b.view(torch.uint8)[17] ^= 1
        fa, fb = tree_fingerprint({"w": a}), tree_fingerprint({"w": b})
        assert fa["w"] != fb["w"]
        assert first_divergent_leaf(fa, fb) == "w"

    def test_first_divergent_leaf_counts_missing(self):
        assert first_divergent_leaf({"a": 1, "b": 2}, {"a": 1}) == "b"
        assert first_divergent_leaf({"a": 1}, {"a": 1}) is None

    def test_majority_partition_and_tie_anchor(self):
        good, bad = {"w": 1}, {"w": 2}
        assert majority_partition({0: good, 1: bad, 2: good}) == \
            ([0, 2], [1], good)
        maj, mino, _ = majority_partition({0: good, 1: bad})
        assert (maj, mino) == ([0], [1])

    def test_compare_digests(self):
        good, bad = {"w": 1, "b": 5}, {"w": 2, "b": 5}
        assert compare_digests({0: good, 1: good}) is None
        assert compare_digests({0: good}) is None
        rep = compare_digests({0: good, 1: bad, 2: good})
        assert rep["divergent_ranks"] == [1]
        assert rep["majority_ranks"] == [0, 2]
        assert rep["first_divergent_leaf"] == {1: "w"}

    @pytest.mark.parametrize("kind", ["float32", "bfloat16", "int32"])
    def test_digests_equal_jax(self, kind):
        rng = np.random.RandomState(5)
        w = rng.randn(6, 3).astype(np.float32)
        z = np.asarray(2.5, np.float32)
        if kind == "bfloat16":
            jt = {"w": jnp.asarray(w).astype(jnp.bfloat16),
                  "z": jnp.asarray(z).astype(jnp.bfloat16)}
            pt = {"w": torch.from_numpy(w).bfloat16(),
                  "z": torch.from_numpy(z).bfloat16()}
        else:
            jt = {"w": jnp.asarray(w.astype(kind)),
                  "z": jnp.asarray(z.astype(kind))}
            pt = {"w": torch.from_numpy(w.astype(kind)),
                  "z": torch.from_numpy(z.astype(kind))}
        jt["meta"] = pt["meta"] = [None, 7, "tag"]
        if kind == "bfloat16":
            # the JAX package's digest cannot read an ml_dtypes buffer
            # (a fault of the reference): hold the port to the same
            # formula over the JAX arrays' bytes
            with pytest.raises(ValueError):
                jtree_fingerprint(jt)
            want = {k: zlib.crc32(np.asarray(a).tobytes(), zlib.crc32(
                f"{np.asarray(a).dtype.str}:{a.shape}".encode()))
                for k, a in (("w", jt["w"]), ("z", jt["z"]))}
            want.update({"meta/1": zlib.crc32(b"7"),
                         "meta/2": zlib.crc32(repr("tag").encode())})
            assert tree_fingerprint(pt) == want
        else:
            assert tree_fingerprint(pt) == jtree_fingerprint(jt)
            assert shard_fingerprint(pt) == jshard_fingerprint(jt)
        assert set(shard_fingerprint(pt)) == {"w@0:6,0:3", "z@0:1",
                                              "meta/1", "meta/2"}

    def test_callback_peers_restriction(self):
        """Ranks 0 and 2 hold one state, 1 and 3 another (mp peers hold
        different windows): restricted to its dp replica group, no rank
        sees a divergence."""
        a = {"w": torch.arange(8.0)}
        b = {"w": torch.arange(8.0) + 1}
        store = TCPStore(is_master=True, world_size=1)
        cbs = {}
        for r in range(4):
            cb = IntegrityCallback(store=store, rank=r, world_size=4,
                                   fingerprint_every=1,
                                   peers=[r % 2, r % 2 + 2],
                                   fingerprint_shards=True,
                                   registry=MetricsRegistry())
            cb._fingerprint_tree = lambda t=(a if r % 2 == 0 else b): {
                "params": t}
            cb.model = None
            cbs[r] = cb
        for r in range(4):
            cbs[r]._global_step = 1
            cbs[r]._run_fingerprint(step=0)
        assert all(cb.events == [] for cb in cbs.values())
        assert cbs[3].last_verified_global_step == 1


# ------------------------------------------------------------- fit harness


def _arrays(n=32):
    rng = np.random.RandomState(7)
    y = rng.randint(0, 2, (n,)).astype(np.int64)
    x = (rng.randn(n, 4) * 0.3 + y[:, None] * 2.0).astype(np.float32)
    return x, y


class _Arrays(Dataset):
    def __init__(self):
        self.x, self.y = _arrays()

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class _JArrays(JDataset):
    def __init__(self):
        self.x, self.y = _arrays()

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class _Losses(paddle.hapi.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


def _jax_net(seed=11):
    jpaddle.seed(seed)
    return jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))


def _jax_model(seed=11):
    model = jpaddle.Model(_jax_net(seed))
    model.prepare(jpaddle.optimizer.Momentum(
        learning_rate=0.1, parameters=model.parameters()),
        jnn.CrossEntropyLoss())
    return model


def _model(seed=11):
    """The port's model with the weights of the JAX test's ``_model``."""
    paddle.set_device("cpu")
    paddle.seed(seed)
    net = carry(_jax_net(seed), nn.Sequential(nn.Linear(4, 8), nn.ReLU(),
                                              nn.Linear(8, 2)))
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Momentum(
        learning_rate=0.1, parameters=model.parameters()),
        nn.CrossEntropyLoss())
    return model


def _params_bytes(model):
    return {k: p.detach().numpy().tobytes()
            for k, p in model.network.named_parameters()}


def _fit(model, callbacks):
    model.fit(_Arrays(), batch_size=4, epochs=1, shuffle=False, verbose=0,
              callbacks=callbacks)


def _rollback_count(reason):
    fam = default_registry().get("training_rollbacks_total")
    return fam.labels(reason=reason).value if fam else 0


# ------------------------------------------------------------ step replay


class TestStepReplay:
    def test_clean_steps_replay_bitwise_identical(self):
        reg = MetricsRegistry()
        cb = IntegrityCallback(replay_every=3, fingerprint_every=0,
                               registry=reg, tracer=Tracer())
        model = _model()
        _fit(model, [cb])
        assert cb.events == []
        assert cb.checks["replay"] == 2            # steps 3 and 6 of 8
        assert reg.snapshot()["integrity_replay_seconds"]["value"][
            "count"] == 2

    def test_replay_changes_nothing_on_the_model(self):
        """Two fits from one seed, one with a replay every step, end in
        the same bytes, with the same losses."""
        runs = []
        for every in (0, 1):
            rec, model = _Losses(), _model()
            cb = IntegrityCallback(replay_every=every, fingerprint_every=0,
                                   registry=MetricsRegistry(),
                                   tracer=Tracer())
            _fit(model, [rec, cb])
            runs.append((rec.losses, _params_bytes(model),
                         {k: {n: t.numpy().tobytes() for n, t in s.items()}
                          for k, s in model._opt_state["slots"].items()},
                         model._opt_state["step"]))
        assert runs[0] == runs[1]

    def test_corrupted_step_caught_with_first_leaf_named(self):
        reg = MetricsRegistry()
        mon = HealthMonitor(action="gauge", registry=MetricsRegistry(),
                            tracer=Tracer())
        cb = IntegrityCallback(replay_every=3, fingerprint_every=0,
                               monitor=mon, registry=reg, tracer=Tracer())
        with injected_faults(FaultSpec("hapi.step_params", "bitflip",
                                       occurrence=3, leaf="0.weight",
                                       bit=21)):
            _fit(_model(), [cb, mon])
        assert len(cb.events) == 1
        ev = cb.events[0]
        assert ev["kind"] == "replay" and ev["global_step"] == 3
        assert ev["first_divergent_leaf"] == "0.weight"
        assert reg.get("integrity_divergence_total").labels(
            kind="replay").value == 1
        assert [k for k, _, _ in mon.events] == ["step_replay_mismatch"]


# --------------------------------------------- cross-rank fingerprints


def _run_ranks(tmp_path, corrupt_rank=1, monitor_ranks=(), world=3,
               occurrence=5, bit=17):
    """``TestCrossRankDivergence._run_ranks`` on the port."""
    store = TCPStore(is_master=True, world_size=1)
    cbs, losses, finals, mons = {}, {}, {}, {}
    for rank in range(world):
        reg = MetricsRegistry()
        mon = HealthMonitor(action="rollback", registry=reg,
                            tracer=Tracer()) if rank in monitor_ranks \
            else None
        cb = IntegrityCallback(store=store, rank=rank, world_size=world,
                               fingerprint_every=2, history=1000,
                               monitor=mon, registry=reg, tracer=Tracer())
        rec = _Losses()
        model = _model()
        ck = CheckpointCallback(str(tmp_path / f"ck{rank}"),
                                every_n_steps=1)
        cblist = [rec, cb, ck] + ([mon] if mon else [])
        if rank == corrupt_rank:
            with injected_faults(FaultSpec(
                    "hapi.step_params", "bitflip", occurrence=occurrence,
                    leaf="0.weight", bit=bit)):
                _fit(model, cblist)
        else:
            _fit(model, cblist)
        cbs[rank], losses[rank] = cb, rec.losses
        finals[rank], mons[rank] = _params_bytes(model), mon
    return cbs, losses, finals, mons


@pytest.fixture(scope="module")
def jax_detection(tmp_path_factory):
    """The JAX package's detect-only run of the same protocol: rank 1's
    first event."""
    tmp = tmp_path_factory.mktemp("jaxint")
    store = JaxStore(is_master=True, world_size=1)
    events = {}
    for rank in range(2):
        cb = JIntegrityCallback(store=store, rank=rank, world_size=2,
                                fingerprint_every=2, history=1000,
                                registry=JMetricsRegistry(),
                                tracer=JTracer())
        cblist = [cb, JCheckpointCallback(str(tmp / f"ck{rank}"),
                                          every_n_steps=1)]
        args = dict(batch_size=4, epochs=1, shuffle=False, verbose=0,
                    callbacks=cblist)
        if rank == 1:
            with jinjected_faults(JFaultSpec(
                    "hapi.step_params", "bitflip", occurrence=5,
                    leaf="0.weight", bit=17)):
                _jax_model().fit(_JArrays(), **args)
        else:
            _jax_model().fit(_JArrays(), **args)
        events[rank] = list(cb.events)
    assert events[0] == []
    return events[1][0]


class _JLosses(JCallback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


class TestCrossRankDivergence:
    def test_detection_names_rank_and_leaf_as_jax_does(self, tmp_path,
                                                       jax_detection):
        cbs, _, finals, _ = _run_ranks(tmp_path, world=2)
        assert cbs[0].events == []
        ev = cbs[1].events[0]
        assert ev["kind"] == "cross_rank"
        assert ev["divergent_ranks"] == [1]
        assert ev["self_divergent"] is True
        assert ev["last_verified_global_step"] == 4
        assert ev["global_step"] == 6
        for key in ("divergent_ranks", "global_step",
                    "last_verified_global_step", "majority_ranks"):
            assert ev[key] == jax_detection[key], key
        assert ev["first_divergent_leaf"] == \
            jax_detection["first_divergent_leaf"]
        assert ev["first_divergent_leaf"] == {1: "params/0.bias"}
        assert cbs[1].divergence_active is True
        assert finals[0] != finals[1]

    def test_e2e_bitflip_detected_repaired_bitwise_equal(self, tmp_path,
                                                         jax_detection):
        before = _rollback_count("param_divergence")
        cbs, losses, finals, mons = _run_ranks(tmp_path,
                                               monitor_ranks=(0, 1, 2))
        assert cbs[0].events == [] and cbs[2].events == []
        assert cbs[0].last_verified_global_step == 8
        ev = cbs[1].events[0]
        assert ev["divergent_ranks"] == [1]
        assert ev["first_divergent_leaf"] == \
            jax_detection["first_divergent_leaf"]
        assert _rollback_count("param_divergence") == before + 1
        assert len(losses[1]) == 10 and len(losses[0]) == 8
        assert losses[1][6:] == losses[0][4:]
        assert finals[1] == finals[0] == finals[2]
        assert cbs[1].divergence_active is False
        assert mons[1].healthy
        _, _, man = CheckpointManager(str(tmp_path / "ck1")).restore()
        repairs = man["extra"]["repairs"]
        assert len(repairs) == 1
        assert repairs[0]["reason"] == "param_divergence"
        assert repairs[0]["restored_global_step"] == 4
        assert repairs[0]["rewind"] is True
        assert "skipped_windows" not in man["extra"]

    def test_poisoned_newer_checkpoints_are_discarded(self, tmp_path):
        tracker = {}

        class _SpyMgr(CheckpointManager):
            def discard_after(self, step):
                tracker["steps_at_discard"] = self.steps()
                tracker["removed"] = super().discard_after(step)
                return tracker["removed"]

        store = TCPStore(is_master=True, world_size=1)

        def rank(r, faults=None):
            reg = MetricsRegistry()
            mon = HealthMonitor(action="rollback", registry=reg,
                                tracer=Tracer())
            cb = IntegrityCallback(store=store, rank=r, world_size=2,
                                   fingerprint_every=2, history=1000,
                                   monitor=mon, registry=reg,
                                   tracer=Tracer())
            ck = CheckpointCallback(
                manager=_SpyMgr(str(tmp_path / f"ck{r}")), every_n_steps=1)
            if faults:
                with injected_faults(faults):
                    _fit(_model(), [cb, ck, mon])
            else:
                _fit(_model(), [cb, ck, mon])

        rank(0)
        rank(1, FaultSpec("hapi.step_params", "bitflip", occurrence=5,
                          leaf="0.weight", bit=17))
        assert tracker["steps_at_discard"][-2:] == [5, 6]
        assert tracker["removed"] == [5, 6]

    def test_clean_ranks_match_jax_curve(self, tmp_path):
        """A clean rank's losses are the JAX package's on the same
        weights and data, at ``tests/test_resilience.py``'s 1e-5."""
        cbs, losses, _, _ = _run_ranks(tmp_path, corrupt_rank=None,
                                       world=2)
        assert cbs[0].events == [] and cbs[1].events == []
        rec = _JLosses()
        _jax_model().fit(_JArrays(), batch_size=4, epochs=1, shuffle=False,
                         verbose=0, callbacks=[rec])
        np.testing.assert_allclose(losses[0], rec.losses, rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------- supervisor evidence

_TREE = {"w": np.arange(4096, dtype=np.float32),
         "b": np.ones(8, np.float32)}


class TestSupervisorEvidence:
    def test_resume_evidence_carries_repairs_and_windows(self, tmp_path):
        from paddle_tpu_torch.resilience import TrainingSupervisor

        CheckpointManager(str(tmp_path)).save(_TREE, step=7, extra={
            "global_step": 7,
            "repairs": [{"reason": "param_divergence",
                         "restored_global_step": 4}],
            "skipped_windows": [{"reason": "non_finite_loss",
                                 "first_step": 2, "last_step": 2}]})
        ev = TrainingSupervisor(cmd=["true"],
                                checkpoint_dir=str(tmp_path)
                                )._resume_evidence()
        assert ev == {"resume_step": 7, "integrity_repairs": 1,
                      "last_repair_reason": "param_divergence",
                      "skipped_windows": 1,
                      "last_rollback_reason": "non_finite_loss"}

    def test_resume_evidence_plain_checkpoint(self, tmp_path):
        from paddle_tpu_torch.resilience import TrainingSupervisor

        CheckpointManager(str(tmp_path)).save(_TREE, step=3)
        assert TrainingSupervisor(
            cmd=["true"], checkpoint_dir=str(tmp_path))._resume_evidence() \
            == {"resume_step": 3}
