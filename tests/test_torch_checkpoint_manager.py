"""The port's ``CheckpointManager`` (``resilience.checkpoint_manager``):
``tests/test_resilience.py``'s ``TestCheckpointManager`` and
``TestCrashConsistency`` (a kill at every injected boundary finds the
previous committed step, bitwise intact) and
``tests/test_integrity.py``'s ``TestAuditOnSave``, on the port, at their
sizes.  Their ``framework_io.save`` case is left out: the port has no
``framework_io`` module.  On top: a step directory either package's
manager committed restores in the other's, and the async snapshot reuses
its host buffers from save to save.
"""
import os

import numpy as np
import pytest
import torch

from paddle_tpu.resilience import CheckpointManager as JaxManager
from paddle_tpu_torch.resilience import (CheckpointAuditError,
                                         CheckpointManager, FaultSpec,
                                         SimulatedCrash, injected_faults,
                                         verify_checkpoint)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _state(scale):
    """A deterministic tree whose every leaf is a function of ``scale``."""
    return {"w": np.arange(16.0).reshape(4, 4) * scale,
            "nested": {"b": np.full((3,), float(scale))},
            "step_marker": np.asarray([scale], np.int64)}


def _assert_state(tree, scale):
    ref = _state(scale)
    np.testing.assert_array_equal(tree["w"], ref["w"])
    np.testing.assert_array_equal(tree["nested/b"], ref["nested"]["b"])
    np.testing.assert_array_equal(tree["step_marker"], ref["step_marker"])


class TestCheckpointManager:
    def test_roundtrip_and_latest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.latest() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore()
        mgr.save(_state(1), step=1)
        mgr.save(_state(2), step=2)
        assert mgr.steps() == [1, 2] and mgr.latest() == 2
        step, tree, manifest = mgr.restore()
        assert step == 2 and manifest["step"] == 2
        _assert_state(tree, 2)
        step, tree, _ = mgr.restore(step=1)
        assert step == 1
        _assert_state(tree, 1)

    def test_resave_of_committed_step_supersedes(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(_state(1), step=1)
        mgr.save(_state(2), step=2)
        mgr.save(_state(7), step=2)
        step, tree, _ = mgr.restore()
        assert step == 2
        _assert_state(tree, 7)

    def test_retention_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
        for i in (1, 2, 3, 4):
            mgr.save(_state(i), step=i)
        assert mgr.steps() == [3, 4]

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(_state(1), step=1)
        mgr.wait()
        assert mgr.latest() == 1
        _, tree, _ = mgr.restore()
        _assert_state(tree, 1)

    def test_async_save_snapshots_before_handoff(self, tmp_path):
        """A trainer mutating its live tree right after ``save`` returns
        cannot tear the bytes being written (numpy leaves and tensors,
        which the port's steps update in place)."""
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        live = _state(1)
        live["t"] = torch.arange(8.0)
        with injected_faults(FaultSpec("checkpoint.before_shard", "stall",
                                       stall_s=0.2)):
            mgr.save(live, step=1)
            live["w"][:] = -777.0
            live["nested"]["b"][:] = -777.0
            live["t"].fill_(-777.0)
            mgr.wait()
        step, tree, _ = mgr.restore()
        assert step == 1
        _assert_state(tree, 1)
        np.testing.assert_array_equal(tree["t"], np.arange(8.0))

    def test_async_snapshot_reuses_its_buffers(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        live = {"t": torch.arange(8.0), "u": torch.ones(2, 2)}
        mgr.save(live, step=1)
        first = mgr._snapshot.take(live)
        mgr.wait()
        live["t"] += 1
        mgr.save(live, step=2)
        mgr.wait()
        again = mgr._snapshot.take(live)
        assert again["t"].data_ptr() == first["t"].data_ptr()
        _, tree, _ = mgr.restore()
        np.testing.assert_array_equal(tree["t"], np.arange(8.0) + 1)

    def test_restore_before_step_skips_newer(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        for i in (1, 2, 3):
            mgr.save(_state(i), step=i)
        step, tree, _ = mgr.restore(before_step=3)
        assert step == 2
        _assert_state(tree, 2)
        with pytest.raises(FileNotFoundError):
            mgr.restore(before_step=1)

    def test_corrupt_committed_checkpoint_falls_back(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(_state(1), step=1)
        mgr.save(_state(2), step=2)
        p2 = mgr.step_path(2)
        victim = next(os.path.join(r, f) for r, _, fs in os.walk(p2)
                      for f in sorted(fs) if f.endswith(".npy"))
        with open(victim, "r+b") as f:
            f.seek(80)
            f.write(b"\xff\xff\xff\xff")
        ok, errors = verify_checkpoint(p2)
        assert not ok and "crc32" in errors[0]
        assert mgr.latest() == 1
        step, tree, _ = mgr.restore()
        assert step == 1
        _assert_state(tree, 1)
        with pytest.raises(ValueError, match="verification"):
            mgr.restore(step=2)

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_either_package_restores_the_others(self, tmp_path, writer):
        w = (JaxManager if writer == "jax" else CheckpointManager)(
            str(tmp_path), keep_last_n=2)
        for i in (1, 2, 3):
            w.save(_state(i), step=i, extra={"global_step": i})
        r = (CheckpointManager if writer == "jax" else JaxManager)(
            str(tmp_path))
        assert r.steps() == [2, 3] and r.latest() == 3
        step, tree, manifest = r.restore()
        assert step == 3 and manifest["extra"] == {"global_step": 3}
        _assert_state(tree, 3)


@pytest.mark.faultinject
class TestCrashConsistency:
    KILL_POINTS = [
        ("checkpoint.before_shard", 1),
        ("checkpoint.before_shard", 3),
        ("checkpoint.shard_write", 1),
        ("checkpoint.shard_write", 2),
        ("checkpoint.before_manifest", 1),
        ("checkpoint.manifest_write", 1),
        ("checkpoint.before_commit", 1),
    ]

    def test_kill_after_commit_keeps_new_step(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(_state(1), step=1)
        with injected_faults(FaultSpec("checkpoint.after_commit", "kill")):
            with pytest.raises(SimulatedCrash):
                mgr.save(_state(2), step=2)
        assert CheckpointManager(str(tmp_path)).latest() == 2
        step, tree, _ = mgr.restore()
        assert step == 2
        _assert_state(tree, 2)

    def test_kill_mid_model_save_keeps_old_blob(self, tmp_path):
        """``hapi`` ``Model.save`` writes through the ``hapi.model_save``
        site: a kill mid-write leaves the previous ``.pdparams``."""
        import pickle

        import paddle_tpu_torch as paddle
        import paddle_tpu_torch.nn as nn
        from paddle_tpu_torch.hapi import Model

        paddle.set_device("cpu")
        paddle.seed(0)
        model = Model(nn.Linear(4, 2))
        path = str(tmp_path / "m")
        model.save(path)
        with open(path + ".pdparams", "rb") as f:
            before = pickle.load(f)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
        with injected_faults(FaultSpec("hapi.model_save", "kill")):
            with pytest.raises(SimulatedCrash):
                model.save(path)
        with open(path + ".pdparams", "rb") as f:
            after = pickle.load(f)
        for k, v in before["params"].items():
            np.testing.assert_array_equal(after["params"][k], v)

    def test_killed_save_tmp_dir_swept_on_init(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(_state(1), step=1)
        with injected_faults(FaultSpec("checkpoint.before_manifest",
                                       "kill")):
            with pytest.raises(SimulatedCrash):
                mgr.save(_state(2), step=2)
        assert [n for n in os.listdir(str(tmp_path))
                if n.endswith(".tmp")] == ["step_0000000002.tmp"]
        mgr2 = CheckpointManager(str(tmp_path))
        assert not [n for n in os.listdir(str(tmp_path))
                    if n.endswith(".tmp")]
        assert mgr2.latest() == 1
        with injected_faults(FaultSpec("checkpoint.before_commit", "kill")):
            with pytest.raises(SimulatedCrash):
                mgr2.save(_state(3), step=3)
        CheckpointManager(str(tmp_path), sweep_orphans=False)
        assert [n for n in os.listdir(str(tmp_path))
                if n.endswith(".tmp")] == ["step_0000000003.tmp"]

    @pytest.mark.parametrize("site,occurrence", KILL_POINTS)
    def test_kill_point_recovers_previous_step(self, tmp_path, site,
                                               occurrence):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(_state(1), step=1)
        with injected_faults(FaultSpec(site, "kill", occurrence=occurrence)):
            with pytest.raises(SimulatedCrash):
                mgr.save(_state(2), step=2)
        assert mgr.latest() == 1
        step, tree, _ = mgr.restore()
        assert step == 1
        _assert_state(tree, 1)
        mgr.save(_state(2), step=2)
        step, tree, _ = mgr.restore()
        assert step == 2
        _assert_state(tree, 2)

    def test_torn_shard_write_never_commits(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(_state(1), step=1)
        with injected_faults(FaultSpec("checkpoint.shard_write",
                                       "torn_write", occurrence=2)):
            with pytest.raises(SimulatedCrash):
                mgr.save(_state(2), step=2)
        assert mgr.latest() == 1
        step, tree, _ = mgr.restore()
        assert step == 1
        _assert_state(tree, 1)

    def test_transient_io_error_then_clean_retry(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        with injected_faults(FaultSpec("checkpoint.shard_write", "io_error",
                                       occurrence=1)):
            with pytest.raises(OSError):
                mgr.save(_state(1), step=1)
            mgr.save(_state(1), step=1)
        step, tree, _ = mgr.restore()
        assert step == 1
        _assert_state(tree, 1)


_TREE = {"w": np.arange(4096, dtype=np.float32),
         "b": np.ones(8, np.float32)}


@pytest.mark.faultinject
class TestAuditOnSave:
    def test_bitflip_after_commit_fails_audit_old_kept(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last_n=1)
        mgr.save(_TREE, step=1)
        with injected_faults(FaultSpec("checkpoint.after_commit",
                                       "bitflip"), seed=0):
            with pytest.raises(CheckpointAuditError) as ei:
                mgr.save(_TREE, step=2, verify=True)
        assert ei.value.step == 2
        assert mgr.steps() == [1, 2]
        step, tree, _ = CheckpointManager(str(tmp_path)).restore()
        assert step == 1
        np.testing.assert_array_equal(tree["w"], _TREE["w"])

    def test_without_verify_corrupt_save_becomes_only_candidate(
            self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last_n=1)
        mgr.save(_TREE, step=1)
        with injected_faults(FaultSpec("checkpoint.after_commit",
                                       "bitflip"), seed=0):
            mgr.save(_TREE, step=2)
        assert mgr.steps() == [2]
        with pytest.raises(FileNotFoundError):
            CheckpointManager(str(tmp_path)).restore()

    def test_torn_write_after_commit_old_kept(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last_n=1)
        mgr.save(_TREE, step=1)
        with injected_faults(FaultSpec("checkpoint.after_commit",
                                       "torn_write"), seed=1):
            with pytest.raises(SimulatedCrash):
                mgr.save(_TREE, step=2, verify=True)
        step, _, _ = CheckpointManager(str(tmp_path)).restore()
        assert step == 1

    def test_async_audit_failure_surfaces_from_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last_n=1,
                                async_save=True, verify_on_save=True)
        mgr.save(_TREE, step=1)
        mgr.wait()
        with injected_faults(FaultSpec("checkpoint.after_commit",
                                       "bitflip"), seed=0):
            mgr.save(_TREE, step=2)
            with pytest.raises(CheckpointAuditError):
                mgr.wait()
        assert mgr.steps() == [1, 2]

    def test_clean_save_passes_audit(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last_n=1,
                                verify_on_save=True)
        mgr.save(_TREE, step=1)
        mgr.save(_TREE, step=2)
        assert mgr.steps() == [2]

    def test_discard_after(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        for s in range(1, 6):
            mgr.save(_TREE, step=s)
        assert mgr.discard_after(2) == [3, 4, 5]
        assert mgr.steps() == [1, 2] and mgr.latest() == 2
