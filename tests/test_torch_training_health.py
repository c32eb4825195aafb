"""The port's goodput accounting (``observability.goodput``) and training
health monitor (``observability.health``) with the health rollback of
``Model.fit``: ``tests/test_training_health.py``'s ``TestGoodput``,
``TestHealthMonitor`` and ``TestHealthRollback`` on the port, at their
sizes and tolerances, the rollback's loss curves also held to the JAX
package's run of the same weights.  Its ``TestCrossRankAggregation``,
``TestStatBridge`` and ``TestUnitSuffixLint`` are left out: they test
the JAX package's ``observability/aggregate.py``, its stat bridge and
its lint, which the port has not taken over.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu.observability import HealthMonitor as JHealthMonitor
from paddle_tpu.observability import MetricsRegistry as JMetricsRegistry
from paddle_tpu.observability import Tracer as JTracer

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.observability import (GoodputMonitor, HealthMonitor,
                                            MetricsRegistry, Tracer,
                                            TrainingHealthError,
                                            default_registry,
                                            default_tracer)
from paddle_tpu_torch.observability.compile_watchdog import (
    default_watchdog, watchdog_enabled)
from paddle_tpu_torch.observability.goodput import device_peak_flops, mfu
from torch_eager_ref import carry

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Toy(Dataset):
    def __init__(self, n=16, bad_at=None):
        rng = np.random.RandomState(0)
        self.x = rng.randn(n, 4).astype(np.float32)
        self.y = rng.randint(0, 2, (n,)).astype(np.int64)
        if bad_at is not None:
            self.x[bad_at] = np.inf

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _model():
    paddle.set_device("cpu")
    model = paddle.Model(nn.Sequential(nn.Linear(4, 8), nn.ReLU(),
                                       nn.Linear(8, 2)))
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    model.prepare(opt, nn.CrossEntropyLoss())
    return model


class ManualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------- goodput


class TestGoodput:
    def test_peak_flops_table_and_env(self, monkeypatch):
        flops, kind = device_peak_flops()
        assert kind == "cpu" and flops == 1.0e12
        monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "5e13")
        assert device_peak_flops()[0] == 5e13

    def test_h100_entry(self):
        from paddle_tpu_torch.observability.goodput import PEAK_FLOPS

        assert PEAK_FLOPS["H100"] == 989e12
        table_kind = "NVIDIA H100 80GB HBM3"
        best = max((k for k in PEAK_FLOPS if k.lower() in
                    table_kind.lower()), key=len)
        assert PEAK_FLOPS[best] == 989e12

    def test_mfu_estimator(self):
        assert mfu(1e12, 0.5, 4e12) == pytest.approx(0.5)
        assert mfu(None, 0.5, 4e12) is None
        assert mfu(1e12, 0.5, None) is None

    def test_breakdown_sums_to_wall_time(self):
        reg = MetricsRegistry()
        default_watchdog().reset()
        mon = GoodputMonitor(registry=reg)
        model = _model()
        with watchdog_enabled():
            t0 = time.perf_counter()
            model.fit(Toy(32), batch_size=4, epochs=2, verbose=0,
                      callbacks=[mon])
            wall = time.perf_counter() - t0
        rep = mon.report()
        assert rep["steps"] == 16
        assert sum(rep["phases_seconds"].values()) == \
            pytest.approx(rep["total_seconds"], rel=1e-3)
        assert rep["total_seconds"] == pytest.approx(wall, rel=0.05)
        assert rep["phases_seconds"]["compile"] > 0
        assert rep["phases_seconds"]["compute"] > 0
        assert 0 < rep["goodput_ratio"] <= 1
        snap = reg.snapshot()
        assert snap["training_goodput_ratio"]["value"]["current"] == \
            pytest.approx(rep["goodput_ratio"])
        phases = {s["labels"]["phase"]: s["value"]["current"]
                  for s in snap["training_step_breakdown_seconds"]["series"]}
        assert phases == pytest.approx(rep["phases_seconds"])
        assert snap["training_step_seconds"]["value"]["count"] == 16

    def test_mfu_published_with_explicit_flops(self):
        reg = MetricsRegistry()
        mon = GoodputMonitor(registry=reg, peak_flops=1e12,
                             flops_per_step=5e9)
        _model().fit(Toy(8), batch_size=4, epochs=1, verbose=0,
                     callbacks=[mon])
        rep = mon.report()
        assert rep["mfu"] is not None and rep["mfu"] > 0
        assert rep["peak_flops"] == 1e12
        assert reg.snapshot()["training_mfu"]["value"]["current"] == \
            pytest.approx(rep["mfu"])

    def test_checkpoint_phase_and_save_histogram(self, tmp_path):
        from paddle_tpu_torch.hapi import CheckpointCallback

        reg = default_registry()
        reg.unregister("checkpoint_save_seconds")
        mon = GoodputMonitor(registry=reg)
        ckpt = CheckpointCallback(save_dir=str(tmp_path), every_n_steps=2)
        _model().fit(Toy(16), batch_size=4, epochs=1, verbose=0,
                     callbacks=[mon, ckpt])
        rep = mon.report()
        assert rep["phases_seconds"]["checkpoint"] > 0
        assert reg.get("checkpoint_save_seconds").labels(
            mode="sync").total == 2
        assert sum(rep["phases_seconds"].values()) == \
            pytest.approx(rep["total_seconds"], rel=1e-3)

    def test_async_save_records_blocking_and_background(self, tmp_path):
        from paddle_tpu_torch.hapi import CheckpointCallback
        from paddle_tpu_torch.resilience import CheckpointManager

        reg = default_registry()
        reg.unregister("checkpoint_save_seconds")
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        _model().fit(Toy(8), batch_size=4, epochs=1, verbose=0,
                     callbacks=[CheckpointCallback(manager=mgr,
                                                   every_n_steps=2)])
        mgr.wait()
        h = reg.get("checkpoint_save_seconds")
        assert {lv[0] for lv, _ in h._series()} == {"async", "background"}
        assert h.labels(mode="async").total == 1
        assert h.labels(mode="background").total == 1

    def test_benchmark_step_info_exposes_totals(self):
        from paddle_tpu_torch.profiler.timer import Benchmark

        bm = Benchmark(warmup_steps=0)
        bm.before_reader()
        bm.after_reader()
        bm.step_start()
        bm.step_end(num_samples=4)
        info = bm.step_info()
        assert {"batch_cost_total", "reader_cost_total", "samples",
                "reader_ratio"} <= set(info)
        assert info["samples"] == 4
        bm.before_reader()
        bm.after_reader()
        assert bm.take_pending_reader_cost() >= 0
        assert bm.take_pending_reader_cost() == 0.0


# ----------------------------------------------------------------- health


class TestHealthMonitor:
    def _drive(self, mon, seq, dt=0.1):
        clk = mon._clock
        for i, (loss, gnorm) in enumerate(seq):
            mon.on_train_batch_begin(i)
            clk.t += dt[i] if isinstance(dt, (list, tuple)) else dt
            logs = {"loss": loss}
            if gnorm is not None:
                logs["grad_norm"] = gnorm
            mon.on_train_batch_end(i, logs)

    def _mon(self, **kw):
        kw.setdefault("registry", MetricsRegistry())
        kw.setdefault("tracer", Tracer())
        kw.setdefault("clock", ManualClock())
        mon = HealthMonitor(**kw)
        mon.set_model(None)
        mon.on_train_begin()
        return mon

    def _anomalies(self, mon):
        c = mon.registry().get("training_anomalies_total")
        return {lv[0]: child.value for lv, child in c._series()} \
            if c else {}

    def test_nan_loss_flagged_exactly_once(self):
        mon = self._mon(action="gauge")
        self._drive(mon, [(1.0, None)] * 5 + [(float("nan"), None)] * 5)
        assert self._anomalies(mon) == {"non_finite_loss": 1}
        assert mon.registry().get("training_healthy").value == 0
        assert not mon.healthy
        assert [t["name"] for t in mon.tracer().traces()] == \
            ["health::non_finite_loss"]

    def test_recovery_flips_gauge_back(self):
        mon = self._mon(action="gauge", recover_after=2)
        self._drive(mon, [(1.0, None)] * 3 + [(float("inf"), None)]
                    + [(1.0, None)])
        assert mon.registry().get("training_healthy").value == 0
        self._drive(mon, [(1.0, None)])
        assert mon.registry().get("training_healthy").value == 1

    def test_grad_spike_zscore(self):
        mon = self._mon(action="gauge", min_samples=5, window=20)
        rng = np.random.RandomState(0)
        seq = [(1.0, 1.0 + 0.05 * rng.randn()) for _ in range(15)]
        self._drive(mon, seq + [(1.0, 50.0)])
        assert self._anomalies(mon) == {"grad_spike": 1}
        assert [e[0] for e in mon.events] == ["grad_spike"]

    def test_step_time_outlier(self):
        mon = self._mon(action="gauge", min_samples=5, step_time_zscore=4.0)
        rng = np.random.RandomState(1)
        dts = [0.1 + 0.005 * abs(rng.randn()) for _ in range(15)] + [5.0]
        self._drive(mon, [(1.0, None)] * 16, dt=dts)
        assert self._anomalies(mon) == {"step_time_outlier": 1}

    def test_loss_plateau(self):
        mon = self._mon(action="gauge", plateau_window=5,
                        plateau_min_delta=1e-3)
        losses = [1.0 - 0.05 * i for i in range(10)] + [0.5] * 10
        self._drive(mon, [(l, None) for l in losses])
        assert self._anomalies(mon).get("loss_plateau", 0) >= 1

    def test_action_raise(self):
        mon = self._mon(action="raise")
        with pytest.raises(TrainingHealthError) as ei:
            self._drive(mon, [(float("nan"), None)])
        assert ei.value.kind == "non_finite_loss"

    def test_fit_injected_nan_batch(self):
        reg = MetricsRegistry()
        mon = HealthMonitor(action="gauge", registry=reg, tracer=Tracer())
        _model().fit(Toy(16, bad_at=8), batch_size=4, epochs=1, verbose=0,
                     callbacks=[mon])
        snap = reg.snapshot()
        by_kind = {s["labels"]["kind"]: s["value"]
                   for s in snap["training_anomalies_total"]["series"]}
        assert by_kind["non_finite_loss"] == 1
        assert snap["training_healthy"]["value"]["current"] == 0

    def test_fit_reports_grad_norm(self):
        seen = []

        class Spy(paddle.hapi.Callback):
            def on_train_batch_end(self, step, logs=None):
                seen.append((logs or {}).get("grad_norm"))

        mon = HealthMonitor(action="gauge", registry=MetricsRegistry(),
                            tracer=Tracer())
        _model().fit(Toy(8), batch_size=4, epochs=1, verbose=0,
                     callbacks=[mon, Spy()])
        assert len(seen) == 2
        assert all(g is not None and np.isfinite(g) and g > 0 for g in seen)
        assert mon.healthy


# ------------------------------------------------- health-triggered rollback


class _Arrays(Dataset):
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _rollback_problem(bad_batches=(5,), batch=4, n=32):
    rng = np.random.RandomState(7)
    y = rng.randint(0, 2, (n,)).astype(np.int64)
    x = (rng.randn(n, 4) * 0.3 + y[:, None] * 2.0).astype(np.float32)
    bad = x.copy()
    keep = np.ones(n, bool)
    for b in bad_batches:
        bad[b * batch:(b + 1) * batch] = np.nan
        keep[b * batch:(b + 1) * batch] = False
    return (bad, y), (x[keep], y[keep])


def _jax_net(seed):
    jpaddle.seed(seed)
    return jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))


def _rb_model(seed=11):
    """The port's model with the weights the JAX test's ``_rb_model``
    draws from ``seed``."""
    paddle.set_device("cpu")
    paddle.seed(seed)
    net = carry(_jax_net(seed), nn.Sequential(nn.Linear(4, 8), nn.ReLU(),
                                              nn.Linear(8, 2)))
    model = paddle.Model(net)
    opt = paddle.optimizer.Momentum(learning_rate=0.1,
                                    parameters=model.parameters())
    model.prepare(opt, nn.CrossEntropyLoss())
    return model


class _Losses(paddle.hapi.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


def _rollback_count(reason):
    fam = default_registry().get("training_rollbacks_total")
    return fam.labels(reason=reason).value if fam else 0


def _fit(model, arrays, callbacks, **kw):
    model.fit(_Arrays(*arrays), batch_size=4, epochs=1, shuffle=False,
              verbose=0, callbacks=callbacks, **kw)


class TestHealthRollback:
    def test_nan_batch_rolls_back_once_and_skips_window(self, tmp_path):
        from paddle_tpu.hapi import Callback as JCallback
        from paddle_tpu.hapi import CheckpointCallback as JCkpt
        from paddle_tpu.io import Dataset as JDataset
        from paddle_tpu_torch.hapi import CheckpointCallback
        from paddle_tpu_torch.resilience import CheckpointManager

        data, ref_data = _rollback_problem(bad_batches=(5,))
        ref_rec = _Losses()
        _fit(_rb_model(), ref_data, [ref_rec, HealthMonitor(action="gauge")])
        assert len(ref_rec.losses) == 7

        before = _rollback_count("non_finite_loss")
        rec = _Losses()
        mon = HealthMonitor(action="rollback")
        ckdir = str(tmp_path / "ck")
        _fit(_rb_model(), data,
             [rec, mon, CheckpointCallback(ckdir, every_n_steps=1)])
        assert len(rec.losses) == 8
        assert not np.isfinite(rec.losses[5])
        assert _rollback_count("non_finite_loss") == before + 1
        assert mon.rollbacks == 1 and mon.healthy
        np.testing.assert_allclose(rec.losses[:5], ref_rec.losses[:5], **TOL)
        np.testing.assert_allclose(rec.losses[6:], ref_rec.losses[5:], **TOL)
        _, _, manifest = CheckpointManager(ckdir).restore()
        windows = manifest["extra"]["skipped_windows"]
        assert len(windows) == 1
        w = windows[0]
        assert w["reason"] == "non_finite_loss"
        assert (w["first_step"], w["last_step"]) == (5, 5)
        assert w["restored_global_step"] == 5
        names = [t["name"] for t in default_tracer().traces()]
        assert "supervisor::rollback" in names

        # the JAX package's rollback run of the same weights and data
        class JArrays(JDataset):
            def __len__(self):
                return len(data[0])

            def __getitem__(self, i):
                return data[0][i], data[1][i]

        class JLosses(JCallback):
            losses = []

            def on_train_batch_end(self, step, logs=None):
                self.losses.append(logs["loss"])

        jmodel = jpaddle.Model(_jax_net(11))
        jmodel.prepare(jpaddle.optimizer.Momentum(
            learning_rate=0.1, parameters=jmodel.parameters()),
            jnn.CrossEntropyLoss())
        jrec = JLosses()
        jmodel.fit(JArrays(), batch_size=4, epochs=1, shuffle=False,
                   verbose=0, callbacks=[
                       jrec, JHealthMonitor(action="rollback",
                                            registry=JMetricsRegistry(),
                                            tracer=JTracer()),
                       JCkpt(str(tmp_path / "jck"), every_n_steps=1)])
        finite = [i for i in range(8) if i != 5]
        np.testing.assert_allclose(np.asarray(rec.losses)[finite],
                                   np.asarray(jrec.losses)[finite], **TOL)

    @pytest.mark.faultinject
    def test_kill_right_after_rollback_resumes_past_window(self, tmp_path):
        from paddle_tpu_torch.hapi import CheckpointCallback
        from paddle_tpu_torch.resilience import (CheckpointManager,
                                                 FaultSpec, SimulatedCrash,
                                                 injected_faults)

        data, ref_data = _rollback_problem(bad_batches=(5,))
        ref_rec = _Losses()
        _fit(_rb_model(), ref_data, [ref_rec, HealthMonitor(action="gauge")])
        ckdir = str(tmp_path / "ck")
        rec_a = _Losses()
        with injected_faults(FaultSpec("hapi.train_step", "kill",
                                       occurrence=6)):
            with pytest.raises(SimulatedCrash):
                _fit(_rb_model(), data,
                     [rec_a, HealthMonitor(action="rollback"),
                      CheckpointCallback(ckdir, every_n_steps=1)])
        assert len(rec_a.losses) == 6
        rec_b = _Losses()
        mon_b = HealthMonitor(action="rollback")
        _fit(_rb_model(seed=99), data,
             [rec_b, mon_b, CheckpointCallback(ckdir, every_n_steps=1)],
             resume_from=ckdir)
        assert len(rec_b.losses) == 2
        assert mon_b.events == []
        np.testing.assert_allclose(rec_b.losses, ref_rec.losses[5:], **TOL)
        _, _, manifest = CheckpointManager(ckdir).restore()
        assert len(manifest["extra"]["skipped_windows"]) == 1

    def test_rollback_without_checkpoint_callback_raises(self):
        data, _ = _rollback_problem(bad_batches=(2,), n=16)
        with pytest.raises(TrainingHealthError) as ei:
            _fit(_rb_model(), data, [HealthMonitor(action="rollback")])
        assert ei.value.kind == "non_finite_loss"
        assert "CheckpointCallback" in str(ei.value)

    def test_max_rollbacks_escalates(self, tmp_path):
        from paddle_tpu_torch.hapi import CheckpointCallback

        data, _ = _rollback_problem(bad_batches=(2, 5))
        mon = HealthMonitor(action="rollback", max_rollbacks=1)
        with pytest.raises(TrainingHealthError):
            _fit(_rb_model(), data,
                 [mon, CheckpointCallback(str(tmp_path / "ck"),
                                          every_n_steps=1)])
        assert mon.rollbacks == 2

    def test_grad_spike_requests_rollback(self):
        class Stub:
            _rollback_request = None

        mon = HealthMonitor(action="rollback", min_samples=5, window=20,
                            registry=MetricsRegistry(), tracer=Tracer(),
                            clock=ManualClock())
        mon.set_model(Stub())
        mon.on_train_begin()
        rng = np.random.RandomState(0)
        for i in range(15):
            mon.on_train_batch_begin(i)
            mon.on_train_batch_end(
                i, {"loss": 1.0, "grad_norm": 1.0 + 0.05 * rng.randn()})
        mon.on_train_batch_begin(15)
        mon.on_train_batch_end(15, {"loss": 1.0, "grad_norm": 50.0})
        req = mon.model._rollback_request
        assert req is not None and req["reason"] == "grad_spike"
        assert mon.rollbacks == 1
