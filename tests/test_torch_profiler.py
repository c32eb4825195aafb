"""The port's profiling modules against the JAX package's: the phase
markers and the sampling profiler (``observability/profiling.py``), the
``Profiler`` with its step scheduler, ``RecordEvent`` and the
chrome-trace export (``profiler/profiler.py``), and the ``Benchmark``
timer (``profiler/timer.py``).

The JAX package's own tests of these (``tests/test_profiling.py``
``TestPhaseMarkers``/``TestSamplerCore``, and ``tests/test_observability.py``
``TestScheduler``/``TestChromeExport``/``TestBenchmarkWarmupBoundary``)
are mirrored on the port, and each ``*_as_jax`` test drives both
packages through one sequence on manual clocks and holds the port's
records (event kinds and names in order, phase slices, sampled seconds,
captures, timer totals) equal to JAX's.  All host-side: no device."""
import json
import threading
import time
import types

import pytest
import torch

import paddle_tpu.observability.metrics as jax_metrics
import paddle_tpu.observability.profiling as jax_profiling
import paddle_tpu.observability.tracing as jax_tracing
import paddle_tpu.profiler.profiler as jax_profiler
import paddle_tpu.profiler.timer as jax_timer
import paddle_tpu_torch
import paddle_tpu_torch.observability.metrics as port_metrics
import paddle_tpu_torch.observability.profiling as port_profiling
import paddle_tpu_torch.observability.tracing as port_tracing
import paddle_tpu_torch.profiler.profiler as port_profiler
import paddle_tpu_torch.profiler.timer as port_timer
from paddle_tpu_torch.observability.metrics import default_registry
from paddle_tpu_torch.observability.profiling import (current_phase,
                                                      diff_profiles, phase)
from paddle_tpu_torch.observability.tracing import Tracer, activate
from paddle_tpu_torch.profiler import (Benchmark, Profiler, ProfilerState,
                                       ProfilerTarget, RecordEvent,
                                       make_scheduler)

torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(
        metrics=jax_metrics, profiling=jax_profiling, tracing=jax_tracing,
        profiler=jax_profiler, timer=jax_timer),
    "port": types.SimpleNamespace(
        metrics=port_metrics, profiling=port_profiling,
        tracing=port_tracing, profiler=port_profiler, timer=port_timer),
}


class _ManualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _sampler(clock, pkg=PKGS["port"], **kw):
    kw.setdefault("registry", pkg.metrics.MetricsRegistry())
    return pkg.profiling.StackSampler(clock=clock, **kw)


def test_exports():
    assert paddle_tpu_torch.Benchmark is Benchmark
    assert paddle_tpu_torch.profiler.Profiler is Profiler
    assert ProfilerTarget.GPU == "gpu" and ProfilerTarget.CPU == "cpu"


# ------------------------------------------------------- phase markers


class TestPhaseMarkers:
    def test_nesting_is_innermost_wins_and_cleans_up(self):
        assert current_phase() is None
        with phase("decode"):
            assert current_phase() == "decode"
            with phase("checkpoint"):
                assert current_phase() == "checkpoint"
            assert current_phase() == "decode"
        assert current_phase() is None

    def test_cross_thread_read(self):
        seen = {}
        ready, done = threading.Event(), threading.Event()

        def work():
            with phase("prefill_chunk"):
                ready.set()
                done.wait(5.0)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        assert ready.wait(5.0)
        seen["phase"] = current_phase(t.ident)
        done.set()
        t.join(5.0)
        assert not t.is_alive()
        assert seen["phase"] == "prefill_chunk"
        assert current_phase(t.ident) is None       # registry cleaned


# --------------------------------------------------------- sampler core


class TestSamplerCore:
    def test_phase_attribution_and_sum_invariant(self):
        clock = _ManualClock()
        s = _sampler(clock, interval_s=0.1)
        with phase("decode"):
            for _ in range(3):
                clock.advance(0.1)
                s.sample_once()
        with phase("checkpoint"):
            for _ in range(2):
                clock.advance(0.1)
                s.sample_once()
        clock.advance(0.1)
        s.sample_once()                             # unattributed walk
        prof = s.profile()
        assert prof["by_phase"]["decode"]["samples"] == 3
        assert prof["by_phase"]["checkpoint"]["samples"] == 2
        assert abs(prof["by_phase"]["decode"]["seconds"] - 0.3) < 1e-9
        # phase slices sum EXACTLY to the sampled wall time
        assert abs(sum(v["seconds"] for v in prof["by_phase"].values())
                   - prof["sampled_seconds"]) < 1e-9
        assert sum(v["samples"] for v in prof["by_phase"].values()) \
            == prof["samples"]
        # the calling thread's stack is interned and counted
        assert any("test_torch_profiler" in k for k in prof["stacks"])

    def test_windowed_selection_and_retention(self):
        clock = _ManualClock()
        s = _sampler(clock, interval_s=1.0, retention_s=10.0)
        with phase("decode"):
            for _ in range(6):
                clock.advance(1.0)
                s.sample_once()                     # walks at t=1..6
        prof = s.profile(window_seconds=2.5, end_s=6.0)
        # window (3.5, 6.0] keeps the walks at t=4,5,6
        assert prof["by_phase"]["decode"]["samples"] == 3
        assert s.profile()["by_phase"]["decode"]["samples"] == 6
        clock.advance(20.0)
        s.sample_once()
        assert s.profile()["by_phase"].get("decode") is None

    def test_phase_filter_restricts_stacks_not_slices(self):
        clock = _ManualClock()
        s = _sampler(clock)
        with phase("decode"):
            clock.advance(0.1)
            s.sample_once()
        with phase("checkpoint"):
            clock.advance(0.1)
            s.sample_once()
        prof = s.profile(phase="decode")
        assert "checkpoint" in prof["by_phase"]
        assert prof["stacks"]
        assert sum(v["samples"] for v in prof["stacks"].values()) \
            <= prof["by_phase"]["decode"]["samples"] * 2

    def test_ambient_span_fallback_attribution(self):
        clock = _ManualClock()
        tracer = Tracer()
        s = _sampler(clock, tracer=tracer)
        span = tracer.start_trace("decode[3]")
        with activate(span):
            clock.advance(0.1)
            s.sample_once()
        span.end()
        prof = s.profile()
        assert prof["by_phase"]["decode"]["samples"] == 1
        with s._lock:
            tids = {row[3] for row in s._samples}
        assert span.trace_id in tids

    def test_stack_table_overflow_collapses_to_sentinel(self):
        clock = _ManualClock()
        s = _sampler(clock, max_stacks=1)
        for _ in range(3):
            clock.advance(0.1)
            s.sample_once()
        prof = s.profile()
        assert s.stats()["stacks_interned"] <= 2    # 1 real + sentinel
        if len(prof["stacks"]) > 1:
            assert "(stack-table-full)" in prof["stacks"]

    def test_nothing_on_import_thread_opt_in(self):
        s = _sampler(None, interval_s=0.005)
        assert s.running is False
        with s:
            assert s.running is True
            deadline = time.perf_counter() + 5.0
            while s.stats()["lifetime_samples"] == 0 and \
                    time.perf_counter() < deadline:
                time.sleep(0.005)
        assert s.running is False
        assert s.stats()["lifetime_samples"] > 0
        assert s.stats()["overhead_ratio"] is not None

    def test_capture_without_context_or_tracer_still_records(self):
        clock = _ManualClock()
        s = _sampler(clock)
        assert s.trigger_capture("manual", window_s=0.2)
        clock.advance(0.1)
        s.sample_once()
        clock.advance(0.2)
        s.sample_once()
        cap = s.last_capture()
        assert cap["trigger"] == "manual"
        assert cap["trace_id"] is None and cap.get("span_id") is None

    def test_diff_profiles_normalizes_and_ranks(self):
        cur = {"samples": 10, "window_seconds": 60,
               "stacks": {"main;a;hot": {"samples": 8},
                          "main;b": {"samples": 2}},
               "by_phase": {"decode": {"samples": 10}}}
        base = {"samples": 20, "window_seconds": 60,
                "stacks": {"main;a;hot": {"samples": 4},
                           "main;b": {"samples": 12},
                           "main;gone": {"samples": 4}},
                "by_phase": {"decode": {"samples": 8},
                             "idle": {"samples": 12}}}
        d = diff_profiles(cur, base)
        assert d == jax_profiling.diff_profiles(cur, base)
        assert d["stacks"][0]["stack"] == "main;a;hot"
        assert abs(d["stacks"][0]["delta"] - 0.6) < 1e-6
        ph = {r["phase"]: r["delta"] for r in d["by_phase"]}
        assert ph["decode"] > 0 and ph["idle"] < 0


def _drive_sampler(pkg):
    """One sequence of phases, ambient spans, a capture window and the
    windowed queries, on a manual clock; returns what a caller reads
    (stacks apart: their frames name the package's files)."""
    clock = _ManualClock()
    tracer = pkg.tracing.Tracer(clock=clock)
    s = _sampler(clock, pkg, interval_s=0.1, capture_interval_s=0.01,
                 tracer=tracer)
    with pkg.profiling.phase("admission"):
        clock.advance(0.1)
        s.sample_once()
    span = tracer.start_trace("chunk[0]")
    with pkg.tracing.activate(span):
        clock.advance(0.1)
        s.sample_once()
    s.trigger_capture("manual", detail="test", context=span.context(),
                      window_s=0.05)
    assert not s.trigger_capture("manual")          # one window at a time
    with pkg.profiling.phase("decode"):
        for _ in range(4):
            clock.advance(0.02)
            s.sample_once()
    span.end()
    clock.advance(0.1)
    s.sample_once()
    prof = s.profile()
    cap = s.last_capture()
    return {
        "by_phase": prof["by_phase"],
        "samples": prof["samples"],
        "sampled_seconds": round(prof["sampled_seconds"], 12),
        "window": s.profile(window_seconds=0.15)["by_phase"],
        "capture": {k: cap[k] for k in ("trigger", "detail", "samples",
                                        "by_phase", "start_s", "end_s")},
        "capture_linked": cap["trace_id"] == span.trace_id,
        "stats": {k: v for k, v in s.stats().items()
                  if k in ("lifetime_samples", "buffered_samples",
                           "captures", "captures_suppressed")},
        "series": sorted(s.registry.snapshot()),
    }


def test_sampler_records_as_jax():
    assert _drive_sampler(PKGS["port"]) == _drive_sampler(PKGS["jax"])
    assert port_profiling.PROFILING_SERIES == jax_profiling.PROFILING_SERIES


# ------------------------------------------------------------- profiler


class TestScheduler:
    def test_states_on_right_steps(self):
        s = make_scheduler(wait=1, warmup=2, active=3, repeat=0)
        want = [ProfilerState.CLOSED, ProfilerState.READY,
                ProfilerState.READY, ProfilerState.RECORD,
                ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN]
        assert [s(i) for i in range(6)] == want
        assert [s(i) for i in range(6, 12)] == want     # cycles

    def test_repeat_and_skip_first(self):
        s = make_scheduler(closed=0, ready=0, record=2, repeat=1,
                           skip_first=2)
        assert [s(i) for i in range(6)] == [
            ProfilerState.CLOSED, ProfilerState.CLOSED,
            ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN,
            ProfilerState.CLOSED, ProfilerState.CLOSED]

    def test_record_required(self):
        with pytest.raises(ValueError):
            make_scheduler(wait=1, warmup=1, active=0)

    def test_profiler_records_only_active_window(self):
        fired = []
        p = Profiler(scheduler=(1, 1, 2, 1), with_device=False,
                     on_trace_ready=lambda pr: fired.append(pr.step_num))
        p.start()
        for i in range(6):
            with RecordEvent(f"step{i}"):
                pass
            p.step()
        p.stop()
        names = {ev[1] for ev in p._events if ev[0] == "X"}
        assert names == {"step2", "step3"}   # active steps only
        assert fired[0] == 3                 # window closed after step 3

    def test_step_without_scheduler_marks_instants(self):
        p = Profiler(with_device=False)
        p.start()
        for _ in range(3):
            p.step()
        p.stop()
        instants = [ev for ev in p._events if ev[0] == "i"]
        assert len(instants) == 4            # start + 3 steps

    def test_cpu_target_runs_no_device_trace(self):
        p = Profiler(targets=[ProfilerTarget.CPU])
        assert not p.with_device
        with p:
            with RecordEvent("host_only"):
                pass
        assert p.device_profile is None
        assert "host_only" in p.summary()


class TestChromeExport:
    def test_instants_counters_and_track_metadata(self, tmp_path):
        default_registry().gauge("test_occupancy").set(0.75)
        p = Profiler(with_device=False)
        p.start()
        with RecordEvent("span_a"):
            pass
        p.step()
        p.stop()
        out = tmp_path / "trace.json"
        p.export(str(out))
        evs = json.loads(out.read_text())["traceEvents"]
        by_ph = {}
        for e in evs:
            by_ph.setdefault(e["ph"], []).append(e)
        assert any(e["name"] == "span_a" for e in by_ph["X"])
        assert any(e["name"].startswith("ProfilerStep#")
                   for e in by_ph["i"])
        counters = [e for e in by_ph["C"]
                    if e["name"] == "test_occupancy"]
        assert counters and counters[-1]["args"]["test_occupancy"] == 0.75
        meta_names = {e["name"] for e in by_ph["M"]}
        assert {"process_name", "thread_name"} <= meta_names

    def test_record_event_decorator(self):
        @RecordEvent("decorated")
        def work(a, b=1):
            return a + b

        p = Profiler(with_device=False)
        p.start()
        assert work(1, b=2) == 3
        p.stop()
        assert "decorated" in p.summary()

    def test_record_event_opens_a_torch_profiler_range(self):
        """The step's name reaches torch.profiler's trace, where it
        labels the kernels it launched on a device trace."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with RecordEvent("serving::unified_step"):
                torch.ones(4).sum()
        names = {e.key for e in prof.key_averages()}
        assert "serving::unified_step" in names


def _drive_profiler(pkg, tmp_path):
    """A scheduled session (wait 1, warmup 1, active 2, twice) with spans,
    nested spans and the decorator, then its chrome export; returns the
    events' kinds and names in order, the windows handed over, the
    summary's rows, and the export's event kinds."""
    prof_mod = pkg.profiler
    fired = []

    @prof_mod.RecordEvent("decorated")
    def work():
        with prof_mod.RecordEvent("inner"):
            return 1

    p = prof_mod.Profiler(scheduler=(1, 1, 2, 2), with_device=False,
                          emit_counters=False,
                          on_trace_ready=lambda pr: fired.append(
                              (pr.step_num, pr.current_state)))
    p.start()
    for i in range(10):
        with prof_mod.RecordEvent(f"step{i % 3}"):
            work()
        p.step()
    p.stop()
    out = tmp_path / f"{id(pkg)}.json"
    p.export(str(out))
    evs = json.loads(out.read_text())["traceEvents"]
    rows = sorted((line.split()[0], line.split()[1])
                  for line in p.summary().splitlines()[1:])
    return {"events": [(e[0], e[1]) for e in p._events],
            "fired": fired,
            "summary": rows,
            "chrome": sorted((e["ph"], e["name"]) for e in evs
                             if e["ph"] != "M")}


def test_profiler_records_as_jax(tmp_path):
    assert _drive_profiler(PKGS["port"], tmp_path) == \
        _drive_profiler(PKGS["jax"], tmp_path)


# ---------------------------------------------------------------- timer


class _FakeTime:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


class TestBenchmarkWarmupBoundary:
    def test_reader_and_batch_skip_the_same_steps(self, monkeypatch):
        clk = _FakeTime()
        monkeypatch.setattr(port_timer, "time", clk)
        bm = Benchmark(warmup_steps=1)
        for _ in range(3):
            bm.before_reader()
            clk.t += 0.5                     # reader: 0.5s/step
            bm.after_reader()
            bm.step_start()
            clk.t += 1.0                     # batch: 1.0s/step
            bm.step_end(num_samples=2)
        info = bm.step_info()
        assert info["steps"] == 2            # 3 steps - 1 warmup
        assert info["avg_batch_cost"] == pytest.approx(1.0)
        assert info["reader_cost"] == pytest.approx(0.5)
        assert info["ips"] == pytest.approx(4 / 2.0)

    def test_dangling_reader_fetch_not_counted(self, monkeypatch):
        clk = _FakeTime()
        monkeypatch.setattr(port_timer, "time", clk)
        bm = Benchmark(warmup_steps=0)
        bm.before_reader()
        clk.t += 0.2
        bm.after_reader()
        bm.step_start()
        clk.t += 1.0
        bm.step_end()
        bm.before_reader()
        clk.t += 99.0                        # fetched, then loop breaks
        bm.after_reader()
        assert bm.step_info()["reader_cost"] == pytest.approx(0.2)


def _drive_timer(pkg, monkeypatch):
    clk = _FakeTime()
    monkeypatch.setattr(pkg.timer, "time", clk)
    bm = pkg.timer.Benchmark(warmup_steps=2)
    for i in range(7):
        bm.before_reader()
        clk.t += 0.125 * (i + 1)
        bm.after_reader()
        bm.step_start()
        clk.t += 0.5 + 0.25 * (i % 3)
        bm.step_end(num_samples=4 + i)
    bm.before_reader()
    clk.t += 3.0
    bm.after_reader()
    pending = bm.take_pending_reader_cost()
    return bm.step_info(unit="tokens"), pending, bm.ips


def test_benchmark_as_jax(monkeypatch):
    assert _drive_timer(PKGS["port"], monkeypatch) == \
        _drive_timer(PKGS["jax"], monkeypatch)
