"""Host tracer + device profiler bridge (the port of
``paddle_tpu/profiler/profiler.py``).

Parity: platform/profiler/profiler.h:43 ``Profiler`` (HostTracer + CudaTracer
→ NodeTrees → ChromeTracingLogger) and python/paddle/profiler/profiler.py:270.

Host events are recorded in a ring buffer (HostEventRecorder analog);
device-side activity is captured by ``torch.profiler`` (CUPTI) where the
JAX package uses ``jax.profiler``: between ``start()`` and ``stop()`` a
profiler with the CPU and CUDA activities runs, and
:attr:`Profiler.device_profile` hands it over (``key_averages()``,
``export_chrome_trace``).  Every :class:`RecordEvent` also opens a
``torch.profiler.record_function`` range of its name, so a host span
(``serving::unified_step``) labels the kernels it launched on the device
trace.  ``export_chrome_tracing`` writes the host events in chrome-trace
JSON.

Step-aware profiling (reference ``make_scheduler``,
python/paddle/profiler/profiler.py:115): ``Profiler.step()`` marks batch
boundaries.  With a scheduler — ``make_scheduler(closed=, ready=,
record=, repeat=)`` or the torch-style aliases ``wait/warmup/active`` —
recording windows open and close on exact step numbers: CLOSED drops
events, READY runs the tracer but discards (tracer warmup), RECORD
keeps, and the last step of each window (RECORD_AND_RETURN) drains the
span and fires ``on_trace_ready``.  Every recorded step also emits a
step-boundary instant event and one chrome counter event (``"ph": "C"``)
per gauge in the default MetricsRegistry, so host spans, step marks and
e.g. page-pool occupancy land in one Perfetto timeline.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time

import torch
from torch.profiler import record_function

__all__ = ["Profiler", "ProfilerState", "RecordEvent",
           "export_chrome_tracing", "make_scheduler", "ProfilerTarget"]


class ProfilerTarget:
    CPU = "cpu"
    GPU = "gpu"


class ProfilerState:
    """Scheduler verdict for one step (reference ProfilerState enum)."""

    CLOSED = "closed"
    READY = "ready"
    RECORD = "record"
    RECORD_AND_RETURN = "record_and_return"   # last step of a window


def make_scheduler(*, closed=None, ready=None, record=None, repeat=0,
                   skip_first=0, wait=None, warmup=None, active=None):
    """Step-number → ProfilerState policy (reference
    python/paddle/profiler/profiler.py:115 ``make_scheduler``; the
    torch-style ``wait``/``warmup``/``active`` names are aliases for
    ``closed``/``ready``/``record``).

    After ``skip_first`` steps the cycle ``closed + ready + record``
    repeats ``repeat`` times (0 = forever): CLOSED steps drop events,
    READY steps run the tracer but their events are discarded (warmup),
    RECORD steps keep events, and the final RECORD step of each cycle is
    RECORD_AND_RETURN — the Profiler drains the window and fires
    ``on_trace_ready`` there."""
    closed = wait if closed is None else closed
    ready = warmup if ready is None else ready
    record = active if record is None else record
    closed, ready = int(closed or 0), int(ready or 0)
    if record is None or int(record) <= 0:
        raise ValueError("make_scheduler: record/active must be >= 1")
    record = int(record)
    cycle = closed + ready + record

    def scheduler(step):
        if step < skip_first:
            return ProfilerState.CLOSED
        step = step - skip_first
        if repeat and step >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = step % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


class _HostEventRecorder:
    """Ring of typed events: ("X", name, start_ns, end_ns, tid) spans,
    ("i", name, ts_ns, tid) instants, ("C", name, ts_ns, value) counter
    samples."""

    def __init__(self):
        self.events = []        # guarded-by: self.lock
        self.lock = threading.Lock()
        # lock-free sticky flag: record paths read it unlocked by
        # design (a stale read costs one dropped/extra event, never a
        # torn structure)
        self.enabled = False

    def record(self, name, start_ns, end_ns, tid):
        if not self.enabled:
            return
        with self.lock:
            self.events.append(("X", name, start_ns, end_ns, tid))

    def record_instant(self, name, ts_ns, tid):
        if not self.enabled:
            return
        with self.lock:
            self.events.append(("i", name, ts_ns, tid))

    def record_counter(self, name, ts_ns, value):
        if not self.enabled:
            return
        with self.lock:
            self.events.append(("C", name, ts_ns, float(value)))

    def drain(self):
        with self.lock:
            out, self.events = self.events, []
        return out


_recorder = _HostEventRecorder()


class RecordEvent:
    """Scoped host event (parity: platform::RecordEvent, event_tracing.h)
    that is also a ``torch.profiler.record_function`` range.

    Context manager, begin()/end() pair, or decorator::

        @RecordEvent("my_op")
        def my_op(...): ...
    """

    def __init__(self, name, event_type="UserDefined"):
        self.name = name
        self._start = None
        self._range = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def __call__(self, fn):
        # decorator form: a FRESH scope per invocation (self carries
        # per-entry state, so reusing it would break reentrancy)
        name = self.name

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with RecordEvent(name):
                return fn(*args, **kwargs)

        return wrapper

    def begin(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        self._start = time.perf_counter_ns()

    def end(self):
        if self._start is None:
            return
        _recorder.record(self.name, self._start, time.perf_counter_ns(),
                         threading.get_ident())
        self._start = None
        self._range.__exit__(None, None, None)
        self._range = None


class Profiler:
    """``scheduler`` may be None (record everything between start/stop),
    a callable step→ProfilerState, or a ``(wait, warmup, active, repeat)``
    tuple passed through :func:`make_scheduler`.  ``emit_counters``
    samples every gauge of the default MetricsRegistry into the trace at
    each recorded ``step()``.  The device trace runs from ``start()`` to
    ``stop()`` when ``ProfilerTarget.GPU`` is a target, ``with_device``
    is set and CUDA is available; the host events follow the
    scheduler."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, with_device=True, emit_counters=True):
        self.targets = targets or [ProfilerTarget.CPU, ProfilerTarget.GPU]
        self.on_trace_ready = on_trace_ready
        self.with_device = with_device and ProfilerTarget.GPU in self.targets
        self.emit_counters = emit_counters
        if isinstance(scheduler, (tuple, list)):
            wait, warmup, active = scheduler[:3]
            repeat = scheduler[3] if len(scheduler) > 3 else 0
            scheduler = make_scheduler(wait=wait, warmup=warmup,
                                       active=active, repeat=repeat)
        self.scheduler = scheduler
        self._device = None
        self._device_dir = None
        self._events = []
        self._step_num = 0
        self._state = ProfilerState.CLOSED

    # ---- lifecycle ------------------------------------------------------
    def start(self):
        self._events = []
        self._step_num = 0
        _recorder.drain()
        self._state = (self.scheduler(0) if self.scheduler
                       else ProfilerState.RECORD)
        _recorder.enabled = self._state != ProfilerState.CLOSED
        if _recorder.enabled:
            self._mark_step()
        self._device = self._device_dir = None
        if self.with_device and torch.cuda.is_available():
            from torch.profiler import ProfilerActivity, profile

            self._device = profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
            self._device.__enter__()

    def stop(self):
        pending = _recorder.drain()
        if self._state in (ProfilerState.RECORD,
                           ProfilerState.RECORD_AND_RETURN):
            self._events.extend(pending)
        _recorder.enabled = False
        self._state = ProfilerState.CLOSED
        if self._device is not None:
            torch.cuda.synchronize()
            self._device.__exit__(None, None, None)
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # ---- step machine ---------------------------------------------------
    def _mark_step(self):
        now = time.perf_counter_ns()
        _recorder.record_instant(f"ProfilerStep#{self._step_num}", now,
                                 threading.get_ident())
        if self.emit_counters:
            from ..observability.metrics import default_registry

            for name, value in default_registry().gauges():
                _recorder.record_counter(name, now, value)

    def step(self):
        """Mark a step boundary and advance the scheduler.

        Without a scheduler this records the step instant + gauge counter
        samples (always-recording session).  With one, it drives the
        CLOSED→READY→RECORD window machine; leaving a window (the
        RECORD_AND_RETURN step) drains the span into the profiler and
        fires ``on_trace_ready``."""
        if self.scheduler is None:
            self._step_num += 1
            if _recorder.enabled:
                self._mark_step()
            return

        prev = self._state
        if prev == ProfilerState.RECORD_AND_RETURN:
            # window complete: keep its events, hand the trace over
            self._events.extend(_recorder.drain())
            if self.on_trace_ready is not None:
                self.on_trace_ready(self)
        self._step_num += 1
        state = self.scheduler(self._step_num)
        if prev == ProfilerState.READY and state in (
                ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            _recorder.drain()                 # discard tracer warmup
        if prev in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN) \
                and state in (ProfilerState.CLOSED, ProfilerState.READY):
            self._events.extend(_recorder.drain())
        self._state = state
        _recorder.enabled = state != ProfilerState.CLOSED
        if state in (ProfilerState.RECORD,
                     ProfilerState.RECORD_AND_RETURN):
            self._mark_step()

    @property
    def current_state(self):
        return self._state

    @property
    def step_num(self):
        return self._step_num

    # ---- output ---------------------------------------------------------
    def export(self, path, format="json"):  # noqa: A002
        export_events_chrome(self._events, path)

    def summary(self, sorted_by="total", detail=True):
        agg = {}
        for ev in self._events:
            if ev[0] != "X":
                continue
            _, name, s, e, _tid = ev
            tot, cnt = agg.get(name, (0, 0))
            agg[name] = (tot + (e - s), cnt + 1)
        rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
        lines = [f"{'Name':<40} {'Calls':>8} {'Total(ms)':>12} {'Avg(us)':>10}"]
        for name, (tot, cnt) in rows:
            lines.append(f"{name:<40} {cnt:>8} {tot/1e6:>12.3f} {tot/1e3/max(cnt,1):>10.1f}")
        return "\n".join(lines)

    @property
    def device_trace_dir(self):
        """A directory holding the last session's device trace as
        chrome-trace JSON (``device_trace.json``), written on first
        access; None without a device trace (the JAX package's
        ``jax.profiler`` trace directory)."""
        if self._device is None:
            return None
        if self._device_dir is None:
            import tempfile

            self._device_dir = tempfile.mkdtemp(prefix="pt_prof_")
            self._device.export_chrome_trace(
                os.path.join(self._device_dir, "device_trace.json"))
        return self._device_dir

    @property
    def device_profile(self):
        """The ``torch.profiler.profile`` of the last session's device
        trace (None without one): ``key_averages()`` for the kernels'
        device time, ``export_chrome_trace(path)`` for the timeline."""
        return self._device


def export_events_chrome(events, path, thread_names=None):
    """Chrome-trace JSON: "X" spans, "i" step instants, "C" counter
    tracks, plus process_name/thread_name metadata ("M") so Perfetto
    labels the tracks instead of showing raw pids/tids.

    ``thread_names`` ({tid: label}) overrides the default "host thread
    N" track labels — the tracing flight recorder uses one track per
    request (tid = trace id) labelled "request#N"."""
    pid = os.getpid()
    thread_names = thread_names or {}
    trace = {"traceEvents": [{
        "name": "process_name", "ph": "M", "pid": pid,
        "args": {"name": f"paddle_tpu_torch host (pid {pid})"},
    }]}
    tids = set()
    for ev in events:
        kind = ev[0]
        if kind == "X":
            _, name, start_ns, end_ns, tid = ev
            tids.add(tid)
            trace["traceEvents"].append({
                "name": name, "ph": "X", "ts": start_ns / 1000.0,
                "dur": (end_ns - start_ns) / 1000.0, "pid": pid, "tid": tid,
                "cat": "host",
            })
        elif kind == "i":
            _, name, ts_ns, tid = ev
            tids.add(tid)
            trace["traceEvents"].append({
                "name": name, "ph": "i", "ts": ts_ns / 1000.0, "pid": pid,
                "tid": tid, "s": "p", "cat": "step",
            })
        elif kind == "C":
            _, name, ts_ns, value = ev
            trace["traceEvents"].append({
                "name": name, "ph": "C", "ts": ts_ns / 1000.0, "pid": pid,
                "args": {name: value}, "cat": "metrics",
            })
    for tid in sorted(tids):
        trace["traceEvents"].append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": thread_names.get(tid,
                                              f"host thread {tid}")},
        })
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    # lint-ok: atomic-writes a chrome-trace export is a re-recordable log
    # artifact, not durable state: a torn trace is cosmetic
    with open(path, "w") as f:
        json.dump(trace, f)


def export_chrome_tracing(dir_name, worker_name=None):
    """Returns an on_trace_ready callback (parity:
    python/paddle/profiler/profiler.py:158)."""

    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{os.getpid()}"
        prof.export(os.path.join(dir_name, f"{name}.json"))

    return handler
