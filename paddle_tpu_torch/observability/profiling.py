"""Continuous sampling profiler (the port of
``paddle_tpu/observability/profiling.py``; host-only Python, carried
over unchanged but for this docstring).

Metrics say *how slow*, traces say *which request*; neither says
**where the host's time went**.  This module keeps a low-rate stack
sampler and answers exactly that:

- :class:`StackSampler` walks ``sys._current_frames()`` on an injectable
  clock (default 10 Hz), collapses each thread's stack into flamegraph
  form (``thread;outer;...;leaf``) and aggregates samples in a
  fixed-budget store with windowed retention: bounded memory, windowed
  queries, nothing on import.
- every sample is tagged with the sampled thread's **phase** — an
  explicit :func:`phase` marker (the serving engine marks ``admission``
  / ``prefill_chunk`` / ``decode``) or, absent a marker, the thread's
  ambient tracer span — so CPU can be sliced by what the process was
  doing, not just where the PC was.  Unattributed samples read
  ``idle``; a window's phase slices always sum to its sampled wall time.
- :meth:`StackSampler.trigger_capture` escalates to a **high-rate
  capture window** (default 100 Hz for 2 s) when an anomaly fires and
  links the capture to the triggering trace: the finished capture is
  emitted as a ``profiling::capture`` span *continuing* the anomaly's
  trace (``retain=True``), and the capture record itself is kept in a
  bounded ring.
- :meth:`StackSampler.profile` / :meth:`flamegraph` answer windowed
  queries (JSON or collapsed-stack text); :func:`diff_profiles` /
  :meth:`StackSampler.diff` subtract two windows, normalized to
  per-window fractions, to localize a regression ("what grew since the
  last quiet minute").  The telemetry server's ``/profilez`` endpoint
  (:mod:`.exporter`) serves them over HTTP.

Threading: the sampler thread is strictly opt-in (:meth:`start`);
:meth:`sample_once` is the inline driver for tests.  All shared state is
guarded by one lock; the cross-thread phase and span registries are
plain dicts mutated only with GIL-atomic operations.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import deque

from .metrics import default_registry
from .tracing import TraceContext, active_span_for_thread

__all__ = ["StackSampler", "phase", "current_phase", "diff_profiles",
           "PROFILING_SERIES"]

#: every metric series this module emits
PROFILING_SERIES = (
    "profiling_samples_total",
    "profiling_sample_seconds",
    "profiling_captures_total",
    "profiling_captures_suppressed_total",
    "profiling_capture_active",
    "profiling_overhead_ratio",
)

# ---- phase markers -------------------------------------------------------
# tid -> [phase, ...] innermost-last.  Mutated only by the owning thread
# with GIL-atomic dict/list ops and read cross-thread by the sampler
# (same design as the tracer's ambient-span registry): a torn read can
# at worst misattribute one sample, never corrupt state.
_PHASES = {}


@contextlib.contextmanager
def phase(name):
    """Mark the calling thread as spending the block in ``name``.

    Nesting is innermost-wins; the marker costs two dict ops, so it is
    cheap enough for per-step hot paths.  Sampler threads read it
    cross-thread to attribute samples."""
    tid = threading.get_ident()
    stack = _PHASES.get(tid)
    if stack is None:
        stack = _PHASES[tid] = []
    stack.append(str(name))
    try:
        yield
    finally:
        stack.pop()
        if not stack:
            _PHASES.pop(tid, None)


def current_phase(tid=None):
    """The innermost :func:`phase` marker on a thread (default: the
    calling thread), or None outside any marker."""
    stack = _PHASES.get(tid if tid is not None else threading.get_ident())
    if not stack:
        return None
    try:
        return stack[-1]
    except IndexError:      # raced the owning thread's pop
        return None


#: span-name prefixes mapped to canonical phase labels — the fallback
#: attribution when a thread has an ambient span but no phase marker
_SPAN_PHASES = {"chunk": "prefill_chunk", "prefill": "prefill_chunk",
                "decode": "decode", "queued": "admission",
                "admit": "admission"}


def _span_phase(name):
    base = str(name).split("::")[0].split("[")[0].split("#")[0]
    return _SPAN_PHASES.get(base, base or "idle")


def _as_context(context):
    """Normalize a trigger's trace linkage: a TraceContext, a Span, a
    ``to_dict()`` form, or a bare trace_id string all work."""
    if context is None:
        return None
    if isinstance(context, TraceContext):
        return context
    if isinstance(context, dict):
        return TraceContext.from_dict(context)
    if isinstance(context, str):
        return TraceContext(context)
    ctx = getattr(context, "context", None)
    if callable(ctx):
        return ctx()        # a Span (a disabled tracer's span yields None)
    return None


class StackSampler:
    """Always-on sampling profiler with anomaly-triggered escalation.

    ``interval_s`` is the steady-state sampling period (10 Hz default);
    ``capture_interval_s``/``capture_window_s`` shape the high-rate
    window :meth:`trigger_capture` arms.  ``retention_s`` and
    ``max_samples`` bound the sample store (oldest evicted first),
    ``max_stacks`` bounds the interned collapsed-stack table (overflow
    collapses to one sentinel stack rather than growing), and
    ``max_captures`` bounds the finished-capture ring.  ``registry``
    receives the ``profiling_*`` metrics, ``tracer`` the
    ``profiling::capture`` spans, ``clock`` stamps samples (default
    ``time.perf_counter`` — the tracer's timebase, so captures and spans
    line up).  Construction starts nothing; :meth:`start` is opt-in and
    :meth:`sample_once` drives the sampler inline for tests.
    """

    thread_name = "stack-sampler"

    def __init__(self, *, interval_s=0.1, capture_interval_s=0.01,
                 capture_window_s=2.0, retention_s=300.0,
                 max_samples=50_000, max_stacks=2048, max_captures=16,
                 max_depth=48, registry=None, tracer=None, clock=None):
        self.interval_s = float(interval_s)
        self.capture_interval_s = float(capture_interval_s)
        self.capture_window_s = float(capture_window_s)
        self.retention_s = float(retention_s)
        self.max_samples = int(max_samples)
        self.max_stacks = int(max_stacks)
        self.max_captures = int(max_captures)
        self.max_depth = int(max_depth)
        self.registry = registry or default_registry()
        self.tracer = tracer
        self._clock = clock or time.perf_counter
        # sample_once() (sampler thread or inline driver) mutates,
        # profile()/stats()/trigger_capture() (exporter scrape thread,
        # anomaly paths) read — one lock guards all mutable state.  The
        # sampler never calls back into its triggers, so the watchdog/
        # engine/slo locks order strictly before this one.
        self._lock = threading.Lock()
        # (t, phase, stack_id, trace_id, weight_s) oldest-first
        self._samples = deque()     # guarded-by: self._lock
        self._stack_ids = {}        # key -> id; guarded-by: self._lock
        self._stack_keys = []       # id -> key; guarded-by: self._lock
        self._capture = None        # active capture; guarded-by: self._lock
        self._captures = deque(maxlen=self.max_captures)  # guarded-by: self._lock
        self._n_samples = 0         # lifetime; guarded-by: self._lock
        self._suppressed = 0        # guarded-by: self._lock
        self._cost_ewma = None      # smoothed walk cost; guarded-by: self._lock
        self._m_samples = self.registry.counter(
            "profiling_samples_total",
            "stack samples recorded (one per thread per walk)")
        self._m_sample_cost = self.registry.histogram(
            "profiling_sample_seconds",
            "wall cost of one sampling walk across all threads")
        self._m_captures = self.registry.counter(
            "profiling_captures_total",
            "anomaly-triggered capture windows armed, by trigger",
            labelnames=("trigger",))
        self._m_suppressed = self.registry.counter(
            "profiling_captures_suppressed_total",
            "capture triggers ignored because a window was already open")
        self._m_active = self.registry.gauge(
            "profiling_capture_active",
            "1 while a high-rate capture window is open")
        self._m_overhead = self.registry.gauge(
            "profiling_overhead_ratio",
            "smoothed walk cost over the steady-state interval — the "
            "live estimate of the <1% sampling overhead bound")
        self._thread = None
        self._stop = threading.Event()

    # ---- sampling --------------------------------------------------------
    def sample_once(self, _skip_tid=None):
        """One sampling walk: snapshot every thread's stack, attribute
        each to a phase + ambient trace, ingest under the lock, and
        close an expired capture window.  Returns the number of thread
        samples recorded.  ``_skip_tid`` excludes the sampler's own
        thread so the profiler never profiles itself."""
        now = self._clock()
        t0 = time.perf_counter()
        names = {t.ident: t.name for t in threading.enumerate()}
        rows = []
        for tid, frame in sys._current_frames().items():
            if tid == _skip_tid:
                continue
            key = self._collapse(names.get(tid, f"thread-{tid}"), frame)
            ph = current_phase(tid)
            span = active_span_for_thread(tid)
            trace_id = getattr(span, "trace_id", None)
            if ph is None:
                ph = _span_phase(span.name) if span is not None \
                    and span.name else "idle"
            rows.append((ph, key, trace_id))
        cost = time.perf_counter() - t0
        with self._lock:
            finished = self._ingest_locked(now, rows, cost)
        if finished is not None:
            self._emit_capture_span(finished)
            with self._lock:
                self._captures.append(finished)
        return len(rows)

    def _collapse(self, thread_name, frame):
        parts = []
        f, depth = frame, 0
        while f is not None and depth < self.max_depth:
            code = f.f_code
            fname = code.co_filename.rsplit("/", 1)[-1]
            if fname.endswith(".py"):
                fname = fname[:-3]
            parts.append(f"{fname}.{code.co_name}")
            f = f.f_back
            depth += 1
        parts.append(thread_name)
        parts.reverse()     # root first, leaf last — flamegraph order
        return ";".join(parts)

    def _ingest_locked(self, now, rows, cost):
        """Record one walk's rows; returns a finished capture record if
        this walk closed the window (caller emits its span outside the
        lock), else None."""
        finished = None
        cap = self._capture
        if cap is not None and now >= cap["until_s"]:
            finished = self._finish_capture_locked(now)
            cap = None
        # each thread sample accounts for the period it stands in for
        weight = self.capture_interval_s if cap is not None \
            else self.interval_s
        for ph, key, trace_id in rows:
            sid = self._intern_locked(key)
            self._samples.append((now, ph, sid, trace_id, weight))
            self._n_samples += 1
            if cap is not None:
                cap["samples"] += 1
                cap["stacks"][key] = cap["stacks"].get(key, 0) + 1
                cap["by_phase"][ph] = cap["by_phase"].get(ph, 0) + 1
        cutoff = now - self.retention_s
        while self._samples and (self._samples[0][0] < cutoff
                                 or len(self._samples) > self.max_samples):
            self._samples.popleft()
        self._cost_ewma = cost if self._cost_ewma is None \
            else 0.9 * self._cost_ewma + 0.1 * cost
        self._m_samples.inc(len(rows))
        self._m_sample_cost.observe(cost)
        self._m_overhead.set(self._cost_ewma / self.interval_s)
        return finished

    def _intern_locked(self, key):
        sid = self._stack_ids.get(key)
        if sid is not None:
            return sid
        if len(self._stack_keys) >= self.max_stacks:
            key = "(stack-table-full)"
            sid = self._stack_ids.get(key)
            if sid is not None:
                return sid
        sid = len(self._stack_keys)
        self._stack_ids[key] = sid
        self._stack_keys.append(key)
        return sid

    # ---- anomaly-triggered capture ---------------------------------------
    def trigger_capture(self, trigger, detail=None, context=None,
                        window_s=None):
        """Arm a high-rate capture window now.

        ``trigger`` is the coarse cause (``slo_page`` / ``health`` /
        ``hang`` / ``manual`` — the metric label), ``detail`` the
        specific one (objective name, anomaly kind).  ``context`` links
        the capture to the triggering trace (a Span, TraceContext, dict
        or trace_id) — the finished capture's ``profiling::capture``
        span continues that trace.  Returns True if armed; a trigger
        while a window is already open is counted and ignored (the
        first anomaly wins — overlapping escalations would just re-
        capture the same stacks)."""
        ctx = _as_context(context)
        now = self._clock()
        with self._lock:
            if self._capture is not None:
                self._suppressed += 1
                self._m_suppressed.inc()
                return False
            self._capture = {
                "trigger": str(trigger), "detail": detail,
                "context": ctx,
                "trace_id": ctx.trace_id if ctx is not None else None,
                "start_s": now,
                "until_s": now + float(window_s if window_s is not None
                                       else self.capture_window_s),
                "interval_seconds": self.capture_interval_s,
                "samples": 0, "stacks": {}, "by_phase": {},
            }
            self._m_captures.labels(trigger=str(trigger)).inc()
            self._m_active.set(1.0)
        return True

    def _finish_capture_locked(self, now):
        cap, self._capture = self._capture, None
        cap["end_s"] = now
        self._m_active.set(0.0)
        return cap

    def _emit_capture_span(self, cap):
        """One ``profiling::capture`` span per finished window,
        continuing the trigger's trace so the capture and the firing
        ``slo::``/``health::``/``flight::hang`` span share a trace_id;
        ``retain=True`` pins it in the tail-retained ring."""
        ctx = cap.pop("context", None)
        hot = sorted(cap["stacks"].items(), key=lambda kv: -kv[1])[:5]
        cap["hot"] = [k for k, _ in hot]
        if self.tracer is None:
            return
        span = self.tracer.start_trace(
            "profiling::capture", start_s=cap["start_s"], context=ctx,
            attributes={"retain": True, "trigger": cap["trigger"],
                        "detail": cap["detail"],
                        "samples": cap["samples"], "hot": cap["hot"]})
        span.end(cap["end_s"])
        if cap["trace_id"] is None:
            cap["trace_id"] = span.trace_id
        cap["span_id"] = span.span_id

    # ---- windowed queries ------------------------------------------------
    def _select_locked(self, end_s, window_seconds):
        lo = None if window_seconds is None else end_s - window_seconds
        out = []
        for row in self._samples:
            t = row[0]
            if t > end_s:
                break
            if lo is None or t > lo:
                out.append(row)
        return out

    def profile(self, window_seconds=None, phase=None, end_s=None):
        """The profile's JSON payload over the trailing window
        (whole retained history when ``window_seconds`` is None):
        collapsed stacks with sample counts and attributed seconds,
        per-phase slices that sum exactly to the sampled wall time,
        finished-capture summaries, and sampler self-stats.  ``phase``
        restricts the stack aggregation to one slice; ``end_s`` anchors
        the window for offset (diff baseline) queries."""
        now = self._clock() if end_s is None else float(end_s)
        with self._lock:
            rows = self._select_locked(now, window_seconds)
            stacks, by_phase = {}, {}
            total_w = 0.0
            for t, ph, sid, trace_id, w in rows:
                slot = by_phase.setdefault(ph,
                                           {"samples": 0, "seconds": 0.0})
                slot["samples"] += 1
                slot["seconds"] += w
                total_w += w
                if phase is not None and ph != phase:
                    continue
                key = self._stack_keys[sid]
                s = stacks.setdefault(key, {"samples": 0, "seconds": 0.0})
                s["samples"] += 1
                s["seconds"] += w
            captures = [self._capture_summary(c) for c in self._captures]
            return {
                "time": now,
                "window_seconds": window_seconds,
                "interval_seconds": self.interval_s,
                "capture_interval_seconds": self.capture_interval_s,
                "phase": phase,
                "samples": len(rows),
                "sampled_seconds": total_w,
                "by_phase": dict(sorted(by_phase.items())),
                "stacks": dict(sorted(stacks.items(),
                                      key=lambda kv: -kv[1]["samples"])),
                "captures": captures,
                "capture_active": self._capture is not None,
                "stats": self._stats_locked(),
            }

    @staticmethod
    def _capture_summary(cap):
        top = sorted(cap["stacks"].items(), key=lambda kv: -kv[1])[:20]
        return {k: cap.get(k) for k in
                ("trigger", "detail", "trace_id", "span_id", "start_s",
                 "end_s", "interval_seconds", "samples", "by_phase",
                 "hot")} | {"stacks": dict(top)}

    def flamegraph(self, window_seconds=None, phase=None):
        """Collapsed-stack text (``stack count`` per line, hottest
        first) — pipe straight into ``flamegraph.pl`` or speedscope."""
        prof = self.profile(window_seconds=window_seconds, phase=phase)
        lines = [f"{key} {agg['samples']}"
                 for key, agg in prof["stacks"].items()]
        return "\n".join(lines) + ("\n" if lines else "")

    def diff(self, window_seconds, baseline_window_seconds=None,
             end_s=None):
        """Subtract the window immediately preceding the trailing one:
        ``diff(60)`` compares the last minute against the minute before
        it.  See :func:`diff_profiles` for the payload shape."""
        now = self._clock() if end_s is None else float(end_s)
        bw = baseline_window_seconds if baseline_window_seconds \
            is not None else window_seconds
        cur = self.profile(window_seconds=window_seconds, end_s=now)
        base = self.profile(window_seconds=bw,
                            end_s=now - float(window_seconds))
        return diff_profiles(cur, base)

    def last_capture(self):
        """The newest finished capture record (None before any)."""
        with self._lock:
            return dict(self._captures[-1]) if self._captures else None

    def captures(self):
        """All retained finished-capture records, oldest first."""
        with self._lock:
            return [dict(c) for c in self._captures]

    def _stats_locked(self):
        return {
            "lifetime_samples": self._n_samples,
            "buffered_samples": len(self._samples),
            "stacks_interned": len(self._stack_keys),
            "captures": len(self._captures),
            "captures_suppressed": self._suppressed,
            "sample_cost_seconds": self._cost_ewma,
            "overhead_ratio": (None if self._cost_ewma is None
                               else self._cost_ewma / self.interval_s),
        }

    def stats(self):
        """Sampler self-stats."""
        with self._lock:
            return self._stats_locked()

    # ---- thread ----------------------------------------------------------
    @property
    def running(self):
        return self._thread is not None

    def start(self):
        """Run the sampler on a daemon thread.  Strictly opt-in —
        importing the module starts nothing."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=self.thread_name, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        own = threading.get_ident()
        while not self._stop.is_set():
            try:
                self.sample_once(_skip_tid=own)
            except Exception:
                pass    # silent-ok: a torn frame walk must not kill
                #         the sampler; the next beat resamples
            self._stop.wait(self._effective_interval())

    def _effective_interval(self):
        with self._lock:
            return self.capture_interval_s if self._capture is not None \
                else self.interval_s

    def stop(self):
        t, self._thread = self._thread, None
        if t is not None:
            self._stop.set()
            t.join(timeout=5.0)
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False


def diff_profiles(current, baseline, limit=50):
    """Subtract two :meth:`StackSampler.profile` payloads.

    Each window's stacks and phase slices are normalized to fractions
    of that window's sample count, so windows of different length or
    sampling rate compare; entries sort by fraction delta, biggest
    regression first, truncated to the ``limit`` largest-|delta|
    stacks.  A positive delta means the stack grew in ``current``."""
    na = max(1, int(current.get("samples") or 0))
    nb = max(1, int(baseline.get("samples") or 0))

    def _rows(cur_map, base_map, field):
        keys = set(cur_map) | set(base_map)
        out = []
        for k in keys:
            fa = (cur_map.get(k) or {}).get("samples", 0) / na
            fb = (base_map.get(k) or {}).get("samples", 0) / nb
            if fa == 0.0 and fb == 0.0:
                continue
            out.append({field: k, "fraction": round(fa, 6),
                        "baseline_fraction": round(fb, 6),
                        "delta": round(fa - fb, 6)})
        out.sort(key=lambda r: -abs(r["delta"]))
        return out

    stacks = _rows(current.get("stacks") or {},
                   baseline.get("stacks") or {}, "stack")[:int(limit)]
    phases = _rows(current.get("by_phase") or {},
                   baseline.get("by_phase") or {}, "phase")
    stacks.sort(key=lambda r: -r["delta"])
    phases.sort(key=lambda r: -r["delta"])
    return {
        "samples": {"current": int(current.get("samples") or 0),
                    "baseline": int(baseline.get("samples") or 0)},
        "windows": {"current": current.get("window_seconds"),
                    "baseline": baseline.get("window_seconds")},
        "by_phase": phases,
        "stacks": stacks,
    }
