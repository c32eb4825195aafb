"""Request-level tracing — the flight recorder's span model (the port of
``paddle_tpu/observability/tracing.py``, less its chrome-trace export).

Metrics (histograms, counters) answer "how slow is the p95"; they cannot
answer "why was *this* request slow".  A :class:`Tracer` records one
bounded-memory timeline per logical operation — a serving request's full
lifecycle (``queued → admitted → chunk[i] → decode[i] →
finished|evicted|shed``), a training step — as a tree of :class:`Span`\\ s
sharing a ``trace_id``.  Design points:

- **globally unique IDs**: trace and span ids are strings prefixed with
  a per-tracer *nonce* (pid + random bytes), so ids minted by different
  processes — or different tracers in one process — never collide.  The
  fleet trace collector merges per-replica rings **by trace_id**; with
  counter ids every process's "trace 1" would alias.
- **context propagation**: :meth:`Span.context` snapshots a span as a
  :class:`TraceContext` (trace_id + parent span id), and
  :meth:`Tracer.start_trace` accepts ``context=`` to continue a trace
  started elsewhere.  A continued trace records a *segment* in this
  tracer's ring under the original trace_id with its root span parented
  to the remote span — the router's dispatch span, a replica's request
  segment, and the failover re-dispatch all share one trace.
- **tail-based retention**: the completed ring is a *policy* ring, not
  newest-N.  :class:`TailRetention` classifies each finished trace —
  errors, injected faults, shed/evicted/evacuated requests, failovers,
  missed deadlines, above-threshold latency are always retained; boring
  fast traces are probabilistically sampled, and under ring pressure
  sampled entries are evicted before interesting ones.  A soak's worst
  requests stay inspectable after millions of good ones.
- **thread-safe, bounded**: spans mutate under the tracer's lock; a
  completed trace (its segment root ended) moves into the ring of at
  most ``max_traces`` traces, so a serving process that handles
  millions of requests holds a constant-size flight record.
- **injectable clock**: the tracer reads time from a ``clock`` callable
  (seconds, ``time.perf_counter`` by default) — the serving engine hands
  its own clock over, so deadline tests drive spans deterministically
  and span timestamps share the engine's timebase.
- **zero-cost disable**: ``Tracer(enabled=False)`` returns a shared
  no-op span from every ``start_*`` call — no lock, no allocation —
  the "tracing off" baseline.
- **JSON export**: :meth:`Tracer.traces` returns completed traces as
  JSON-able dicts; :func:`merge_traces` folds several rings (the
  router's and each replica engine's) into one fleet view by trace_id.

Nothing here starts threads or opens sockets; the process-wide
:func:`default_tracer` is a plain object created at import.
"""
from __future__ import annotations

import contextlib
import os
import random
import threading
import time

__all__ = ["Span", "TraceContext", "TailRetention", "Tracer",
           "default_tracer", "active_span", "activate", "merge_traces"]


class TraceContext:
    """The portable identity of a point in a trace: ``trace_id`` plus
    the ``span_id`` new work should parent to.  JSON-able via
    :meth:`to_dict` / :meth:`from_dict`, so it rides request objects,
    store payloads, and failover re-dispatch unchanged across process
    boundaries."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id=None):
        self.trace_id = trace_id
        self.span_id = span_id

    def to_dict(self):
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_dict(cls, d):
        if d is None:
            return None
        return cls(d.get("trace_id"), d.get("span_id"))

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and other.trace_id == self.trace_id
                and other.span_id == self.span_id)

    def __hash__(self):
        return hash((self.trace_id, self.span_id))

    def __repr__(self):
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"


class Span:
    """One timed operation inside a trace.

    Created via :meth:`Tracer.start_trace` (root) or
    :meth:`Tracer.start_span` (child); ``end()`` stamps the end time and,
    for a segment root, finalizes the whole trace into the tracer's ring
    buffer.  Usable as a context manager.  ``attributes`` is a JSON-able
    dict (page-pool occupancy, batch slot, epoch/step, ...).
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_s",
                 "end_s", "attributes", "_tracer")

    def __init__(self, name, trace_id, span_id, parent_id, start_s,
                 tracer, attributes=None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_s = start_s
        self.end_s = None
        self.attributes = dict(attributes or {})
        self._tracer = tracer

    @property
    def is_root(self):
        return self.parent_id is None

    @property
    def ended(self):
        return self.end_s is not None

    def context(self):
        """This span as a :class:`TraceContext` — hand it to another
        tracer's ``start_trace(context=...)`` (or serialize it across a
        process boundary) to parent further work here."""
        return TraceContext(self.trace_id, self.span_id)

    def set_attribute(self, key, value):
        self.attributes[key] = value
        return self

    def set_attributes(self, mapping):
        self.attributes.update(mapping)
        return self

    def end(self, end_s=None):
        self._tracer._end_span(self, end_s)
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.attributes.setdefault("error", repr(exc))
        self.end()
        return False

    def to_dict(self):
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start_s": self.start_s, "end_s": self.end_s,
                "attributes": dict(self.attributes)}

    def __repr__(self):
        state = "ended" if self.ended else "open"
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"span={self.span_id}, {state})")


class _NullSpan:
    """The shared no-op span a disabled tracer hands out.  Every mutator
    is a no-op; ``attributes`` is a fresh throwaway dict per access so
    callers that ``setdefault`` into it neither crash nor accumulate
    state.  ``context()`` is None — disabled tracing propagates no
    context, and downstream exemplar/attribution code treats that as
    "no trace"."""

    __slots__ = ()

    name = None
    trace_id = None
    span_id = None
    parent_id = None
    start_s = None
    end_s = None
    is_root = False
    ended = True

    @property
    def attributes(self):
        return {}

    def context(self):
        return None

    def set_attribute(self, key, value):
        return self

    def set_attributes(self, mapping):
        return self

    def end(self, end_s=None):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def to_dict(self):
        return {"name": None, "trace_id": None, "span_id": None,
                "parent_id": None, "start_s": None, "end_s": None,
                "attributes": {}}


_NULL_SPAN = _NullSpan()

# States a request trace can end in that make it unconditionally worth
# keeping: shed (rejected / retry_after), evicted, evacuated, plus the
# blast-radius terminals — failed (per-row isolation pinned an error on
# the request) and quarantined (convicted poison) — the tail the ring
# exists to preserve.
_INTERESTING_STATES = ("rejected", "retry_after", "evicted", "evacuated",
                       "failed", "quarantined")


class TailRetention:
    """Tail-based retention policy for the completed-trace ring.

    ``classify(entry)`` names why a finished trace is interesting
    (``error`` / ``fault`` / its terminal state / ``failover`` /
    ``deadline`` / ``slow`` / ``flagged``) or returns None for a boring
    trace; boring traces are kept with probability ``sample_rate``
    (seeded — runs reproduce).  ``slow_threshold_s=None`` disables the
    latency criterion.  The default policy (``sample_rate=1.0``) keeps
    everything, matching the old newest-N ring for light use."""

    def __init__(self, slow_threshold_s=None, sample_rate=1.0, seed=0):
        self.slow_threshold_s = slow_threshold_s
        self.sample_rate = float(sample_rate)
        # Driven only under the owning tracer's lock (_end_span).
        self._rng = random.Random(seed)

    def classify(self, entry):
        """Retention reason for a completed-trace dict, or None."""
        spans = entry.get("spans") or ()
        for s in spans:
            attrs = s.get("attributes") or {}
            if "error" in attrs:
                return "error"
            if attrs.get("faults"):
                return "fault"
            if attrs.get("retain"):
                return "flagged"
            state = attrs.get("state")
            if state in _INTERESTING_STATES:
                return str(state)
            if attrs.get("redispatches") or attrs.get("redispatched"):
                return "failover"
            if attrs.get("finish_reason") in ("deadline",
                                              "deadline_exceeded"):
                return "deadline"
            if "failover" in (s.get("name") or ""):
                return "failover"
        if self.slow_threshold_s is not None and \
                entry.get("duration_s", 0.0) >= self.slow_threshold_s:
            return "slow"
        return None

    def sample(self):
        """Whether to keep one boring trace (seeded coin flip)."""
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        return self._rng.random() < self.sample_rate


def _new_nonce():
    # pid for debuggability + random bytes so forked twins and multiple
    # tracers inside one process still get distinct prefixes
    return f"{os.getpid():x}-{os.urandom(4).hex()}"


class Tracer:
    """Span factory + bounded policy ring of completed traces.

    ``clock`` is a zero-arg callable returning seconds (defaults to
    ``time.perf_counter`` — the profiler's timebase); ``max_traces``
    bounds the completed-trace ring; ``retention`` is the
    :class:`TailRetention` policy (keep-everything by default);
    ``enabled=False`` turns every ``start_*`` into a lock-free no-op
    returning the shared null span.  ``nonce`` overrides the generated
    id prefix (tests forcing collisions/determinism).

    A trace *segment* completes when its first local span (the segment
    root — a true root, or a ``context=``-continued span) ends; any
    still-open child is force-ended at the root's end time with
    ``attributes["unfinished"] = True`` (a crash-truncated request still
    yields a readable timeline).
    """

    def __init__(self, clock=None, max_traces=256, retention=None,
                 enabled=True, nonce=None):
        self.clock = clock or time.perf_counter
        self.max_traces = int(max_traces)
        self.enabled = bool(enabled)
        self.retention = retention or TailRetention()
        self.nonce = nonce or _new_nonce()
        self._lock = threading.Lock()
        self._next_trace_id = 1    # guarded-by: self._lock
        self._next_span_id = 1     # guarded-by: self._lock
        # _live: trace_id -> [Span, ...] (segment root first)
        self._live = {}            # guarded-by: self._lock
        self._completed = []       # ring, oldest first; guarded-by: self._lock
        self._n_completed = 0      # lifetime count; guarded-by: self._lock
        self._n_dropped = 0        # sampled-out count; guarded-by: self._lock

    # ---- span lifecycle -------------------------------------------------
    def start_trace(self, name, attributes=None, start_s=None,
                    context=None):
        """Open a trace; returns its (segment-)root span.

        With ``context=None`` this mints a fresh globally-unique
        trace_id.  With a :class:`TraceContext` (or its dict form) the
        span *continues* that trace: same trace_id, parented to the
        context's span.  If the context's trace is live in THIS tracer
        the span joins it as an ordinary child; otherwise it roots a new
        local segment that the fleet collector later merges with the
        other processes' segments by trace_id."""
        if not self.enabled:
            return _NULL_SPAN
        if isinstance(context, dict):
            context = TraceContext.from_dict(context)
        with self._lock:
            sid = f"{self.nonce}.s{self._next_span_id}"
            self._next_span_id += 1
            t0 = self.clock() if start_s is None else start_s
            if context is not None and context.trace_id is not None:
                tid = context.trace_id
                span = Span(name, tid, sid, context.span_id, t0, self,
                            attributes)
                spans = self._live.get(tid)
                if spans is not None:
                    spans.append(span)      # joined a live local trace
                else:
                    self._live[tid] = [span]    # new local segment
            else:
                tid = f"{self.nonce}.t{self._next_trace_id}"
                self._next_trace_id += 1
                span = Span(name, tid, sid, None, t0, self, attributes)
                self._live[tid] = [span]
        return span

    def start_span(self, name, parent, attributes=None, start_s=None):
        """Open a child span under ``parent`` (a Span of this tracer)."""
        if not self.enabled or parent is _NULL_SPAN:
            return _NULL_SPAN
        with self._lock:
            sid = f"{self.nonce}.s{self._next_span_id}"
            self._next_span_id += 1
            span = Span(name, parent.trace_id, sid, parent.span_id,
                        self.clock() if start_s is None else start_s,
                        self, attributes)
            spans = self._live.get(parent.trace_id)
            if spans is not None:
                spans.append(span)
        return span

    def _end_span(self, span, end_s=None):
        with self._lock:
            if span.ended:
                return
            span.end_s = self.clock() if end_s is None else end_s
            spans = self._live.get(span.trace_id)
            if spans is None or spans[0] is not span:
                return              # a child ended; segment still open
            self._live.pop(span.trace_id)
            for s in spans:
                if not s.ended:                 # truncated child
                    s.end_s = span.end_s
                    s.attributes["unfinished"] = True
            entry = {
                "trace_id": span.trace_id, "name": span.name,
                "start_s": span.start_s, "end_s": span.end_s,
                "duration_s": span.end_s - span.start_s,
                "spans": [s.to_dict() for s in spans],
            }
            self._n_completed += 1
            reason = self.retention.classify(entry)
            if reason is None:
                if not self.retention.sample():
                    self._n_dropped += 1
                    return
                reason = "sampled"
            entry["retained"] = reason
            self._completed.append(entry)
            while len(self._completed) > self.max_traces:
                self._evict_one_locked()

    def _evict_one_locked(self):
        # guarded-by: self._lock (called from _end_span only).  Policy:
        # the oldest *sampled* (boring) entry goes first; only when the
        # whole ring is interesting does the oldest interesting one go.
        for i, tr in enumerate(self._completed):
            if tr.get("retained") == "sampled":
                del self._completed[i]
                return
        del self._completed[0]

    # ---- readers --------------------------------------------------------
    def live_spans(self):
        """Open (in-flight) spans across live traces, as dicts — what a
        hung process was in the middle of.  The hang watchdog's debug
        bundle carries these: a crash-truncated trace never reaches the
        completed ring, so the live view is the only record."""
        with self._lock:
            return [s.to_dict()
                    for spans in self._live.values()
                    for s in spans if not s.ended]

    def traces(self, limit=None):
        """Completed traces (oldest → newest), each a JSON-able dict;
        ``limit`` keeps only the newest N."""
        with self._lock:
            out = list(self._completed)
        if limit is not None:
            out = out[-int(limit):]
        return out

    def summary(self):
        """Aggregate over the ring: lifetime completed count plus
        per-root-name count/total duration — the bench's embedded
        trace digest."""
        # one locked read: the lifetime count and the ring must come
        # from the same instant, or "completed" can lag a trace that
        # "buffered" already shows (racing _end_span)
        with self._lock:
            completed = self._n_completed
            dropped = self._n_dropped
            ring = list(self._completed)
        by_name, by_reason = {}, {}
        for tr in ring:
            # request#N / decode[i] collapse to one aggregate key each
            key = tr["name"].split("#")[0].split("[")[0]
            cnt, tot = by_name.get(key, (0, 0.0))
            by_name[key] = (cnt + 1, tot + tr["duration_s"])
            reason = tr.get("retained", "sampled")
            by_reason[reason] = by_reason.get(reason, 0) + 1
        return {"completed": completed,
                "buffered": len(ring),
                "dropped": dropped,
                "by_name": {k: {"count": c, "total_s": t}
                            for k, (c, t) in sorted(by_name.items())},
                "retained_by_reason": dict(sorted(by_reason.items()))}

    def reset(self):
        with self._lock:
            self._live.clear()
            self._completed.clear()
            self._n_completed = 0
            self._n_dropped = 0


# ---- active-span ambient context ---------------------------------------
_ACTIVE = threading.local()


def active_span():
    """The innermost span activated on this thread via :func:`activate`
    (None outside any activation).  Instrumentation that cannot thread a
    span through its call path — fault injection, deep library hooks —
    reads the ambient span here."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def activate(span):
    """Make ``span`` the thread's ambient span for the block, so
    :func:`active_span` callers underneath (e.g. a firing fault point)
    can attach events to it without plumbing."""
    stack = _ACTIVE.__dict__.setdefault("stack", [])
    stack.append(span)
    try:
        yield span
    finally:
        stack.pop()


# ---- merging + export ----------------------------------------------------
def merge_traces(rings):
    """Merge per-source trace rings into one fleet view, grouped by
    trace_id.  ``rings`` is an iterable of ``(source_label, traces)``
    pairs (each ``traces`` a :meth:`Tracer.traces`-shaped list).  A
    trace that crossed sources — router dispatch, first replica,
    failover, second replica — comes back as ONE entry whose ``spans``
    carry a ``source`` field, whose window is the union of its
    segments', and whose ``name``/``retained`` come from the
    originating segment (the one whose root has no remote parent) with
    the strongest retention reason winning over ``sampled``.  Ordering:
    by merged start time, ties by trace_id."""
    merged = {}
    for source, traces in rings:
        for tr in traces or ():
            tid = tr.get("trace_id")
            m = merged.get(tid)
            if m is None:
                m = merged[tid] = {
                    "trace_id": tid, "name": tr.get("name"),
                    "start_s": tr.get("start_s"),
                    "end_s": tr.get("end_s"),
                    "spans": [], "segments": [],
                    "retained": tr.get("retained", "sampled"),
                }
            seg_spans = tr.get("spans") or ()
            local_ids = {s.get("span_id") for s in seg_spans}
            # originating segment: its root's parent is not a span of
            # any segment — approximated per-segment as "root has no
            # parent at all"
            seg_root = seg_spans[0] if seg_spans else None
            if seg_root is not None and seg_root.get("parent_id") is None:
                m["name"] = tr.get("name")
            for s in seg_spans:
                d = dict(s)
                d["source"] = source
                m["spans"].append(d)
            m["segments"].append({
                "source": source, "name": tr.get("name"),
                "start_s": tr.get("start_s"), "end_s": tr.get("end_s"),
                "root_local": (seg_root is not None
                               and seg_root.get("parent_id") is None),
                "n_spans": len(local_ids),
            })
            for key, pick in (("start_s", min), ("end_s", max)):
                a, b = m[key], tr.get(key)
                if b is not None:
                    m[key] = b if a is None else pick(a, b)
            if m["retained"] == "sampled" and \
                    tr.get("retained", "sampled") != "sampled":
                m["retained"] = tr.get("retained")
    out = []
    for m in merged.values():
        if m["start_s"] is not None and m["end_s"] is not None:
            m["duration_s"] = m["end_s"] - m["start_s"]
        else:
            m["duration_s"] = None
        m["spans"].sort(key=lambda s: (s.get("start_s") or 0.0))
        out.append(m)
    out.sort(key=lambda m: (m["start_s"] or 0.0, str(m["trace_id"])))
    return out


_DEFAULT = Tracer()


def default_tracer() -> Tracer:
    """The process-wide tracer default-clock serving engines, routers and
    autoscalers record into (mirrors ``metrics.default_registry``)."""
    return _DEFAULT
