"""Request-level tracing — the span model the serving engine records its
flight log with (the port of the core of
``paddle_tpu/observability/tracing.py``: ``Tracer``, ``Span`` and the
process-wide ``default_tracer``).

A :class:`Tracer` records one timeline per logical operation — a serving
request's lifecycle (``queued → chunk[i] → decode[i] → finished |
evicted | shed``) — as a tree of :class:`Span`\\ s sharing a
``trace_id``, and keeps the newest completed traces in a bounded ring.
Cross-process trace context, tail retention, chrome export and trace
merging belong to the fleet layer and are not ported yet.
"""
from __future__ import annotations

import collections
import threading
import time

__all__ = ["Span", "Tracer", "default_tracer"]


class Span:
    """One timed operation inside a trace; ``end()`` stamps the end time
    and, for the trace's root, moves the whole trace into the ring."""

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

    def set_attribute(self, key, value):
        self.attributes[key] = value
        return self

    def set_attributes(self, mapping):
        self.attributes.update(mapping)
        return self

    def end(self, end_s=None):
        self._tracer._end_span(self, end_s)
        return self

    def to_dict(self):
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start_s": self.start_s, "end_s": self.end_s,
                "attributes": dict(self.attributes)}


class Tracer:
    """Span factory + bounded ring of completed traces.

    ``clock`` returns seconds (``time.perf_counter`` by default);
    ``max_traces`` bounds the ring (the oldest trace leaves first).  A
    trace completes when its root span ends; still-open children are
    force-ended then with ``attributes["unfinished"] = True``."""

    def __init__(self, clock=None, max_traces=256):
        self.clock = clock or time.perf_counter
        self._lock = threading.Lock()
        self._next_id = 1          # guarded-by: self._lock
        self._live = {}            # trace_id -> [Span]; guarded-by: self._lock
        # oldest first; guarded-by: self._lock
        self._completed = collections.deque(maxlen=int(max_traces))

    def _span(self, name, trace_id, parent_id, start_s, attributes):
        # caller holds self._lock
        sid = f"s{self._next_id}"
        self._next_id += 1
        return Span(name, trace_id, sid, parent_id,
                    self.clock() if start_s is None else start_s, self,
                    attributes)

    def start_trace(self, name, attributes=None, start_s=None):
        """Open a trace and return its root span."""
        with self._lock:
            tid = f"t{self._next_id}"
            span = self._span(name, tid, None, start_s, attributes)
            self._live[tid] = [span]
        return span

    def start_span(self, name, parent, attributes=None, start_s=None):
        """Open a child span under ``parent``."""
        with self._lock:
            span = self._span(name, parent.trace_id, parent.span_id,
                              start_s, attributes)
            spans = self._live.get(parent.trace_id)
            if spans is not None:
                spans.append(span)
        return span

    def _end_span(self, span, end_s=None):
        with self._lock:
            if span.end_s is not None:
                return
            span.end_s = self.clock() if end_s is None else end_s
            spans = self._live.get(span.trace_id)
            if spans is None or spans[0] is not span:
                return              # a child ended; the trace is still open
            del self._live[span.trace_id]
            for s in spans:
                if s.end_s is None:
                    s.end_s = span.end_s
                    s.attributes["unfinished"] = True
            self._completed.append({
                "trace_id": span.trace_id, "name": span.name,
                "start_s": span.start_s, "end_s": span.end_s,
                "duration_s": span.end_s - span.start_s,
                "spans": [s.to_dict() for s in spans]})

    def traces(self):
        """Completed traces (oldest → newest) as JSON-able dicts."""
        with self._lock:
            return list(self._completed)


_DEFAULT = Tracer()


def default_tracer() -> Tracer:
    """The process-wide tracer default-clock serving engines record
    into."""
    return _DEFAULT
