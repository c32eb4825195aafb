"""Fleet trace gossip — per-replica trace rings over the TCPStore plane
(the port of ``paddle_tpu/observability/trace_gossip.py``).

The tracer's retention ring is process-local; a failed-over request's
timeline lives *split* across the router's tracer and two replicas'
tracers (more when the fleet is real processes).  Each replica therefore
publishes its bounded completed-trace ring — trace ids are globally
unique (process-nonce-prefixed, see :mod:`.tracing`), so rings merge by
trace_id with zero coordination.  The transport is the same
:class:`~.aggregate.StorePublisher` machinery every per-rank publisher
rides (metric snapshots, heartbeats, prefix summaries): one TCPStore
key per replica, overwritten in place, a daemon thread that survives a
flaky store, nothing started on import.

Correctness note: gossip is *advisory* and staleness-tolerant.  A lost
or stale ring means the fleet view temporarily misses that replica's
segments of a trace — the collector still returns every other segment,
and the next publish heals the view.  Nothing routing- or
serving-critical reads these payloads.

Clock note: spans carry each publisher's own clock values
(``perf_counter`` by default), so cross-process timestamps are only as
comparable as the clocks are.  Each payload carries ``clock_offset_s``
(wall time minus tracer clock at publish) so a consumer that needs one
wall timeline can rebase; the collector itself merges by trace_id and
never rewrites timestamps.

Wiring::

    # each replica process
    TraceRingPublisher(tracer, replica_id=r, store=store).start(1.0)

    # the operator/collector process
    fleet = collect_fleet_traces(store, range(n_replicas))
"""
from __future__ import annotations

import json
import time

from .aggregate import StorePublisher
from .tracing import merge_traces

__all__ = ["TraceRingPublisher", "collect_trace_rings",
           "collect_fleet_traces"]


def _replica_key(prefix, replica_id):
    return f"{prefix}/replica_{int(replica_id)}"


class TraceRingPublisher(StorePublisher):
    """Publish one tracer's completed-trace ring under its fleet key.

    ``publish()`` pushes once; ``start(interval_s)`` runs the inherited
    daemon loop.  ``max_traces`` bounds the payload regardless of the
    tracer's own ring size (the newest traces win the slots — the
    tracer's tail-retention already decided *which* traces those
    are)."""

    def __init__(self, tracer, replica_id, store, key_prefix="traces",
                 max_traces=64, clock=None):
        super().__init__(store, _replica_key(key_prefix, replica_id),
                         clock=clock)
        self.tracer = tracer
        self.replica_id = int(replica_id)
        self.max_traces = int(max_traces)
        self.thread_name = f"trace-gossip-{self.replica_id}"

    def payload(self):
        return {"replica": self.replica_id, "time": self._clock(),
                "clock_offset_s": time.time() - self.tracer.clock(),
                "traces": self.tracer.traces(limit=self.max_traces)}


def collect_trace_rings(store, replica_ids, key_prefix="traces",
                        stale_after_s=None, clock=None):
    """Read every replica's published ring in ONE ``mget`` round trip.
    Returns ``[(source_label, traces)]`` pairs — the
    :func:`~.tracing.merge_traces` input shape.  Replicas that never
    published, published garbage, or whose stamp is older than
    ``stale_after_s`` (publisher wall clock) are simply absent.
    Non-blocking by construction: a scrape never waits on a slow
    store."""
    replica_ids = list(replica_ids)
    keys = [_replica_key(key_prefix, r) for r in replica_ids]
    rings = []
    now = (clock or time.time)()
    for rid, raw in zip(replica_ids, store.mget(keys)):
        if raw is None:
            continue
        try:
            payload = json.loads(raw)
        except (ValueError, TypeError):
            continue            # torn/garbled publish: treat as absent
        if stale_after_s is not None and \
                now - float(payload.get("time") or 0.0) > stale_after_s:
            continue
        traces = payload.get("traces")
        if isinstance(traces, list):
            rings.append((f"replica{int(rid)}", traces))
    return rings


def collect_fleet_traces(store, replica_ids, key_prefix="traces",
                         stale_after_s=None, clock=None,
                         extra_rings=()):
    """The fleet view: every replica's published ring merged by
    trace_id (:func:`~.tracing.merge_traces`) into one trace list
    where a failed-over request is ONE entry whose spans carry their
    source replica.  ``extra_rings`` appends in-process rings — e.g.
    ``[("router", router.tracer.traces())]`` so the dispatch/failover
    segments land in the same merge."""
    rings = collect_trace_rings(store, replica_ids,
                                key_prefix=key_prefix,
                                stale_after_s=stale_after_s, clock=clock)
    return merge_traces(list(extra_rings) + rings)
