"""Per-replica serve loop — the process a fleet replica lives in (the
port of ``paddle_tpu/serving/replica.py``).

In-process fleets pull ``engine.prefix_summary()`` directly; a replica
running as its own process needs something to drive its gossip.
:class:`ReplicaServer` is that piece — the canonical body of one
replica process:

- builds (or adopts) the engine,
- owns exactly one :class:`~.prefix_gossip.PrefixSummaryPublisher` and
  one :class:`~paddle_tpu_torch.observability.trace_gossip.TraceRingPublisher`
  when a TCPStore is given, started for precisely the serve loop's
  lifetime (started in :meth:`serve`, stopped in its ``finally`` —
  a crashed loop never leaves a publisher gossiping for a corpse),
- drives ``engine.step()`` whenever the scheduler has work.

With each replica process running a ``ReplicaServer`` and the router
built with ``prefix_summary_source=lambda:
collect_prefix_summaries(store, ids)``, the autoscaler's cache-warmth
victim selection and the router's cache-aware placement both see
cross-process warmth — the same scores the in-process fleet gets, now
over the TCPStore plane.  The trace publisher is the distributed-
tracing leg of the same plane: each replica's completed-trace ring
(globally-unique, nonce-prefixed trace ids) lands under its own store
key, and ``collect_fleet_traces(store, ids)`` merges them by trace_id
into the one-trace-per-request fleet view.

Wiring::

    # each replica process
    srv = ReplicaServer(lambda: Engine(cfg, params), replica_id=r,
                        store=store, gossip_interval_s=1.0)
    srv.serve(should_stop=shutdown_event.is_set)

    # the router/autoscaler process
    router = FleetRouter(..., prefix_summary_source=lambda:
        collect_prefix_summaries(store, range(n_replicas)))
    fleet_view = collect_fleet_traces(store, range(n_replicas))
"""
from __future__ import annotations

import time

from ..observability.trace_gossip import TraceRingPublisher
from .prefix_gossip import PrefixSummaryPublisher

__all__ = ["ReplicaServer"]


class ReplicaServer:
    """One replica process's serve loop + its gossip publishers.

    ``engine_or_factory`` is a live engine or a zero-arg factory
    (``warmup=True`` runs :meth:`~.engine.Engine.warmup` on a
    factory-built engine before serving — rotation entry is warm but
    the decode EWMA stays unsampled).  ``store=None`` serves without
    gossip (a single-process deployment); with a store, one
    :class:`PrefixSummaryPublisher` publishes this replica's bounded
    radix summary and one :class:`TraceRingPublisher` its completed-
    trace ring, both every ``gossip_interval_s`` while :meth:`serve`
    runs (``trace_gossip=False`` opts the trace leg out;
    ``trace_max_traces`` bounds its payload).  ``idle_sleep_s`` is the
    poll interval when the scheduler is empty."""

    def __init__(self, engine_or_factory, replica_id, *, store=None,
                 gossip_interval_s=1.0, gossip_max_entries=32,
                 key_prefix="prefix", trace_gossip=True,
                 trace_key_prefix="traces", trace_max_traces=64,
                 warmup=True, idle_sleep_s=0.001, clock=None):
        if callable(engine_or_factory) and \
                not hasattr(engine_or_factory, "step"):
            self.engine = engine_or_factory()
            if warmup:
                self.engine.warmup()
        else:
            self.engine = engine_or_factory
        self.replica_id = int(replica_id)
        self.gossip_interval_s = float(gossip_interval_s)
        self.idle_sleep_s = float(idle_sleep_s)
        self.steps = 0
        self.publisher = None
        self.trace_publisher = None
        if store is not None:
            self.publisher = PrefixSummaryPublisher(
                self.engine, self.replica_id, store,
                key_prefix=key_prefix, max_entries=gossip_max_entries,
                clock=clock)
            if trace_gossip and \
                    getattr(self.engine, "tracer", None) is not None:
                self.trace_publisher = TraceRingPublisher(
                    self.engine.tracer, self.replica_id, store,
                    key_prefix=trace_key_prefix,
                    max_traces=trace_max_traces, clock=clock)

    def _publishers(self):
        return [p for p in (self.publisher, self.trace_publisher)
                if p is not None]

    def step(self):
        """One scheduler step (inline-driving hook for tests)."""
        self.steps += 1
        return self.engine.step()

    def serve(self, should_stop=None, max_steps=None):
        """Drive the engine until ``should_stop()`` (or ``max_steps``
        scheduler steps).  The gossip publisher threads run for exactly
        this loop's lifetime and push one final payload on the way
        out, so a replica that drained-and-exited leaves its last
        summary (and its final trace ring — the fleet view keeps its
        segments) behind, not a stale mid-run one.  Returns the number
        of steps served."""
        if should_stop is None and max_steps is None:
            raise ValueError("serve() needs should_stop and/or "
                             "max_steps — an unbounded serve loop has "
                             "no exit")
        served = 0
        for pub in self._publishers():
            pub.start(self.gossip_interval_s)
        try:
            # lint-ok: bounded-retries the loop's bound is the caller's
            # should_stop()/max_steps, validated non-None above — a
            # serve loop, not a retry loop
            while True:
                if should_stop is not None and should_stop():
                    return served
                if max_steps is not None and served >= max_steps:
                    return served
                if self.engine.has_work():
                    self.step()
                    served += 1
                else:
                    time.sleep(self.idle_sleep_s)
        finally:
            for pub in self._publishers():
                pub.stop()
                try:
                    pub.publish()
                except Exception:
                    pass    # silent-ok: a flaky store at shutdown
                    #         cannot matter — collectors treat the
                    #         absent/stale key as a cold replica

    def __enter__(self):
        for pub in self._publishers():
            pub.start(self.gossip_interval_s)
        return self

    def __exit__(self, *exc):
        for pub in self._publishers():
            pub.stop()
        return False
