"""Fleet prefix-cache gossip — radix summaries over the TCPStore plane
(the port of ``paddle_tpu/serving/prefix_gossip.py``).

Cache-aware routing needs every router to know, cheaply and staleness-
tolerantly, which replica already holds which prompt prefixes.  Shipping
radix trees (or token ids) around would be unbounded and leak prompt
content; instead each replica publishes the **bounded** summary
``Engine.prefix_summary()`` builds — the chain hashes of its most
recently used cached page-aligned prefixes plus hit stats — and routers
test an incoming prompt's own chain hashes (:func:`...kv_cache.prefix_hashes`)
against it.  The transport is the same
:class:`~paddle_tpu_torch.observability.aggregate.StorePublisher`
machinery every other per-rank publisher rides (metric snapshots,
hang-watchdog heartbeats): one TCPStore key per replica, overwritten in
place, a daemon thread that survives a flaky store, nothing started on
import.

Correctness note: gossip is *advisory*.  The dispatch target re-walks
its own tree at admission, so a stale or lost summary mis-scores a
placement (cold prefill where a warm replica existed) but can never
break greedy parity or the router's exactly-once failover contract.

Wiring::

    # each replica process
    PrefixSummaryPublisher(engine, replica_id=r, store=store).start(1.0)

    # the router process
    router = FleetRouter(..., prefix_summary_source=lambda:
        collect_prefix_summaries(store, range(n_replicas)))
"""
from __future__ import annotations

import json
import time

from ..observability.aggregate import StorePublisher

__all__ = ["PrefixSummaryPublisher", "collect_prefix_summaries"]


def _replica_key(prefix, replica_id):
    return f"{prefix}/replica_{int(replica_id)}"


class PrefixSummaryPublisher(StorePublisher):
    """Publish one engine's bounded radix summary under its fleet key.

    ``publish()`` pushes once; ``start(interval_s)`` runs the inherited
    daemon loop.  ``max_entries`` bounds the payload no matter how warm
    the cache gets (the most recently used prefixes win the slots)."""

    def __init__(self, engine, replica_id, store, key_prefix="prefix",
                 max_entries=32, clock=None):
        super().__init__(store, _replica_key(key_prefix, replica_id),
                         clock=clock)
        self.engine = engine
        self.replica_id = int(replica_id)
        self.max_entries = int(max_entries)
        self.thread_name = f"prefix-gossip-{self.replica_id}"

    def payload(self):
        return {"replica": self.replica_id, "time": self._clock(),
                "summary": self.engine.prefix_summary(
                    max_entries=self.max_entries)}


def collect_prefix_summaries(store, replica_ids, key_prefix="prefix",
                             stale_after_s=None, clock=None):
    """Read every replica's published summary in ONE ``mget`` round
    trip.  Returns ``{replica_id: summary}``; replicas that never
    published, published garbage, or whose stamp is older than
    ``stale_after_s`` (publisher wall clock) are simply absent — the
    router then scores them with no cache credit, which is the correct
    cold assumption.  Non-blocking by construction: a router tick never
    waits on a slow store."""
    replica_ids = list(replica_ids)
    keys = [_replica_key(key_prefix, r) for r in replica_ids]
    out = {}
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
        summary = payload.get("summary")
        if isinstance(summary, dict):
            out[int(rid)] = summary
    return out
