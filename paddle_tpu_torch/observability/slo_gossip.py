"""Fleet SLO gossip — per-replica objective status over the TCPStore
(the port of ``paddle_tpu/observability/slo_gossip.py``).

An :class:`~.slo.SLOEngine` is process-local: each replica evaluates its
own objectives against its own time-series store, so "is the *fleet*
inside its error budget" has no single answer surface.  Each replica
therefore publishes its engine's :meth:`~.slo.SLOEngine.status` payload
— objectives, live burn rates, remaining budget, alert states, recent
transitions — and rank 0 folds every replica's view into one merged
payload behind ``/slo?fleet=1``.  The transport is the same
:class:`~.aggregate.StorePublisher` machinery every per-rank publisher
rides: one TCPStore key per replica, overwritten in place, a daemon
thread that survives a flaky store, nothing started on import.

Correctness note: gossip is *advisory* and staleness-tolerant.  A lost
or stale status means the fleet view temporarily misses that replica's
objectives — the fold reports every replica it can see (and which ones
those were), and the next publish heals the view.  Nothing
alerting-critical reads the merged payload: each replica's own engine
keeps firing its own pages regardless.

Merge semantics (:func:`merge_fleet_slo`): fleet ``page_active`` is the
OR over replicas; per-objective, the fold keeps each replica's live
burn rates and budget, the *worst* (minimum) remaining budget wins
``error_budget_ratio``, active alerts are listed with their replica,
and the transition logs interleave by time (each entry tagged with its
replica) so one timeline shows which replica fired first.

Wiring::

    # each replica process
    SLOStatusPublisher(engine, replica_id=r, store=store).start(1.0)

    # rank 0
    start_telemetry_server(
        fleet_slo=lambda: collect_fleet_slo(store, range(n_replicas)))
"""
from __future__ import annotations

import json
import time

from .aggregate import StorePublisher

__all__ = ["SLOStatusPublisher", "collect_slo_statuses",
           "merge_fleet_slo", "collect_fleet_slo"]

#: newest interleaved transitions kept in the merged payload
_MAX_FLEET_TRANSITIONS = 256


def _replica_key(prefix, replica_id):
    return f"{prefix}/replica_{int(replica_id)}"


class SLOStatusPublisher(StorePublisher):
    """Publish one engine's ``/slo`` status under its fleet key.

    ``publish()`` pushes once; ``start(interval_s)`` runs the inherited
    daemon loop.  The payload is exactly :meth:`~.slo.SLOEngine.status`
    plus the replica id and a wall-clock stamp for staleness
    filtering."""

    def __init__(self, engine, replica_id, store, key_prefix="slo",
                 clock=None):
        super().__init__(store, _replica_key(key_prefix, replica_id),
                         clock=clock)
        self.engine = engine
        self.replica_id = int(replica_id)
        self.thread_name = f"slo-gossip-{self.replica_id}"

    def payload(self):
        return {"replica": self.replica_id, "time": self._clock(),
                "status": self.engine.status()}


def collect_slo_statuses(store, replica_ids, key_prefix="slo",
                         stale_after_s=None, clock=None):
    """Read every replica's published status in ONE ``mget`` round
    trip.  Returns ``[(source_label, status)]`` pairs.  Replicas that
    never published, published garbage, or whose stamp is older than
    ``stale_after_s`` (publisher wall clock) are simply absent.
    Non-blocking by construction: a scrape never waits on a slow
    store."""
    replica_ids = list(replica_ids)
    keys = [_replica_key(key_prefix, r) for r in replica_ids]
    out = []
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
        status = payload.get("status")
        if isinstance(status, dict):
            out.append((f"replica{int(rid)}", status))
    return out


def merge_fleet_slo(statuses):
    """Fold ``[(source_label, status)]`` pairs into the
    ``/slo?fleet=1`` payload (see the module docstring for the
    semantics)."""
    replicas, objectives, transitions = {}, {}, []
    page_active = False
    for label, status in statuses:
        page = bool(status.get("page_active"))
        page_active = page_active or page
        replicas[label] = {
            "page_active": page,
            "evaluations": status.get("evaluations"),
        }
        for name, spec in (status.get("slos") or {}).items():
            obj = objectives.get(name)
            if obj is None:
                obj = objectives[name] = {
                    "target": spec.get("target"),
                    "description": spec.get("description"),
                    "replicas": {},
                    "error_budget_ratio": None,
                    "alerts_active": [],
                }
            last = spec.get("last") or {}
            budget = last.get("error_budget_ratio")
            obj["replicas"][label] = {
                "burn_rates": last.get("burn_rates"),
                "error_budget_ratio": budget,
            }
            if budget is not None:
                worst = obj["error_budget_ratio"]
                if worst is None or budget < worst:
                    obj["error_budget_ratio"] = budget
            for alert in spec.get("alerts") or ():
                if alert.get("active"):
                    obj["alerts_active"].append(
                        {"replica": label,
                         "severity": alert.get("severity"),
                         "since": alert.get("since")})
        for tr in status.get("transitions") or ():
            transitions.append(dict(tr, replica=label))
    transitions.sort(key=lambda tr: tr.get("time") or 0.0)
    return {"fleet": True,
            "replicas": dict(sorted(replicas.items())),
            "page_active": page_active,
            "slos": dict(sorted(objectives.items())),
            "transitions": transitions[-_MAX_FLEET_TRANSITIONS:]}


def collect_fleet_slo(store, replica_ids, key_prefix="slo",
                      stale_after_s=None, clock=None, extra=()):
    """The fleet view: every replica's published status merged by
    objective (:func:`merge_fleet_slo`).  ``extra`` appends in-process
    statuses — e.g. ``[("rank0", engine.status())]`` so the collector
    rank's own objectives land in the same fold without a store round
    trip."""
    statuses = collect_slo_statuses(store, replica_ids,
                                    key_prefix=key_prefix,
                                    stale_after_s=stale_after_s,
                                    clock=clock)
    return merge_fleet_slo(list(extra) + statuses)
