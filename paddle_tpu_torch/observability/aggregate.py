"""Cross-rank metric aggregation — fleet-wide /metrics from one scrape
(the port of ``paddle_tpu/observability/aggregate.py``).

Every rank of a world publishes its registry into the rendezvous
store the world already has (``distributed/store.py``'s ``TCPStore``):

- :class:`StorePublisher` — the shared machinery: one JSON payload
  under one store key a rank, overwritten in place, ``publish()`` now
  or ``start(interval_s)`` on a daemon thread that survives a flaky
  store.  The hang watchdog's heartbeats (:mod:`.flight`) ride it too.
- :class:`RankMetricsPublisher` — a rank's ``MetricsRegistry``
  snapshot, wall-clock stamped, under ``metrics/rank_<r>``.
- :class:`ClusterAggregator` — rank 0 (or any process with a store
  client) merges the snapshots: every series gets a ``rank="<r>"``
  label in the merged Prometheus text, ranks whose snapshot is older
  than ``stale_after_s`` age out of the merge, and the straggler signal
  ``training_step_time_skew_seconds`` (max − min of the per-rank mean
  of ``training_step_seconds``) is recomputed on every collect.

Histograms travel as their snapshot summaries (count/mean/quantiles),
so the merged exposition renders them as Prometheus *summary* series
(``{quantile="0.5"}`` + ``_sum``/``_count``).  The text is the JAX
package's for the same published payloads.
"""
from __future__ import annotations

import json
import threading
import time

from .metrics import _fmt_labels, _prom_line, _prom_name, default_registry

__all__ = ["StorePublisher", "RankMetricsPublisher", "ClusterAggregator"]


def _rank_key(prefix, rank):
    return f"{prefix}/rank_{int(rank)}"


class StorePublisher:
    """Publish a JSON payload under one TCPStore key, now or on a timer.

    The shared machinery behind every per-rank publisher riding the
    rendezvous plane (metric snapshots here, the flight recorder's hang
    heartbeats in :mod:`.flight`): one key per rank overwritten in
    place, ``publish()`` for a one-shot push, ``start(interval_s)`` for
    a daemon thread that calls :meth:`tick` periodically and survives a
    flaky store.  Strictly opt-in — constructing a publisher touches
    nothing.  Subclasses implement :meth:`payload` (and may override
    :meth:`tick` to do more than publish per beat)."""

    thread_name = "store-publisher"

    def __init__(self, store, key, clock=None):
        self.store = store
        self.key = key
        self._clock = clock or time.time
        self._thread = None
        self._stop = threading.Event()
        self.published = 0

    def payload(self):
        raise NotImplementedError

    def publish(self):
        payload = self.payload()
        self.store.set(self.key, json.dumps(payload))
        self.published += 1
        return payload

    def tick(self):
        """One timer beat (the thread's body); default = one publish."""
        self.publish()

    # ---- thread ---------------------------------------------------------
    def start(self, interval_s=5.0):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, args=(float(interval_s),),
            name=self.thread_name, daemon=True)
        self._thread.start()
        return self

    @property
    def running(self):
        return self._thread is not None

    def _run(self, interval_s):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                pass    # silent-ok: a flaky store must not kill training
            self._stop.wait(interval_s)

    def stop(self):
        t, self._thread = self._thread, None
        if t is not None:
            self._stop.set()
            t.join(timeout=5.0)
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class RankMetricsPublisher(StorePublisher):
    """Publish this rank's registry snapshot into the TCPStore.

    The payload carries a wall-clock stamp the aggregator uses for
    staleness, so publisher and aggregator clocks must be comparable
    (NTP-synced hosts; tests inject clocks)."""

    def __init__(self, store, rank, registry=None, key_prefix="metrics",
                 clock=None):
        super().__init__(store, _rank_key(key_prefix, rank), clock=clock)
        self.rank = int(rank)
        self.registry = registry or default_registry()
        self.thread_name = f"metrics-publisher-{self.rank}"

    def payload(self):
        return {"rank": self.rank, "time": self._clock(),
                "metrics": self.registry.snapshot()}


def _scalar_of(value):
    """Best scalar reading of one snapshot value (gauge dict → current,
    histogram summary → mean, counter → itself)."""
    if isinstance(value, dict):
        for key in ("current", "mean", "p50"):
            if value.get(key) is not None:
                return float(value[key])
        return None
    return float(value) if value is not None else None


class ClusterAggregator:
    """Merge per-rank snapshots from the store (rank-0 side).

    ``collect()`` is the one I/O step: it mgets every rank's key,
    drops stale/missing ranks (recorded in ``self.stale_ranks`` /
    ``self.missing_ranks``), recomputes the skew gauge and returns
    ``{rank: payload}``.  ``expose_prometheus()`` /
    ``merged_snapshot()`` render the newest collect for the exporter.
    """

    def __init__(self, store, world_size, stale_after_s=30.0,
                 registry=None, key_prefix="metrics",
                 skew_metric="training_step_seconds", clock=None):
        self.store = store
        self.world_size = int(world_size)
        self.stale_after_s = float(stale_after_s)
        # fleet-level gauges (skew, rank counts) land in this LOCAL
        # registry — rank 0's own — so they also ride its next publish
        self.registry = registry or default_registry()
        self.key_prefix = key_prefix
        self.skew_metric = skew_metric
        self._clock = clock or time.time
        # one lock, two jobs: serializes TCPStore client use AND makes
        # (stale_ranks, missing_ranks, last_skew_s, _last) one
        # consistent unit — the exporter's HTTP threads call
        # merged_snapshot()/expose_prometheus() while a collect() is
        # mid-update, and a torn combination (fresh _last with stale
        # rank lists) used to be observable
        self._lock = threading.Lock()
        self.stale_ranks = []           # guarded-by: self._lock
        self.missing_ranks = []         # guarded-by: self._lock
        self.last_skew_s = None         # guarded-by: self._lock
        self._last = {}                 # guarded-by: self._lock

    # ---- collection -----------------------------------------------------
    def _fetch_raw(self):
        keys = [_rank_key(self.key_prefix, r)
                for r in range(self.world_size)]
        if hasattr(self.store, "mget"):
            return self.store.mget(keys, value_size_hint=1 << 16)
        out = []
        for k in keys:
            try:
                out.append(self.store.get(k, blocking=False))
            except KeyError:
                out.append(None)
        return out

    def collect(self):
        """Fetch + filter every rank's latest snapshot; returns
        ``{rank: payload}`` of the fresh ones."""
        with self._lock:
            raw = self._fetch_raw()
        now = self._clock()
        fresh, stale, missing = {}, [], []
        for rank, blob in enumerate(raw):
            if blob is None:
                missing.append(rank)
                continue
            try:
                payload = json.loads(blob)
            except ValueError:
                stale.append(rank)
                continue
            if now - payload.get("time", 0.0) > self.stale_after_s:
                stale.append(rank)
                continue
            fresh[rank] = payload
        skew = self._skew_of(fresh)
        with self._lock:
            self.stale_ranks, self.missing_ranks = stale, missing
            self.last_skew_s = skew
            self._last = fresh
        self._publish_fleet_gauges(fresh, stale, missing, skew)
        return fresh

    def _state(self):
        """One consistent point-in-time read of the last collect."""
        with self._lock:
            return (self._last, self.stale_ranks, self.missing_ranks,
                    self.last_skew_s)

    def _rank_step_means(self, fresh):
        out = {}
        for rank, payload in fresh.items():
            entry = payload.get("metrics", {}).get(self.skew_metric)
            if not entry or "value" not in entry:
                continue
            v = _scalar_of(entry["value"])
            if v is not None:
                out[rank] = v
        return out

    def _skew_of(self, fresh):
        means = self._rank_step_means(fresh)
        return (max(means.values()) - min(means.values())
                if len(means) >= 2 else None)

    def _publish_fleet_gauges(self, fresh, stale, missing, skew):
        reg = self.registry
        if skew is not None:
            reg.gauge(
                "training_step_time_skew_seconds",
                "max - min of per-rank mean step time (straggler skew)"
            ).set(skew)
        reg.gauge("cluster_ranks_reporting",
                  "ranks with a fresh metrics snapshot").set(len(fresh))
        reg.gauge("cluster_ranks_stale",
                  "ranks whose snapshot aged out (or never arrived)"
                  ).set(len(stale) + len(missing))

    # ---- rendering ------------------------------------------------------
    def merged_snapshot(self, collect=True):
        """JSON-able fleet view: per-rank snapshots + staleness + skew
        (the telemetry server's ``/varz`` embeds this as ``cluster``)."""
        if collect:
            self.collect()
        fresh, stale, missing, skew = self._state()
        return {
            "world_size": self.world_size,
            "ranks": {str(r): p for r, p in sorted(fresh.items())},
            "stale_ranks": stale,
            "missing_ranks": missing,
            "step_time_skew_seconds": skew,
            "per_rank_step_mean_s": {
                str(r): v
                for r, v in sorted(self._rank_step_means(fresh).items())},
        }

    def expose_prometheus(self, collect=True):
        """Fleet-wide Prometheus text exposition, every series labelled
        ``rank="<r>"``.  Histogram snapshots render as summaries."""
        if collect:
            self.collect()
        fresh, stale, missing, skew = self._state()
        kinds, order = {}, []
        for _, payload in sorted(fresh.items()):
            for name, entry in payload.get("metrics", {}).items():
                if name not in kinds:
                    kinds[name] = entry.get("type", "untyped")
                    order.append(name)
        lines = []
        for name in order:
            kind = kinds[name]
            pname = _prom_name(name)
            lines.append(f"# HELP {pname} {name} (merged across ranks)")
            lines.append(f"# TYPE {pname} "
                         f"{'summary' if kind == 'histogram' else kind}")
            for rank, payload in sorted(fresh.items()):
                entry = payload.get("metrics", {}).get(name)
                if entry is None or entry.get("type") != kind:
                    continue    # one name, one kind; mismatches dropped
                for labels, value in self._series_of(entry, rank):
                    lines.extend(self._render(pname, kind, labels, value))
        lines.extend(
            self._fleet_lines(set(order), fresh, stale, missing, skew))
        return "\n".join(lines) + "\n"

    @staticmethod
    def _series_of(entry, rank):
        if "series" in entry:
            for s in entry["series"]:
                kv = {"rank": str(rank), **s.get("labels", {})}
                yield _fmt_labels(kv.keys(), kv.values()), s.get("value")
        else:
            yield f'rank="{rank}"', entry.get("value")

    @staticmethod
    def _render(pname, kind, labels, value):
        if kind == "gauge" and isinstance(value, dict):
            out = []
            if value.get("current") is not None:
                out.append(_prom_line(pname, labels, value["current"]))
            if value.get("peak") is not None:
                out.append(_prom_line(pname + "_peak", labels,
                                      value["peak"]))
            return out
        if kind == "histogram" and isinstance(value, dict):
            out = []
            count = value.get("count") or 0
            for q, key in (("0.5", "p50"), ("0.95", "p95"),
                           ("0.99", "p99")):
                v = value.get(key)
                if v is not None:
                    out.append(_prom_line(
                        pname, labels + f',quantile="{q}"', v))
            mean = value.get("mean")
            out.append(_prom_line(pname + "_sum", labels,
                                  (mean or 0.0) * count))
            out.append(_prom_line(pname + "_count", labels, count))
            return out
        if isinstance(value, (int, float)):
            return [_prom_line(pname, labels, value)]
        return []

    def _fleet_lines(self, seen_names, fresh, stale, missing, skew):
        """Fleet-level series (no rank label) appended after the merge —
        fresh from THIS collect, not one publish interval behind.  TYPE
        lines are skipped for names the merge already declared (rank 0
        republishes the fleet gauges from its local registry)."""
        lines = []
        fleet = [("training_step_time_skew_seconds", skew),
                 ("cluster_ranks_reporting", len(fresh)),
                 ("cluster_ranks_stale", len(stale) + len(missing))]
        for name, value in fleet:
            if value is None:
                continue
            if name not in seen_names:
                lines.append(f"# TYPE {name} gauge")
            lines.append(_prom_line(name, "", value))
        return lines
