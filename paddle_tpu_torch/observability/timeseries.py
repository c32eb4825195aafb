"""In-process time-series store — windowed history over the registry
(the port of ``paddle_tpu/observability/timeseries.py``).

Every consumer of fleet telemetry so far (the autoscaler, the soak
assertions, ``/healthz``, a human scraping ``/fleet``) reads the
MetricsRegistry *instantaneously*: there is no history, no windowed
rate, and no way to ask "what was TTFT p99 over the last 60 s" as
opposed to "over the whole process lifetime".  The
:class:`TimeSeriesStore` closes that gap with a fixed-budget in-process
ring:

- **scrape, don't instrument**: :meth:`scrape_once` walks the attached
  :class:`~.metrics.MetricsRegistry` and appends one ``(timestamp,
  value)`` point per live series — counters and gauges by value,
  histograms by their full cumulative bucket vector — onto a bounded
  per-series deque (``max_points`` newest points, ``retention_s``
  newest seconds, ``max_series`` series total: the budget is fixed no
  matter how long the process runs).
- **counter-reset detection**: ``ServingMetrics`` (and friends) rebuild
  with ``register(replace=True)``, so a raw counter can go *backwards*
  between scrapes.  The store keeps a per-series monotonic adjustment:
  a scraped value below the previous one means the series restarted
  from zero, the previous value is folded into a base offset, and every
  stored point carries the *adjusted* cumulative value — windowed
  deltas stay non-negative across an engine rebuild mid-soak.
- **windowed queries** on an injectable clock: :meth:`rate` /
  :meth:`delta` (counters, summed across a label family),
  :meth:`avg` / :meth:`slope` (gauges — ``slope`` is the least-squares
  per-second trend that answers "when did memory start growing"), and
  :meth:`quantile` (histogram-bucket deltas over the window with
  linear interpolation inside the crossing bucket — the Prometheus
  ``histogram_quantile`` shape), so "TTFT p99 over the last 60 s"
  exists distinct from the lifetime reservoir percentile.
- **opt-in thread** (the ResourceSampler/StorePublisher discipline):
  nothing starts on import or construction; :meth:`start` runs
  :meth:`scrape_once` on a daemon thread, tests and the soak harness
  drive it synchronously on a manual clock.

The store powers the :mod:`.slo` engine's burn-rate windows, the
``/timeseries`` exporter endpoint, and the autoscaler's windowed
shed/goodput signals (replacing its ad-hoc between-poll counter
deltas).
"""
from __future__ import annotations

import threading
import time

from .metrics import default_registry

__all__ = ["TimeSeriesStore"]


class _Series:
    """One scraped series: the bounded point ring plus the reset
    bookkeeping that keeps counter/histogram points monotonic.  All
    fields are guarded by the owning store's lock."""

    __slots__ = ("kind", "points", "resets",
                 "last_value", "offset",
                 "buckets", "last_counts", "last_total", "last_sum",
                 "offset_counts", "offset_total", "offset_sum")

    def __init__(self, kind):
        self.kind = kind
        self.points = []        # guarded-by: store._lock
        self.resets = 0         # guarded-by: store._lock
        # counters/gauges
        self.last_value = None  # guarded-by: store._lock
        self.offset = 0.0       # guarded-by: store._lock
        # histograms
        self.buckets = None     # guarded-by: store._lock
        self.last_counts = None     # guarded-by: store._lock
        self.last_total = 0     # guarded-by: store._lock
        self.last_sum = 0.0     # guarded-by: store._lock
        self.offset_counts = None   # guarded-by: store._lock
        self.offset_total = 0   # guarded-by: store._lock
        self.offset_sum = 0.0   # guarded-by: store._lock


class TimeSeriesStore:
    """Fixed-budget ring of scraped registry samples with windowed
    queries.

    ``registry`` defaults to the process-wide one; ``clock`` is
    injectable (tests and the soak drive the store on a manual clock).
    ``max_points`` bounds every series' ring, ``retention_s`` drops
    points older than the window anyone can query, ``max_series``
    bounds the series population (new series beyond it are counted in
    ``dropped_series``, never stored — the budget is fixed)."""

    def __init__(self, registry=None, clock=None, *, interval_s=1.0,
                 max_points=512, retention_s=600.0, max_series=1024):
        self.registry = registry or default_registry()
        self._clock = clock or time.perf_counter
        self.interval_s = float(interval_s)
        self.max_points = int(max_points)
        self.retention_s = float(retention_s)
        self.max_series = int(max_series)
        # the scrape thread mutates, query/exporter threads read — one
        # lock guards all mutable store state.  Taken AFTER the
        # registry/metric locks are released (scrape reads child values
        # first, then appends under the store lock) and never while
        # calling out, so no ordering cycle exists.
        self._lock = threading.Lock()
        self._series = {}       # (name, labelvalues) -> _Series; guarded-by: self._lock
        self._families = {}     # name -> {kind, labelnames, keys}; guarded-by: self._lock
        self._scrapes = 0       # guarded-by: self._lock
        self._dropped_series = 0    # guarded-by: self._lock
        self._thread = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- scrape
    def scrape_once(self):
        """Walk the registry, append one timestamped point per series
        (reset-adjusted), trim to budget.  Returns the number of series
        touched."""
        self.registry._run_collectors()
        now = self._clock()
        # read every child's value OUTSIDE the store lock (metric locks
        # are taken by .value / the histogram copy), then publish the
        # batch under one store-lock hold
        batch = []
        for m in self.registry.metrics():
            for lv, child in m._series():
                if m.kind == "histogram":
                    with child._lock:
                        val = (list(child.counts), child.total,
                               child.sum, list(child.buckets))
                else:
                    val = child.value
                batch.append((m.name, m.kind, tuple(m.labelnames),
                              lv, val))
        with self._lock:
            for name, kind, labelnames, lv, val in batch:
                self._record_locked(now, name, kind, labelnames, lv, val)
            self._scrapes += 1
            return len(batch)

    def _record_locked(self, now, name, kind, labelnames, lv, val):
        key = (name, lv)
        ser = self._series.get(key)
        if ser is None:
            if len(self._series) >= self.max_series:
                self._dropped_series += 1
                return
            ser = self._series[key] = _Series(kind)
            fam = self._families.setdefault(
                name, {"kind": kind, "labelnames": labelnames,
                       "keys": []})
            fam["keys"].append(key)
        if kind == "counter":
            raw = float(val)
            if ser.last_value is not None and raw < ser.last_value:
                # series replaced (register(replace=True)): it restarted
                # from zero — fold the pre-reset value into the offset
                # so the adjusted cumulative stays monotonic
                ser.offset += ser.last_value
                ser.resets += 1
            ser.last_value = raw
            ser.points.append((now, ser.offset + raw))
        elif kind == "histogram":
            counts, total, hsum, buckets = val
            if ser.buckets is None or len(ser.buckets) != len(buckets):
                # first sight, or a rebuild changed the bucket layout:
                # restart the adjustment bookkeeping on the new shape
                if ser.buckets is not None:
                    ser.resets += 1
                ser.buckets = list(buckets)
                ser.offset_counts = [0] * len(counts)
                ser.last_counts = None
            if ser.last_counts is not None and total < ser.last_total:
                ser.resets += 1
                for i, c in enumerate(ser.last_counts):
                    ser.offset_counts[i] += c
                ser.offset_total += ser.last_total
                ser.offset_sum += ser.last_sum
            ser.last_counts = counts
            ser.last_total = total
            ser.last_sum = hsum
            adj = tuple(o + c for o, c in zip(ser.offset_counts, counts))
            ser.points.append((now, adj, ser.offset_total + total,
                               ser.offset_sum + hsum))
        else:                           # gauge
            ser.last_value = float(val)
            ser.points.append((now, ser.last_value))
        pts = ser.points
        if len(pts) > self.max_points:
            del pts[:len(pts) - self.max_points]
        cutoff = now - self.retention_s
        drop = 0
        while drop < len(pts) and pts[drop][0] < cutoff:
            drop += 1
        if drop:
            del pts[:drop]

    # ------------------------------------------------------------ queries
    def _resolve_locked(self, name, labels):
        """[(key, _Series)] the query covers: the single child matching
        ``labels``, or every series of the family when ``labels`` is
        None (counter/histogram queries sum across the family)."""
        fam = self._families.get(name)
        if fam is None:
            return []
        if labels is None:
            return [(k, self._series[k]) for k in fam["keys"]]
        labelnames = fam["labelnames"]
        if set(labels) != set(labelnames):
            raise ValueError(f"{name} expects labels {labelnames}, "
                             f"got {tuple(labels)}")
        key = (name, tuple(str(labels[k]) for k in labelnames))
        ser = self._series.get(key)
        return [(key, ser)] if ser is not None else []

    @staticmethod
    def _window_start_locked(ser, now, window_s):
        """Index of the first point with ``t >= now - window_s``
        (binary search on the monotonic timestamps — every burn-rate
        window query walks through here)."""
        cutoff = now - window_s
        pts = ser.points
        lo, hi = 0, len(pts)
        while lo < hi:
            mid = (lo + hi) // 2
            if pts[mid][0] < cutoff:
                lo = mid + 1
            else:
                hi = mid
        return lo

    @classmethod
    def _window_locked(cls, ser, now, window_s):
        """The series' points with ``t >= now - window_s``."""
        return ser.points[cls._window_start_locked(ser, now, window_s):]

    def delta(self, name, labels=None, window_s=60.0):
        """Counter increase over the window (reset-adjusted; summed
        across the label family when ``labels`` is None).  None until
        two scrapes fall inside the window."""
        now = self._clock()
        with self._lock:
            total, seen = 0.0, False
            for _key, ser in self._resolve_locked(name, labels):
                pts = ser.points
                lo = self._window_start_locked(ser, now, window_s)
                if len(pts) - lo < 2:
                    continue
                idx = 2 if ser.kind == "histogram" else 1
                total += pts[-1][idx] - pts[lo][idx]
                seen = True
            return total if seen else None

    def rate(self, name, labels=None, window_s=60.0):
        """Per-second increase over the window — per-series
        ``delta / elapsed`` summed across the family (the
        ``sum(rate(...))`` shape).  None until two scrapes fall inside
        the window."""
        now = self._clock()
        with self._lock:
            total, seen = 0.0, False
            for _key, ser in self._resolve_locked(name, labels):
                pts = ser.points
                lo = self._window_start_locked(ser, now, window_s)
                if len(pts) - lo < 2 or pts[-1][0] <= pts[lo][0]:
                    continue
                idx = 2 if ser.kind == "histogram" else 1
                total += ((pts[-1][idx] - pts[lo][idx])
                          / (pts[-1][0] - pts[lo][0]))
                seen = True
            return total if seen else None

    def avg(self, name, labels=None, window_s=60.0):
        """Mean of a gauge's samples in the window (one series — pass
        ``labels`` for a family child).  None with no samples."""
        now = self._clock()
        with self._lock:
            sers = self._resolve_locked(name, labels)
            if len(sers) != 1:
                if not sers:
                    return None
                raise ValueError(
                    f"avg({name!r}) is ambiguous across "
                    f"{len(sers)} series — pass labels")
            pts = self._window_locked(sers[0][1], now, window_s)
            vals = [p[1] for p in pts]
            return sum(vals) / len(vals) if vals else None

    def slope(self, name, labels=None, window_s=60.0):
        """Least-squares per-second trend of a gauge over the window —
        the "when did memory start growing" query.  None until two
        distinct-time samples fall inside the window."""
        now = self._clock()
        with self._lock:
            sers = self._resolve_locked(name, labels)
            if len(sers) != 1:
                if not sers:
                    return None
                raise ValueError(
                    f"slope({name!r}) is ambiguous across "
                    f"{len(sers)} series — pass labels")
            pts = self._window_locked(sers[0][1], now, window_s)
        if len(pts) < 2:
            return None
        t0 = pts[0][0]
        ts = [p[0] - t0 for p in pts]
        vs = [float(p[1]) for p in pts]
        n = len(pts)
        mt = sum(ts) / n
        mv = sum(vs) / n
        var = sum((t - mt) ** 2 for t in ts)
        if var == 0.0:
            return None
        return sum((t - mt) * (v - mv) for t, v in zip(ts, vs)) / var

    def latest(self, name, labels=None):
        """Newest stored value of one series (counters: the
        reset-adjusted cumulative).  None if never scraped."""
        with self._lock:
            sers = self._resolve_locked(name, labels)
            if len(sers) != 1 or not sers[0][1].points:
                return None
            ser = sers[0][1]
            p = ser.points[-1]
            return p[2] if ser.kind == "histogram" else p[1]

    def quantile(self, name, p, labels=None, window_s=60.0):
        """Histogram quantile (``p`` in 0..100, matching
        ``Histogram.percentile``) over the bucket-count *deltas* inside
        the window — the windowed TTFT p99, distinct from the lifetime
        reservoir.  Linear interpolation inside the crossing bucket
        (the ``histogram_quantile`` convention); observations above the
        top bucket clamp to its upper bound.  Summed across the family
        when ``labels`` is None; None until two scrapes with traffic
        between them fall inside the window."""
        now = self._clock()
        with self._lock:
            sers = [(k, s) for k, s in self._resolve_locked(name, labels)
                    if s.kind == "histogram"]
            buckets = None
            counts_delta = None
            total_delta = 0
            for _key, ser in sers:
                pts = ser.points
                lo_i = self._window_start_locked(ser, now, window_s)
                if len(pts) - lo_i < 2:
                    continue
                first, last = pts[lo_i], pts[-1]
                if buckets is None:
                    buckets = list(ser.buckets)
                    counts_delta = [0] * len(first[1])
                elif list(ser.buckets) != buckets or \
                        len(first[1]) != len(counts_delta):
                    continue        # mismatched layout: skip, don't lie
                for i in range(len(counts_delta)):
                    counts_delta[i] += last[1][i] - first[1][i]
                total_delta += last[2] - first[2]
        if buckets is None or total_delta <= 0:
            return None
        rank = p / 100.0 * total_delta
        cum = 0
        for i, ub in enumerate(buckets):
            c = counts_delta[i]
            if c and cum + c >= rank:
                lo = buckets[i - 1] if i > 0 else 0.0
                return lo + (ub - lo) * (rank - cum) / c
            cum += c
        return buckets[-1]

    def good_below(self, name, threshold, labels=None, window_s=60.0):
        """``(good, total)`` observation deltas over the window for a
        histogram: ``good`` counts observations in buckets whose upper
        bound is at or under ``threshold`` (the snap-down is
        conservative — an observation between the last included bound
        and the threshold reads as bad, never the reverse).  The
        latency-SLO primitive: ``good/total ≥ target`` is "p(target)
        under the threshold" in budget-burnable form.  Summed across
        the family when ``labels`` is None; ``(0, 0)`` until two
        scrapes fall inside the window."""
        now = self._clock()
        with self._lock:
            good = total = 0.0
            for _key, ser in self._resolve_locked(name, labels):
                if ser.kind != "histogram":
                    continue
                pts = ser.points
                lo = self._window_start_locked(ser, now, window_s)
                if len(pts) - lo < 2:
                    continue
                first, last = pts[lo], pts[-1]
                total += last[2] - first[2]
                for i, ub in enumerate(ser.buckets):
                    if ub <= threshold * (1.0 + 1e-9):
                        good += last[1][i] - first[1][i]
            return good, total

    # ------------------------------------------------------------ surface
    def query(self, name, labels=None, window_s=60.0):
        """Everything the store can say about one name over the window
        — the ``/timeseries?name=...`` payload."""
        with self._lock:
            fam = self._families.get(name)
            kind = fam["kind"] if fam else None
        out = {"name": name, "kind": kind,
               "window_seconds": float(window_s)}
        if kind is None:
            return out
        if kind == "gauge":
            out["latest"] = self.latest(name, labels)
            out["avg"] = self.avg(name, labels, window_s)
            out["slope_per_s"] = self.slope(name, labels, window_s)
        elif kind == "counter":
            out["latest"] = self.latest(name, labels)
            out["delta"] = self.delta(name, labels, window_s)
            out["rate_per_s"] = self.rate(name, labels, window_s)
        else:
            out["count_delta"] = self.delta(name, labels, window_s)
            out["rate_per_s"] = self.rate(name, labels, window_s)
            out["p50"] = self.quantile(name, 50, labels, window_s)
            out["p99"] = self.quantile(name, 99, labels, window_s)
        return out

    def stats(self):
        """The ``/timeseries`` summary payload: the fixed budget and
        how much of it is in use, plus per-series shape (no raw
        points — scrape :meth:`query` for values)."""
        with self._lock:
            series = []
            for (name, lv), ser in sorted(self._series.items()):
                labelnames = self._families[name]["labelnames"]
                series.append({
                    "name": name, "kind": ser.kind,
                    "labels": dict(zip(labelnames, lv)),
                    "points": len(ser.points),
                    "resets": ser.resets,
                    "first_t": ser.points[0][0] if ser.points else None,
                    "last_t": ser.points[-1][0] if ser.points else None,
                })
            return {
                "scrapes": self._scrapes,
                "series": len(self._series),
                "points": sum(len(s.points)
                              for s in self._series.values()),
                "resets": sum(s.resets for s in self._series.values()),
                "dropped_series": self._dropped_series,
                "budget": {"max_points": self.max_points,
                           "retention_seconds": self.retention_s,
                           "max_series": self.max_series},
                "names": series,
            }

    # ------------------------------------------------------------- thread
    def start(self, interval_s=None):
        """Scrape on a daemon thread every ``interval_s`` (default: the
        constructor's).  Strictly opt-in — nothing starts on import or
        construction; the soak harness and tests drive
        :meth:`scrape_once` inline instead."""
        if self._thread is not None:
            return self
        beat = float(interval_s if interval_s is not None
                     else self.interval_s)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, args=(beat,),
                                        name="timeseries-store",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self, interval_s):
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:
                pass    # silent-ok: a flaky scrape must not kill the
                #         loop; the next beat re-reads live state
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
