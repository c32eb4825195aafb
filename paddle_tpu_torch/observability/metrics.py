"""Framework-wide metrics: Counter / Gauge / Histogram + MetricsRegistry
(the port of ``paddle_tpu/observability/metrics.py``).

- **thread-safe**: the serving engine and the fleet router mutate
  metrics on the driving thread while an operator thread reads them;
  every mutation and every read takes the metric's lock.
- **labels**: a metric constructed with ``labelnames`` is a *family*;
  ``m.labels(replica="0")`` returns (creating on first use) the child
  carrying those label values.  Unlabelled metrics keep the scalar API
  (``inc``/``set``/``observe`` directly).
- **process-wide default registry** (``default_registry()``): named
  singletons with get-or-create semantics (``registry.counter(name)``)
  and replace-on-re-register, so a subsystem that rebuilds its metrics
  swaps the old series out of the snapshot.
- ``snapshot()`` → a JSON-able dict of every series; ``gauges()`` →
  every gauge series by name, which the profiler samples into its
  chrome-trace counter tracks; ``expose_prometheus()`` → the Prometheus
  text format (cumulative ``_bucket{le=...}`` + ``_sum``/``_count`` for
  histograms, OpenMetrics exemplars), the JAX package's text byte for
  byte for the same registry contents.  Scrape collectors run at the
  top of both expositions.
"""
from __future__ import annotations

import bisect
import math
import re
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry"]


def _fmt_labels(labelnames, labelvalues):
    return ",".join(f'{k}="{v}"' for k, v in zip(labelnames, labelvalues))


class _Metric:
    """Shared family/child machinery.  A child is an instance of the same
    class with ``labelnames=()`` and ``_labelvalues`` set."""

    kind = "untyped"

    def __init__(self, name, help="", labelnames=()):  # noqa: A002
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._labelvalues = ()
        self._children = {}     # guarded-by: self._lock
        self._lock = threading.Lock()

    # ---- family surface -------------------------------------------------
    def labels(self, **kw):
        if not self.labelnames:
            raise ValueError(f"{self.name} was created without labelnames")
        if set(kw) != set(self.labelnames):
            raise ValueError(f"{self.name} expects labels "
                             f"{self.labelnames}, got {tuple(kw)}")
        key = tuple(str(kw[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                child._labelvalues = key
                self._children[key] = child
            return child

    def _make_child(self):
        return type(self)(self.name, self.help)

    def _series(self):
        """[(labelvalues, child)] — the family's children, or self when
        unlabelled."""
        if self.labelnames:
            with self._lock:
                return sorted(self._children.items())
        return [((), self)]

    def _check_scalar(self, op):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call "
                f".labels(...).{op}()")


class Counter(_Metric):
    """Monotonic event counter."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):  # noqa: A002
        super().__init__(name, help, labelnames)
        self._value = 0         # guarded-by: self._lock

    def inc(self, n=1):
        self._check_scalar("inc")
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def snapshot_value(self):
        return self.value


class Gauge(_Metric):
    """Last-value gauge that also tracks its peak."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):  # noqa: A002
        super().__init__(name, help, labelnames)
        self._value = 0.0       # guarded-by: self._lock
        self._peak = 0.0        # guarded-by: self._lock

    def set(self, v):
        self._check_scalar("set")
        with self._lock:
            self._value = float(v)
            self._peak = max(self._peak, self._value)

    def inc(self, n=1):
        self._check_scalar("inc")
        with self._lock:
            self._value += n
            self._peak = max(self._peak, self._value)

    def dec(self, n=1):
        self._check_scalar("dec")
        with self._lock:
            self._value -= n

    @property
    def value(self):
        with self._lock:
            return self._value

    @property
    def peak(self):
        with self._lock:
            return self._peak

    def snapshot_value(self):
        with self._lock:
            return {"current": self._value, "peak": self._peak}


class Histogram(_Metric):
    """Log-bucketed histogram with exact bounded-reservoir percentiles
    (the reservoir keeps the newest ``reservoir`` samples — telemetry
    should reflect current behavior, not cold-start)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), start=1e-4,
                 factor=2.0, count=20, reservoir=2048):  # noqa: A002
        super().__init__(name, help, labelnames)
        self._bucket_args = (start, factor, count, reservoir)
        self.buckets = [start * factor ** i for i in range(count)]
        self.counts = [0] * (count + 1)  # overflow bucket; guarded-by: self._lock
        self.total = 0          # guarded-by: self._lock
        self.sum = 0.0          # guarded-by: self._lock
        self._reservoir = reservoir
        self._samples = []      # guarded-by: self._lock
        # bucket index -> (exemplar trace_id, observed value): the last
        # exemplar-carrying observation per bucket, so the exposition
        # links each latency band to a concrete retained trace
        self._exemplars = {}    # guarded-by: self._lock

    def _make_child(self):
        start, factor, count, reservoir = self._bucket_args
        return type(self)(self.name, self.help, start=start, factor=factor,
                          count=count, reservoir=reservoir)

    def observe(self, v, exemplar=None):
        """Record ``v``; ``exemplar`` (a trace_id string, or None) pins
        this observation as the bucket's exemplar — the OpenMetrics
        ``# {trace_id="..."} v`` annotation that lets a p99 spike be
        followed to one retained trace."""
        self._check_scalar("observe")
        v = float(v)
        with self._lock:
            idx = bisect.bisect_left(self.buckets, v)
            self.counts[idx] += 1
            self.total += 1
            self.sum += v
            self._samples.append(v)
            if len(self._samples) > self._reservoir:
                del self._samples[:len(self._samples) - self._reservoir]
            if exemplar is not None:
                self._exemplars[idx] = (str(exemplar), v)

    def exemplars(self):
        """{bucket_le: {"trace_id", "value"}} — the newest exemplar per
        bucket (``le`` is the bucket's upper bound as a string,
        ``"+Inf"`` for the overflow bucket)."""
        with self._lock:
            ex = dict(self._exemplars)
        out = {}
        for idx, (tid, v) in sorted(ex.items()):
            le = (f"{self.buckets[idx]:g}" if idx < len(self.buckets)
                  else "+Inf")
            out[le] = {"trace_id": tid, "value": v}
        return out

    @property
    def mean(self):
        with self._lock:
            return self.sum / self.total if self.total else 0.0

    @staticmethod
    def _pct(sorted_samples, p):
        if not sorted_samples:
            return None
        n = len(sorted_samples)
        idx = min(n - 1, max(0, math.ceil(p / 100.0 * n) - 1))
        return sorted_samples[idx]

    def percentile(self, p):
        """Exact percentile over the reservoir (p in 0..100); ``None``
        on an empty series — a fresh process's exporter scrape must not
        raise, and 0.0 would read as "instant", not "no data"."""
        with self._lock:
            s = sorted(self._samples)
        return self._pct(s, p)

    def summary(self):
        """count/mean/p50/p95/p99 — ONE reservoir sort per call (not one
        per percentile) and one lock hold, so it is also a consistent
        point-in-time read against concurrent ``observe``.  An empty
        series yields ``count=0`` with None-filled stats (JSON null)."""
        with self._lock:
            s = sorted(self._samples)
            total, total_sum = self.total, self.sum
            n_ex = len(self._exemplars)
        out = {"count": total,
               "mean": total_sum / total if total else None,
               "p50": self._pct(s, 50), "p95": self._pct(s, 95),
               "p99": self._pct(s, 99)}
        if n_ex:
            # surfaced in /varz only when some observation carried one:
            # exemplar-free histograms keep their exact old shape
            out["exemplars"] = self.exemplars()
        return out

    def snapshot_value(self):
        return self.summary()


class MetricsRegistry:
    """Thread-safe named-metric registry.

    ``counter/gauge/histogram`` are get-or-create: repeated calls with the
    same name return the same object, a kind mismatch raises.
    ``register(m, replace=True)`` swaps a freshly built metric in under an
    existing name — the reset idiom."""

    def __init__(self):
        self._metrics = {}      # guarded-by: self._lock
        self._collectors = []   # guarded-by: self._lock
        self._lock = threading.RLock()

    # ---- collectors -----------------------------------------------------
    def add_collector(self, fn):
        """Register a zero-arg callable run at the top of every
        ``snapshot()`` to sync an external source into this registry (the
        bridge of ``utils.monitor.bridge_to_metrics``).  A collector that
        raises is logged and skipped."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)
        return fn

    def remove_collector(self, fn):
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def _run_collectors(self):
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                import logging

                logging.getLogger("paddle_tpu_torch.observability").warning(
                    "metrics collector %r failed", fn, exc_info=True)

    # ---- registration ---------------------------------------------------
    def register(self, metric, replace=False):
        with self._lock:
            old = self._metrics.get(metric.name)
            if old is not None and old is not metric and not replace:
                raise ValueError(f"metric {metric.name!r} already "
                                 "registered (pass replace=True)")
            self._metrics[metric.name] = metric
        return metric

    def unregister(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def _get_or_create(self, cls, name, help, labelnames, **kw):  # noqa: A002
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or \
                        m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} exists as {m.kind} with labels "
                        f"{m.labelnames}; requested {cls.kind} "
                        f"{tuple(labelnames)}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()):  # noqa: A002
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):  # noqa: A002
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), **kw):  # noqa: A002
        return self._get_or_create(Histogram, name, help, labelnames, **kw)

    # ---- readers --------------------------------------------------------
    def metrics(self):
        with self._lock:
            return list(self._metrics.values())

    def gauges(self):
        """[(series_name, value)] for every gauge series — the profiler
        turns these into chrome-trace counter tracks."""
        out = []
        for m in self.metrics():
            if m.kind != "gauge":
                continue
            for lv, child in m._series():
                suffix = "{%s}" % _fmt_labels(m.labelnames, lv) \
                    if lv else ""
                out.append((m.name + suffix, child.value))
        return out

    def snapshot(self):
        """JSON-able {name: {type, value|series}} of every metric."""
        self._run_collectors()
        out = {}
        for m in self.metrics():
            entry = {"type": m.kind}
            if m.labelnames:
                entry["labels"] = list(m.labelnames)
                entry["series"] = [
                    {"labels": dict(zip(m.labelnames, lv)),
                     "value": child.snapshot_value()}
                    for lv, child in m._series()]
            else:
                entry["value"] = m.snapshot_value()
            out[m.name] = entry
        return out

    def expose_prometheus(self):
        """Prometheus text exposition format 0.0.4."""
        self._run_collectors()
        lines = []
        for m in self.metrics():
            name = _prom_name(m.name)
            lines.append(f"# HELP {name} {m.help or m.name}")
            lines.append(f"# TYPE {name} {m.kind}")
            for lv, child in m._series():
                labels = _fmt_labels(m.labelnames, lv)
                if m.kind == "counter":
                    lines.append(_prom_line(name, labels, child.value))
                elif m.kind == "gauge":
                    lines.append(_prom_line(name, labels, child.value))
                    lines.append(_prom_line(
                        name + "_peak", labels, child.peak))
                elif m.kind == "histogram":
                    with child._lock:
                        counts = list(child.counts)
                        total, total_sum = child.total, child.sum
                        exemplars = dict(child._exemplars)
                    cum = 0
                    for i, (ub, c) in enumerate(zip(child.buckets, counts)):
                        cum += c
                        le = (labels + "," if labels else "") + \
                            f'le="{ub:g}"'
                        lines.append(_prom_line(name + "_bucket", le, cum)
                                     + _prom_exemplar(exemplars.get(i)))
                    le = (labels + "," if labels else "") + 'le="+Inf"'
                    lines.append(_prom_line(name + "_bucket", le, total)
                                 + _prom_exemplar(
                                     exemplars.get(len(child.buckets))))
                    lines.append(_prom_line(name + "_sum", labels,
                                            total_sum))
                    lines.append(_prom_line(name + "_count", labels, total))
        return "\n".join(lines) + "\n"


def _prom_name(name):
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _prom_line(name, labels, value):
    lbl = "{%s}" % labels if labels else ""
    if isinstance(value, float):
        return f"{name}{lbl} {value:.9g}"
    return f"{name}{lbl} {value}"


def _prom_exemplar(ex):
    """OpenMetrics exemplar suffix for a ``_bucket`` line (empty string
    when the bucket never saw an exemplar-carrying observation)."""
    if ex is None:
        return ""
    tid, v = ex
    return f' # {{trace_id="{tid}"}} {v:.9g}'


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem of the port reports
    into."""
    return _DEFAULT
