"""Counter / Gauge / Histogram and a named registry — the subset of
``paddle_tpu/observability/metrics.py`` that the serving metrics use.

Thread-safe: the engine mutates metrics on its thread while an operator
thread reads them; every mutation and read takes the metric's lock.
Label families, scrape collectors, the registry snapshot and the
Prometheus exposition are not ported yet.
"""
from __future__ import annotations

import bisect
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry"]


class _Metric:
    def __init__(self, name, help=""):  # noqa: A002
        self.name = name
        self.help = help
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonic event counter."""

    def __init__(self, name, help=""):  # noqa: A002
        super().__init__(name, help)
        self._value = 0         # guarded-by: self._lock

    def inc(self, n=1):
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Last-value gauge that also tracks its peak."""

    def __init__(self, name, help=""):  # noqa: A002
        super().__init__(name, help)
        self._value = 0.0       # guarded-by: self._lock
        self._peak = 0.0        # guarded-by: self._lock

    def set(self, v):
        with self._lock:
            self._value = float(v)
            self._peak = max(self._peak, self._value)

    @property
    def value(self):
        with self._lock:
            return self._value

    @property
    def peak(self):
        with self._lock:
            return self._peak


class Histogram(_Metric):
    """Log-bucketed histogram with exact bounded-reservoir percentiles
    (the reservoir keeps the newest ``reservoir`` samples)."""

    def __init__(self, name, help="", start=1e-4, factor=2.0, count=20,
                 reservoir=2048):  # noqa: A002
        super().__init__(name, help)
        self.buckets = [start * factor ** i for i in range(count)]
        self.counts = [0] * (count + 1)  # overflow bucket; guarded-by: self._lock
        self.total = 0          # guarded-by: self._lock
        self.sum = 0.0          # guarded-by: self._lock
        self._reservoir = reservoir
        self._samples = []      # guarded-by: self._lock
        # bucket index -> (exemplar trace_id, observed value)
        self._exemplars = {}    # guarded-by: self._lock

    def observe(self, v, exemplar=None):
        """Record ``v``; ``exemplar`` (a trace_id string, or None) pins
        this observation as its bucket's exemplar."""
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
        """{bucket_le: {"trace_id", "value"}} — newest exemplar per
        bucket."""
        with self._lock:
            ex = dict(self._exemplars)
        out = {}
        for idx, (tid, v) in sorted(ex.items()):
            le = (f"{self.buckets[idx]:g}" if idx < len(self.buckets)
                  else "+Inf")
            out[le] = {"trace_id": tid, "value": v}
        return out

    @staticmethod
    def _pct(sorted_samples, p):
        if not sorted_samples:
            return None
        n = len(sorted_samples)
        idx = min(n - 1, max(0, math.ceil(p / 100.0 * n) - 1))
        return sorted_samples[idx]

    def summary(self):
        """count/mean/p50/p95/p99 from one consistent locked read."""
        with self._lock:
            s = sorted(self._samples)
            total, total_sum = self.total, self.sum
            n_ex = len(self._exemplars)
        out = {"count": total,
               "mean": total_sum / total if total else None,
               "p50": self._pct(s, 50), "p95": self._pct(s, 95),
               "p99": self._pct(s, 99)}
        if n_ex:
            out["exemplars"] = self.exemplars()
        return out


class MetricsRegistry:
    """Thread-safe named-metric registry.  ``register(m, replace=True)``
    swaps a freshly built metric in under an existing name."""

    def __init__(self):
        self._metrics = {}      # guarded-by: self._lock
        self._lock = threading.RLock()

    def register(self, metric, replace=False):
        with self._lock:
            old = self._metrics.get(metric.name)
            if old is not None and old is not metric and not replace:
                raise ValueError(f"metric {metric.name!r} already "
                                 "registered (pass replace=True)")
            self._metrics[metric.name] = metric
        return metric

    def metrics(self):
        with self._lock:
            return list(self._metrics.values())


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem of the port reports
    into."""
    return _DEFAULT
