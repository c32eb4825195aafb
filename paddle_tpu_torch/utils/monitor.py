"""Runtime counters (the port of ``paddle_tpu/utils/monitor.py``; parity:
paddle/fluid/platform/monitor.h:77 ``StatRegistry`` + the
STAT_ADD/STAT_GET macros, plus memory/stats.h's per-stat peaks).

Host-side registry: device memory stats come from
``torch.cuda.memory_stats`` and are surfaced through the same API (the
reference's DEVICE_MEMORY_STAT_* reads the allocator; so does this, the
caching allocator's).
"""
from __future__ import annotations

import threading

__all__ = ["StatRegistry", "stat_add", "stat_get", "stat_reset",
           "bridge_to_metrics", "device_memory_stats"]


class _Stat:
    __slots__ = ("value", "peak")

    def __init__(self):
        self.value = 0
        self.peak = 0


class StatRegistry:
    """Named integer counters with peaks (monitor.h:77)."""

    def __init__(self):
        self._stats: dict[str, _Stat] = {}      # guarded-by: self._lock
        self._lock = threading.Lock()

    def add(self, name, delta):
        with self._lock:
            s = self._stats.setdefault(name, _Stat())
            s.value += int(delta)
            s.peak = max(s.peak, s.value)
            return s.value

    def get(self, name):
        with self._lock:
            s = self._stats.get(name)
            return s.value if s else 0

    def peak(self, name):
        with self._lock:
            s = self._stats.get(name)
            return s.peak if s else 0

    def reset(self, name=None):
        with self._lock:
            if name is None:
                self._stats.clear()
            else:
                self._stats.pop(name, None)

    def stats(self):
        with self._lock:
            return {k: (s.value, s.peak) for k, s in self._stats.items()}


_default = StatRegistry()


def stat_add(name, delta=1):
    """STAT_ADD analog on the process-wide registry."""
    return _default.add(name, delta)


def stat_get(name):
    return _default.get(name)


def stat_reset(name=None):
    _default.reset(name)


def bridge_to_metrics(stat_registry=None, metrics_registry=None):
    """One-way bridge: surface a :class:`StatRegistry`'s counters/peaks
    in the observability :class:`MetricsRegistry` as the
    ``runtime_stat{name=...}`` gauge family.

    The sync runs *on scrape* (a registry collector fires at the top of
    every ``snapshot()``/``expose_prometheus()``), so legacy
    ``stat_add`` call sites keep their lock-cheap integer registry but
    their stats still appear on ``/metrics`` and in bench JSON instead
    of living in a parallel, invisible registry.  Peaks ride the gauge's
    own peak tracking (the peak is replayed before the current value,
    so ``runtime_stat_peak`` is never below the stat's true peak).

    Defaults bridge the process-wide pair; the default bridge is
    installed once at import of this module.  Returns the collector so
    callers wiring explicit registries can ``remove_collector`` it."""
    from ..observability.metrics import default_registry

    sr = stat_registry if stat_registry is not None else _default
    mr = metrics_registry if metrics_registry is not None \
        else default_registry()

    def _collect():
        stats = sr.stats()
        if not stats:
            return
        g = mr.gauge("runtime_stat",
                     "legacy StatRegistry counters (bridged on scrape)",
                     labelnames=("name",))
        for name, (value, peak) in stats.items():
            child = g.labels(name=name)
            child.set(peak)
            child.set(value)

    return mr.add_collector(_collect)


_BRIDGED = False


def _install_default_bridge():
    global _BRIDGED
    if not _BRIDGED:
        _BRIDGED = True
        bridge_to_metrics()


_install_default_bridge()


def device_memory_stats(device=None):
    """The CUDA caching allocator's stats for ``device`` (default: that
    of ``set_device``); {} for the CPU, which keeps none."""
    import torch

    from ..core.place import current_device

    d = torch.device(device) if device is not None else current_device()
    if d.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(d))
