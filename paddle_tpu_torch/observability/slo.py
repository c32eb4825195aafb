"""SLO engine — declarative objectives, error budgets, burn-rate alerts
(the port of ``paddle_tpu/observability/slo.py``).

Production serving is governed by SLOs, not gauges: "TTFT p99 under
half a second", "availability ≥ 99.9%", "goodput ≥ 95%".  This module
turns the :class:`~.timeseries.TimeSeriesStore`'s windowed history into
that governing layer:

- **declarative objectives** (:class:`SLO`): every objective reduces to
  a *good-fraction vs target* ratio over counters or histogram buckets
  —

  - availability: ``bad=(shed, lost)`` / ``total=(requests,)``,
    ``target=0.999`` reads "≤ 0.1% of requests shed or lost";
  - goodput: ``good=(finished,)`` / ``total=(dispatched,)``,
    ``target=G``;
  - latency: ``histogram="serving_ttft_seconds"`` with
    ``threshold_seconds=X`` and ``target=0.99`` reads "TTFT p99 < X"
    (an observation ≤ X is *good* — the classic way a quantile
    objective becomes budget-burnable).

- **error budgets**: the budget fraction is ``1 − target``; burn rate
  over a window is ``bad_fraction(window) / (1 − target)`` — burn 1.0
  spends the budget exactly at the sustainable pace, burn 14.4 empties
  a 30-day budget in 50 hours (the SRE-workbook page threshold).
  ``slo_error_budget_ratio{slo}`` tracks what is left of the budget
  over the objective's ``budget_window_seconds``.

- **multi-window multi-burn-rate alerts** (:class:`BurnRateAlert`): an
  alert fires only when the burn rate exceeds its threshold on BOTH
  its long window (sustained damage, not a blip) and its short window
  (still happening right now — the alert stops firing promptly once
  the bleeding stops).  Severities come from the fixed
  :data:`SEVERITIES` enum: a fast-burn ``"page"`` and a slow-burn
  ``"ticket"``.  Transitions follow the HealthMonitor's
  fire-once/sticky shape: one fire event per onset, the alert stays
  active while the condition holds, and it clears only after the
  condition has stayed false (the short window back under threshold —
  the workbook's prompt-reset property) continuously for
  ``clear_after_seconds`` (hysteresis — a storm that flickers does
  not flap the page).

- **every transition is observable**: an ``slo::<name>`` tracer span
  (``retain`` attribute → tail retention pins it),
  ``slo_alerts_total{slo,severity}`` on fire,
  ``slo_burn_rate{slo,window}`` / ``slo_error_budget_ratio{slo}`` /
  ``slo_alert_active{slo,severity}`` / ``slo_page_active`` gauges on
  every :meth:`SLOEngine.evaluate`, the ``/slo`` exporter endpoint,
  and an active page folds into ``/healthz``.

- **alert-driven control**: the Autoscaler accepts the engine as an
  optional input — a firing fast-burn page escalates scale-up beyond
  what instantaneous pressure shows, and scale-down is permitted only
  while no alert is active and the error budget is healthy.

Nothing starts on import: the engine evaluates when told
(:meth:`SLOEngine.evaluate` / :meth:`SLOEngine.tick`), on an
injectable clock shared with the store.
"""
from __future__ import annotations

import re
import threading
import time
from collections import deque

from .metrics import default_registry

__all__ = ["SEVERITIES", "SLO", "BurnRateAlert", "SLOEngine"]

# the fixed alert-severity enum: a fast-burn page (wake a human) and a
# slow-burn ticket (fix it this week).  The metric-names analysis pass
# rejects any other literal in SLO/BurnRateAlert declarations.
SEVERITIES = ("page", "ticket")

_SNAKE = re.compile(r"^[a-z][a-z0-9_]*$")


def _names(v):
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(v)


class BurnRateAlert:
    """One multi-window burn-rate rule: fire when the SLO's burn rate
    exceeds ``burn_rate_threshold`` on BOTH ``long_window_seconds``
    (sustained damage, not a blip) and ``short_window_seconds`` (still
    happening right now); clear only after that combined condition has
    stayed false — in practice, the short window back under threshold
    — continuously for ``clear_after_seconds`` (default: the short
    window)."""

    def __init__(self, severity, *, burn_rate_threshold,
                 long_window_seconds, short_window_seconds,
                 clear_after_seconds=None):
        if severity not in SEVERITIES:
            raise ValueError(f"severity {severity!r} not in "
                             f"{SEVERITIES}")
        if short_window_seconds >= long_window_seconds:
            raise ValueError(
                f"short window {short_window_seconds} must be shorter "
                f"than long window {long_window_seconds}")
        self.severity = severity
        self.burn_rate_threshold = float(burn_rate_threshold)
        self.long_window_seconds = float(long_window_seconds)
        self.short_window_seconds = float(short_window_seconds)
        self.clear_after_seconds = float(
            short_window_seconds if clear_after_seconds is None
            else clear_after_seconds)

    def spec(self):
        return {"severity": self.severity,
                "burn_rate_threshold": self.burn_rate_threshold,
                "long_window_seconds": self.long_window_seconds,
                "short_window_seconds": self.short_window_seconds,
                "clear_after_seconds": self.clear_after_seconds}


def _default_alerts():
    # the SRE-workbook pair, scaled to process-lifetime windows: the
    # page empties the budget ~14x faster than sustainable and must be
    # both sustained (60 s) and current (5 s); the ticket is the slow
    # leak caught over minutes
    return (BurnRateAlert("page", burn_rate_threshold=14.4,
                          long_window_seconds=60.0,
                          short_window_seconds=5.0),
            BurnRateAlert("ticket", burn_rate_threshold=3.0,
                          long_window_seconds=300.0,
                          short_window_seconds=30.0))


class SLO:
    """One declarative objective over store-backed series.

    Exactly one form:

    - ``bad=`` + ``total=`` counter names — bad fraction is
      ``Δbad / Δtotal`` (availability: shed+lost over requests);
    - ``good=`` + ``total=`` counter names — bad fraction is
      ``1 − Δgood / Δtotal`` (goodput: finished over dispatched);
    - ``histogram=`` + ``threshold_seconds=`` — an observation at or
      under the threshold is good, so ``target=0.99`` is "p99 under
      the threshold" in budget-burnable form.

    ``target`` ∈ (0, 1) is the good-fraction objective;
    ``1 − target`` is the error budget.  ``alerts`` defaults to the
    fast-burn page + slow-burn ticket pair;
    ``budget_window_seconds`` is the rolling compliance window the
    remaining-budget gauge is computed over."""

    def __init__(self, name, *, target, description="", good=None,
                 bad=None, total=None, histogram=None,
                 threshold_seconds=None, alerts=None,
                 budget_window_seconds=3600.0):
        if not _SNAKE.match(name or ""):
            raise ValueError(f"slo name {name!r} is not snake_case")
        if not (0.0 < float(target) < 1.0):
            raise ValueError(f"target must be in (0, 1), got {target}")
        forms = sum((bool(bad), bool(good), histogram is not None))
        if histogram is not None:
            if bad or good or total or threshold_seconds is None:
                raise ValueError(
                    f"slo {name!r}: histogram form takes exactly "
                    f"histogram= + threshold_seconds=")
        elif forms != 1 or not total:
            raise ValueError(
                f"slo {name!r}: pass exactly one of bad=/good= with "
                f"total=, or histogram= with threshold_seconds=")
        self.name = name
        self.target = float(target)
        self.description = description
        self.good = _names(good)
        self.bad = _names(bad)
        self.total = _names(total)
        self.histogram = histogram
        self.threshold_seconds = (None if threshold_seconds is None
                                  else float(threshold_seconds))
        self.alerts = tuple(alerts) if alerts is not None \
            else _default_alerts()
        self.budget_window_seconds = float(budget_window_seconds)

    # ---- evaluation ------------------------------------------------------
    def bad_fraction(self, store, window_s):
        """Fraction of events in the window that burned budget, or
        None when the window has no traffic / not enough scrapes (no
        data reads as "not burning", never as an outage)."""
        if self.histogram is not None:
            return self._bad_fraction_histogram(store, window_s)
        total = 0.0
        for n in self.total:
            d = store.delta(n, window_s=window_s)
            if d is not None:
                total += d
        if total <= 0:
            return None
        if self.bad:
            bad = 0.0
            for n in self.bad:
                d = store.delta(n, window_s=window_s)
                if d is not None:
                    bad += d
            return min(1.0, max(0.0, bad / total))
        good = 0.0
        for n in self.good:
            d = store.delta(n, window_s=window_s)
            if d is not None:
                good += d
        return min(1.0, max(0.0, 1.0 - good / total))

    def _bad_fraction_histogram(self, store, window_s):
        good, total = store.good_below(self.histogram,
                                       self.threshold_seconds,
                                       window_s=window_s)
        if not total:
            return None
        return min(1.0, max(0.0, 1.0 - good / total))

    def burn_rate(self, store, window_s):
        """``bad_fraction / (1 − target)`` — 1.0 spends the budget at
        exactly the sustainable pace.  0.0 on a traffic-free window."""
        frac = self.bad_fraction(store, window_s)
        if frac is None:
            return 0.0
        return frac / (1.0 - self.target)

    def spec(self):
        out = {"name": self.name, "target": self.target,
               "description": self.description,
               "budget_window_seconds": self.budget_window_seconds,
               "alerts": [a.spec() for a in self.alerts]}
        if self.histogram is not None:
            out["histogram"] = self.histogram
            out["threshold_seconds"] = self.threshold_seconds
        else:
            out.update({k: list(v) for k, v in
                        (("good", self.good), ("bad", self.bad),
                         ("total", self.total)) if v})
        return out


class _AlertState:
    """Mutable per-(slo, alert) state — guarded by the engine lock."""

    __slots__ = ("active", "since", "below_since", "fired")

    def __init__(self):
        self.active = False     # guarded-by: engine._lock
        self.since = None       # guarded-by: engine._lock
        self.below_since = None     # guarded-by: engine._lock
        self.fired = 0          # guarded-by: engine._lock


class SLOEngine:
    """Evaluate a set of :class:`SLO`\\ s against a
    :class:`~.timeseries.TimeSeriesStore` and drive the alert state
    machine.

    :meth:`evaluate` is one pass (the soak harness and the autoscaler's
    loop call it inline; :meth:`start` runs scrape+evaluate on an
    opt-in daemon thread).  ``registry`` receives the ``slo_*``
    metrics, ``tracer`` the ``slo::<name>`` transition spans (tail-
    retained via the ``retain`` attribute), ``clock`` defaults to the
    store's so windows line up.  ``profiler`` (a
    :class:`~.profiling.StackSampler`) arms a high-rate capture window
    on every page *fire* transition, linked to the transition span's
    trace."""

    def __init__(self, store, slos, *, registry=None, tracer=None,
                 clock=None, profiler=None):
        self.store = store
        self.slos = tuple(slos)
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate slo names in {names}")
        self.registry = registry or default_registry()
        self.tracer = tracer
        self.profiler = profiler
        self._clock = clock or store._clock or time.perf_counter
        # evaluate() (the driving thread) mutates, status()/page_active()
        # (telemetry scrape thread, autoscaler tick) read — one lock
        # guards all mutable engine state.  Taken before store queries
        # (which take the store lock); the store never calls back into
        # the engine, so the ordering is acyclic.
        self._lock = threading.Lock()
        self._states = {(s.name, i): _AlertState()
                        for s in self.slos
                        for i in range(len(s.alerts))}  # guarded-by: self._lock
        self._transitions = deque(maxlen=256)   # guarded-by: self._lock
        self._last = {}         # name -> last evaluation; guarded-by: self._lock
        self._evaluations = 0   # guarded-by: self._lock
        self._alerts_total = self.registry.counter(
            "slo_alerts_total", "alert fire events per slo and severity",
            labelnames=("slo", "severity"))
        self._budget_gauge = self.registry.gauge(
            "slo_error_budget_ratio",
            "remaining error budget over the compliance window",
            labelnames=("slo",))
        self._burn_gauge = self.registry.gauge(
            "slo_burn_rate", "burn rate per slo and window",
            labelnames=("slo", "window"))
        self._active_gauge = self.registry.gauge(
            "slo_alert_active", "1 while the alert is firing",
            labelnames=("slo", "severity"))
        self._page_gauge = self.registry.gauge(
            "slo_page_active",
            "1 while any fast-burn page alert is firing")
        self._thread = None
        self._stop = threading.Event()

    # ----------------------------------------------------------- evaluate
    def evaluate(self):
        """One alert-state pass over fresh store windows.  Returns the
        transitions this pass produced (also queued for
        :meth:`status`)."""
        now = self._clock()
        transitions = []
        with self._lock:
            for slo in self.slos:
                burns = {}
                for i, alert in enumerate(slo.alerts):
                    for w in (alert.short_window_seconds,
                              alert.long_window_seconds):
                        if w not in burns:
                            burns[w] = slo.burn_rate(self.store, w)
                budget = self._budget_locked(slo)
                self._budget_gauge.labels(slo=slo.name).set(budget)
                for w, b in burns.items():
                    self._burn_gauge.labels(
                        slo=slo.name, window=f"{w:g}s").set(b)
                self._last[slo.name] = {
                    "time": now, "burn_rates": {f"{w:g}s": b
                                                for w, b in burns.items()},
                    "error_budget_ratio": budget}
                for i, alert in enumerate(slo.alerts):
                    tr = self._step_alert_locked(
                        slo, i, alert, burns, now)
                    if tr is not None:
                        transitions.append(tr)
            self._evaluations += 1
            self._page_gauge.set(1.0 if self._page_active_locked()
                                 else 0.0)
        for tr in transitions:
            span = self._emit_span(tr)
            if self.profiler is not None and tr["severity"] == "page" \
                    and tr["transition"] == "fire":
                # a firing page is exactly when "where is the CPU" is
                # worth a high-rate look; the capture continues the
                # transition span's trace so the two correlate by id
                self.profiler.trigger_capture(
                    "slo_page", detail=tr["slo"],
                    context=span.context() if span is not None else None)
        return transitions

    def _budget_locked(self, slo):
        frac = slo.bad_fraction(self.store, slo.budget_window_seconds)
        if frac is None:
            return 1.0
        consumed = frac / (1.0 - slo.target)
        return max(0.0, 1.0 - consumed)

    def _step_alert_locked(self, slo, idx, alert, burns, now):
        """The fire-once/sticky/hysteresis state machine for one
        (slo, alert).  Returns a transition record or None."""
        st = self._states[(slo.name, idx)]
        short = burns[alert.short_window_seconds]
        long_ = burns[alert.long_window_seconds]
        burning = (short > alert.burn_rate_threshold
                   and long_ > alert.burn_rate_threshold)
        if not st.active:
            if not burning:
                return None
            st.active = True
            st.since = now
            st.below_since = None
            st.fired += 1
            self._alerts_total.labels(
                slo=slo.name, severity=alert.severity).inc()
            self._active_gauge.labels(
                slo=slo.name, severity=alert.severity).set(1.0)
            return self._transition_locked(
                slo, alert, "fire", now, short, long_)
        if burning:
            st.below_since = None       # still burning: stay sticky
            return None
        if st.below_since is None:
            st.below_since = now
        if now - st.below_since < alert.clear_after_seconds:
            return None                 # hysteresis: budget refilling
        st.active = False
        st.since = None
        st.below_since = None
        self._active_gauge.labels(
            slo=slo.name, severity=alert.severity).set(0.0)
        return self._transition_locked(
            slo, alert, "clear", now, short, long_)

    def _transition_locked(self, slo, alert, kind, now, short, long_):
        tr = {"time": now, "slo": slo.name,
              "severity": alert.severity, "transition": kind,
              "burn_short": round(short, 4),
              "burn_long": round(long_, 4),
              "threshold": alert.burn_rate_threshold}
        self._transitions.append(tr)
        return tr

    def _emit_span(self, tr):
        """A zero-width ``slo::<name>`` span per transition — the
        ``retain`` attribute pins it in the tail-retained ring so a
        chaos window's fire/clear pair survives sampling.  Returns the
        span (None without a tracer) so the profiler capture trigger
        can continue its trace."""
        if self.tracer is None:
            return None
        attrs = dict(tr, retain=True)
        return self.tracer.start_trace(
            f"slo::{tr['slo']}", start_s=tr["time"],
            attributes=attrs).end(tr["time"])

    def tick(self):
        """Scrape the store, then evaluate — the one-call loop
        step."""
        self.store.scrape_once()
        return self.evaluate()

    # ------------------------------------------------------------ readers
    def _page_active_locked(self):
        for (name, idx), st in self._states.items():
            if not st.active:
                continue
            slo = next(s for s in self.slos if s.name == name)
            if slo.alerts[idx].severity == "page":
                return True
        return False

    def page_active(self):
        """True while any fast-burn page alert is firing — the
        ``/healthz`` fold and the autoscaler's escalation input."""
        with self._lock:
            return self._page_active_locked()

    def alerts_active(self):
        """[(slo, severity)] of every currently-firing alert."""
        with self._lock:
            return [(name, self.slos_by_name(name).alerts[idx].severity)
                    for (name, idx), st in sorted(self._states.items())
                    if st.active]

    def slos_by_name(self, name):
        for s in self.slos:
            if s.name == name:
                return s
        raise KeyError(name)

    def min_budget_ratio(self):
        """The scarcest remaining error budget across objectives (1.0
        before any evaluation) — the autoscaler's scale-down gate."""
        with self._lock:
            vals = [ev["error_budget_ratio"]
                    for ev in self._last.values()]
            return min(vals) if vals else 1.0

    def max_burn_rate(self):
        """The worst live burn rate across every objective and window
        from the last evaluation (0.0 before any) — the closed-loop
        traffic feedback signal: >1 means the error budget is being
        spent faster than it refills."""
        with self._lock:
            worst = 0.0
            for ev in self._last.values():
                for b in ev["burn_rates"].values():
                    if b > worst:
                        worst = b
            return worst

    def status(self):
        """The ``/slo`` payload: per-objective spec, live burn rates
        and remaining budget, per-alert state, and the recent
        transition log."""
        with self._lock:
            slos = {}
            for slo in self.slos:
                last = self._last.get(slo.name)
                alerts = []
                for i, alert in enumerate(slo.alerts):
                    st = self._states[(slo.name, i)]
                    alerts.append(dict(alert.spec(),
                                       active=st.active,
                                       since=st.since,
                                       fired=st.fired))
                slos[slo.name] = dict(slo.spec(),
                                      last=last, alerts=alerts)
            return {"slos": slos,
                    "page_active": self._page_active_locked(),
                    "evaluations": self._evaluations,
                    "transitions": list(self._transitions)}

    # ------------------------------------------------------------- thread
    def start(self, interval_s=1.0):
        """Run :meth:`tick` on a daemon thread.  Strictly opt-in — the
        soak harness and tests drive the engine inline instead."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, args=(float(interval_s),),
            name="slo-engine", daemon=True)
        self._thread.start()
        return self

    def _run(self, interval_s):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                pass    # silent-ok: a flaky evaluation must not kill
                #         the loop; the next beat re-reads live state
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
