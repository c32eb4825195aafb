"""Elastic fleet autoscaler — the control loop that sizes the fleet (the
port of ``paddle_tpu/serving/autoscaler.py``).

The router makes the fleet fault-tolerant and cache-warm, but its size
is fixed at construction: a diurnal or bursty trace either
over-provisions chips all night or sheds load all afternoon.  The
:class:`Autoscaler` closes that gap by watching the signals every
replica already exports and driving the :class:`~.router.FleetRouter`
elastic:

- **signals** (polled each :meth:`tick` on an injectable clock): every
  healthy replica's ``estimated_drain_s`` and queue depth (from
  ``engine.health()``), the router's pending depth, the RETRY_AFTER /
  shed rate, and the fleet goodput ratio (finished ÷ dispatched).
  With a :class:`~paddle_tpu_torch.observability.timeseries.TimeSeriesStore`
  attached (``timeseries=``), shed and goodput come from *windowed*
  store deltas (``signal_window_s`` wide, counter-reset-safe) instead
  of the ad-hoc between-poll counter base the loop otherwise keeps —
  the window is the same no matter how irregular the tick cadence.
  They fold into one *pressure* figure — mean drain seconds per
  **ready** replica plus a pending-depth term — so the decision scales
  with fleet size.
- **SLO input** (``slo=``, an
  :class:`~paddle_tpu_torch.observability.slo.SLOEngine`): a firing
  fast-burn *page* alert escalates scale-up (reason
  ``slo_fast_burn``) even when instantaneous pressure sits inside the
  hysteresis band — the budget emptying at page speed IS demand the
  pressure figure has not caught up to.  Scale-down is gated the other
  way: only while no alert is active and every objective keeps at
  least ``slo_down_min_budget`` of its error budget — a healthy
  budget *permits* shrinking, a burning one forbids it.
  ``slo_scale_up_on`` (a name tuple) restricts which objectives' pages
  escalate; default: any page.
- **warming replicas don't count** — a replica whose decode-rate EWMA
  has no real sample yet (freshly spawned/revived; ``warmup()`` resets
  the EWMA, see :meth:`~.engine.Engine.warmup`) still advertises its
  ``drain_floor_s`` and is excluded from the ready count: the
  autoscaler never treats capacity it cannot prove as absorbed load,
  and never reads a cold replica's floor as backlog pressure it should
  scale away from.
- **hysteresis + per-direction cooldowns** — scale up only when
  pressure is *strictly above* ``up_pressure_s`` (or pending depth
  strictly above ``up_pending_depth``, or any shed events since the
  last poll), scale down only when pressure is *strictly below*
  ``down_pressure_s`` with zero pending/queued/shed.  Load oscillating
  exactly at a band boundary produces zero events.  After a scale-up,
  further ups freeze for ``scale_up_cooldown_s``; scale-down freezes
  for ``scale_down_cooldown_s`` after a scale event in *either*
  direction (an up is never immediately undone — the classic flap —
  while an up right after a down stays fast, because under-capacity
  is the expensive failure mode).
- **cascade-breaker coordination** — when the router's cascade breaker
  is open (≥ K uncontrolled replica failures in its sliding window — a
  poison storm), every scale-up trigger except zero-healthy recovery
  is vetoed: the pending backlog is failure churn, not demand, and a
  spawn would only hand the poison a fresh victim.  A genuine load
  burst arriving mid-storm still scales once the breaker closes.
- **scale-up = spawn through the router's factory path** — a DEAD
  restartable replica is revived first (the cheapest capacity); else
  a fresh replica is appended via :meth:`~.router.FleetRouter.add_replica`.
  Either way the engine runs ``warmup()`` *before* rotation entry, and
  the spawn is retried with jittered exponential backoff out of a
  bounded budget (the supervisor's spawn discipline) — the
  ``autoscaler.scale_up`` fault site injects the io_error that path
  must survive.
- **scale-down = cache-warmth-aware drain** — the victim is the
  *coldest* replica by gossiped prefix-radix summary: each
  candidate's expected hit-token value is the sum of cached-prefix
  token depths in its bounded summary, so the replica whose cache is
  worth the least prefill FLOPs drains first (ties: fewest in-flight,
  then the youngest replica).  The drain itself is the router's
  graceful :meth:`~.router.FleetRouter.drain` with ``restart=False``
  — in-flight decode finishes (stragglers re-dispatch exactly once),
  then the replica leaves rotation as revivable capacity.

Observability: ``autoscaler_scale_events_total{direction,reason}`` /
``autoscaler_target_replicas`` / ``autoscaler_ready_replicas`` /
``autoscaler_pressure_seconds`` in the metrics registry,
``autoscaler::scale`` tracer spans per event, and — with the
autoscaler attached to its router — an ``autoscaler`` block in the
``/fleet`` payload (target, ready/warming counts, last signals,
cooldown state, recent events).

Fault sites (see :mod:`paddle_tpu_torch.resilience.faults`):
``autoscaler.poll`` fires at the top of every tick (a ``stall`` there
is the control loop hiccuping — scaling is delayed, never wrong);
``autoscaler.scale_up`` fires before every spawn attempt (an
``io_error`` is a spawn that died — retried with backoff out of the
bounded budget, then counted as ``autoscaler_spawn_failures_total``).

Threading: :meth:`tick` may be driven by any loop (the soak harness
drives it inline; :meth:`start` runs it on a daemon thread) while the
telemetry server's scrape thread reads :meth:`status` — all mutable
autoscaler state is guarded by one lock.  The autoscaler lock is
always taken *before* any router call (which takes the router's own
lock); :meth:`status` touches only autoscaler state, and the router's
``fleet_status`` folds it in outside the router lock, so the two
locks never interleave in opposite orders.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from ..observability.tracing import Tracer, activate, default_tracer
from ..resilience.faults import fault_point
from ..resilience.retry import backoff_delays
from .metrics import AutoscalerMetrics
from .router import ReplicaState

__all__ = ["Autoscaler"]


class Autoscaler:
    """Elastic control loop over one :class:`~.router.FleetRouter`.

    ``factory`` is the zero-arg engine factory scale-up appends fresh
    replicas through (default: the first factory-built replica's own
    factory).  ``min_replicas``/``max_replicas`` bound the in-rotation
    count.  The hysteresis band is ``(down_pressure_s, up_pressure_s)``
    on the fleet pressure signal (strict comparisons on both edges);
    ``up_pending_depth`` is the router-queue depth that also triggers
    scale-up, and any shed/RETRY_AFTER event since the last poll does
    too.  ``scale_up_cooldown_s``/``scale_down_cooldown_s`` freeze
    each direction independently after an event.  ``spawn_max_retries``
    bounds the spawn-retry budget (jittered backoff between attempts).
    The router's ``warmup`` runs on every spawned/revived engine before
    rotation entry.  ``clock`` is injectable (tests run
    the whole loop on a manual clock); ``pending_token_s`` converts one
    pending request into pressure seconds.

    ``timeseries`` (a :class:`~paddle_tpu_torch.observability.timeseries.
    TimeSeriesStore` scraping the same registry) switches the
    shed/goodput signals to ``signal_window_s``-windowed store deltas;
    ``slo`` (an :class:`~paddle_tpu_torch.observability.slo.SLOEngine`)
    escalates scale-up under a firing fast-burn page (filtered by
    ``slo_scale_up_on`` when given) and gates scale-down on a healthy
    budget (every objective ≥ ``slo_down_min_budget`` remaining, no
    alert active).  Both default to None — the loop then behaves
    exactly as before."""

    def __init__(self, router, factory=None, *, min_replicas=1,
                 max_replicas=4, poll_interval_s=0.0,
                 up_pressure_s=2.0, down_pressure_s=0.25,
                 up_pending_depth=6, pending_token_s=0.05,
                 scale_up_cooldown_s=2.0, scale_down_cooldown_s=5.0,
                 spawn_max_retries=2, spawn_backoff_base_s=0.05,
                 spawn_backoff_cap_s=1.0, clock=None,
                 tracer=None, registry=None, rng=None, slo=None,
                 timeseries=None, signal_window_s=2.0,
                 slo_down_min_budget=0.25, slo_scale_up_on=None):
        if max_replicas < min_replicas:
            raise ValueError(f"max_replicas {max_replicas} < "
                             f"min_replicas {min_replicas}")
        if down_pressure_s >= up_pressure_s:
            raise ValueError(
                f"hysteresis band is empty: down_pressure_s "
                f"{down_pressure_s} >= up_pressure_s {up_pressure_s}")
        self.router = router
        self._factory = factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.poll_interval_s = float(poll_interval_s)
        self.up_pressure_s = float(up_pressure_s)
        self.down_pressure_s = float(down_pressure_s)
        self.up_pending_depth = (None if up_pending_depth is None
                                 else int(up_pending_depth))
        self.pending_token_s = float(pending_token_s)
        self.scale_up_cooldown_s = float(scale_up_cooldown_s)
        self.scale_down_cooldown_s = float(scale_down_cooldown_s)
        self.spawn_max_retries = int(spawn_max_retries)
        self.spawn_backoff_base_s = float(spawn_backoff_base_s)
        self.spawn_backoff_cap_s = float(spawn_backoff_cap_s)
        self._clock = clock or time.perf_counter
        if tracer is None:
            tracer = (default_tracer() if clock is None
                      else Tracer(clock=self._clock))
        self.tracer = tracer
        self.metrics = AutoscalerMetrics(registry=registry)
        self._rng = rng
        # optional SLO coupling — read-only config after construction
        self.slo = slo
        self.timeseries = timeseries
        self.signal_window_s = float(signal_window_s)
        self.slo_down_min_budget = float(slo_down_min_budget)
        self.slo_scale_up_on = (None if slo_scale_up_on is None
                                else tuple(slo_scale_up_on))
        # tick() (driver/daemon thread) mutates, status() (telemetry
        # scrape thread) reads — one lock guards all mutable state.
        # Always taken BEFORE any router call; never held by status().
        self._lock = threading.Lock()
        self._last_poll = None      # guarded-by: self._lock
        self._last_up = None        # guarded-by: self._lock
        self._last_down = None      # guarded-by: self._lock
        self._last_signals = None   # guarded-by: self._lock
        self._events = deque(maxlen=64)   # guarded-by: self._lock
        self._counter_base = None   # guarded-by: self._lock
        self._up_events = 0         # guarded-by: self._lock
        self._down_events = 0       # guarded-by: self._lock
        self._spawn_failures = 0    # guarded-by: self._lock
        self._target = None         # guarded-by: self._lock
        self._thread = None
        self._stop = threading.Event()
        router.attach_autoscaler(self)

    # ------------------------------------------------------------- signals
    def _router_counters(self):
        """The monotonic router counters the shed/goodput deltas are
        computed over."""
        snap = self.router.metrics.snapshot()
        return {
            "backpressure": sum((snap.get("backpressure_retries")
                                 or {}).values()),
            "dispatches": sum((snap.get("dispatches") or {}).values()),
            "finished": snap.get("finished") or 0,
        }

    def _signals_locked(self, now):
        """One poll of the fleet: per-replica drain/queue (dead and
        draining replicas excluded), warming count, pending depth,
        shed delta, goodput ratio — folded into the pressure figure
        the bands compare against."""
        drains, queues, warming = {}, {}, []
        healthy = draining = 0
        finished = 0
        for rep in self.router.replicas:
            if rep.state == ReplicaState.DRAINING:
                draining += 1
            if rep.state != ReplicaState.HEALTHY:
                continue
            healthy += 1
            try:
                h = rep.engine.health()
            except (OSError, AttributeError):
                continue    # the router's own probe path retires it
            rid = rep.replica_id
            drains[rid] = float(h.get("estimated_drain_s") or 0.0)
            queues[rid] = int(h.get("queue_depth") or 0)
            if h.get("decode_rate_tok_s") is None:
                warming.append(rid)
        ready = max(0, healthy - len(warming))
        pending = self.router.pending_depth()
        # the router's cascade breaker: >= K uncontrolled replica
        # failures in the sliding window means the backlog is a poison
        # storm churning the fleet, not organic load — scale-up on it
        # would spawn fresh victims
        cascade = bool(getattr(self.router, "cascade_open",
                               lambda: False)())
        if self.timeseries is not None:
            # windowed, counter-reset-safe deltas from the store — the
            # window is signal_window_s wide no matter how irregular
            # the tick cadence (the between-poll counter base below is
            # exactly as wide as the gap between two ticks happened to
            # be, which is the ad-hoc part this replaces)
            w = self.signal_window_s
            shed_delta = self.timeseries.delta(
                "router_backpressure_retries_total", window_s=w) or 0.0
            dispatch_delta = self.timeseries.delta(
                "router_dispatches_total", window_s=w) or 0.0
            finished_delta = self.timeseries.delta(
                "router_requests_finished_total", window_s=w) or 0.0
        else:
            counters = self._router_counters()
            base = self._counter_base or counters
            self._counter_base = counters
            shed_delta = counters["backpressure"] - base["backpressure"]
            dispatch_delta = counters["dispatches"] - base["dispatches"]
            finished_delta = counters["finished"] - base["finished"]
        goodput = (min(1.0, finished_delta / dispatch_delta)
                   if dispatch_delta > 0 else None)
        # warming replicas are NOT capacity: their drain floor is a
        # cold-start advertisement, not backlog — pressure is backlog
        # seconds per replica that can actually absorb it
        ready_drain = [drains[r] for r in drains if r not in warming]
        slo_alerts, slo_page, slo_budget = [], False, None
        if self.slo is not None:
            slo_alerts = self.slo.alerts_active()
            slo_budget = self.slo.min_budget_ratio()
            watched = self.slo_scale_up_on
            slo_page = any(
                sev == "page" and (watched is None or name in watched)
                for name, sev in slo_alerts)
        denom = max(ready, 1)
        pressure = (sum(ready_drain) / denom
                    + pending * self.pending_token_s / denom)
        return {
            "healthy": healthy, "ready": ready,
            "warming": list(warming), "draining": draining,
            "pending_depth": pending,
            "queue_depth": sum(queues.values()),
            "drain_s": drains,
            "shed_delta": shed_delta,
            "goodput_ratio": goodput,
            "pressure_s": pressure,
            "cascade_open": cascade,
            "slo_page": slo_page,
            "slo_alerts": slo_alerts,
            "slo_min_budget": slo_budget,
            "time": now,
        }

    # ------------------------------------------------------------ decision
    def _decide_locked(self, sig, now):
        """(direction, reason) or None under the hysteresis bands and
        per-direction cooldowns.  Strict comparisons on both band
        edges: load sitting exactly on a boundary never scales."""
        healthy = sig["healthy"]
        up_ok = (healthy < self.max_replicas
                 and (self._last_up is None
                      or now - self._last_up >= self.scale_up_cooldown_s))
        # the down window counts from the last event in EITHER
        # direction: a scale-up is never immediately undone (the
        # classic flap), while an up right after a down stays fast —
        # under-capacity is the expensive failure mode
        last_any = max((t for t in (self._last_up, self._last_down)
                        if t is not None), default=None)
        down_ok = (healthy > self.min_replicas
                   and sig["draining"] == 0
                   and (last_any is None
                        or now - last_any >= self.scale_down_cooldown_s))
        if healthy == 0 and self.max_replicas > 0:
            # nobody can absorb anything — bypass the up cooldown, this
            # is recovery, not flap (every replica dead or draining).
            # The cascade breaker does NOT veto this one: with zero
            # healthy replicas even the canary trials are starved.
            return ("up", "no_capacity")
        if sig.get("cascade_open"):
            # poison storm in progress: the pending depth and shed rate
            # are failure churn, not demand — adding replicas only
            # feeds the cascade fresh victims.  A real load burst that
            # arrives meanwhile still scales once the breaker closes.
            return None
        if up_ok:
            if sig.get("slo_page"):
                # the error budget is emptying at page speed: that IS
                # demand, whether or not the pressure figure has caught
                # up — escalate past the hysteresis band (cooldown and
                # max_replicas still bound it, the cascade veto above
                # still wins during a storm)
                return ("up", "slo_fast_burn")
            if sig["pressure_s"] > self.up_pressure_s:
                return ("up", "pressure")
            if self.up_pending_depth is not None and \
                    sig["pending_depth"] > self.up_pending_depth:
                return ("up", "pending")
            if sig["shed_delta"] > 0:
                return ("up", "shed")
        # with an SLO engine attached, shrinking requires a *healthy*
        # budget: no alert firing and every objective above the
        # retained-budget floor — capacity is only returned when the
        # objectives can afford the risk
        slo_ok = (not sig.get("slo_alerts")
                  and (sig.get("slo_min_budget") is None
                       or sig["slo_min_budget"]
                       >= self.slo_down_min_budget))
        if down_ok and slo_ok \
                and sig["pressure_s"] < self.down_pressure_s and \
                sig["pending_depth"] == 0 and sig["queue_depth"] == 0 \
                and sig["shed_delta"] == 0:
            return ("down", "idle")
        return None

    # ------------------------------------------------------------ scale up
    def _spawn_locked(self):
        """One replica of new capacity, through the router's factory
        path: revive the cheapest DEAD restartable replica, else append
        a fresh one.  Spawn attempts are retried with jittered backoff
        out of a bounded budget — the supervisor's spawn discipline —
        and the ``autoscaler.scale_up`` fault site fires before each
        attempt."""
        delays = backoff_delays(base=self.spawn_backoff_base_s,
                                cap=self.spawn_backoff_cap_s,
                                rng=self._rng)
        last = None
        for _attempt in range(self.spawn_max_retries + 1):
            try:
                fault_point("autoscaler.scale_up")
                dead = next((rep for rep in self.router.replicas
                             if rep.state == ReplicaState.DEAD
                             and rep.factory is not None), None)
                if dead is not None:
                    return self.router.restart_replica(dead.replica_id)
                factory = self._factory
                if factory is None:
                    factory = next(
                        (rep.factory for rep in self.router.replicas
                         if rep.factory is not None), None)
                if factory is None:
                    raise OSError("autoscaler has no engine factory "
                                  "to spawn with")
                return self.router.add_replica(factory)
            except OSError as e:
                last = e
                time.sleep(next(delays))
        self._spawn_failures += 1
        self.metrics.spawn_failures.inc()
        self._events.append({"time": self._clock(), "direction": "up",
                             "reason": "spawn_failed",
                             "error": repr(last)})
        return None

    # ---------------------------------------------------------- scale down
    def _pick_victim_locked(self):
        """Cache-warmth-aware victim selection: the healthy replica
        whose gossiped radix summary is worth the fewest expected hit
        tokens drains first (its cache costs the least prefill FLOPs
        to lose).  Ties: fewest in-flight requests, then the youngest
        replica (highest id — the most recently added capacity)."""
        self.router.refresh_prefix_summaries()
        summaries = self.router.prefix_summaries()
        in_flight = self.router.in_flight_counts()
        cands = []
        for rep in self.router.replicas:
            if rep.state != ReplicaState.HEALTHY:
                continue
            s = summaries.get(rep.replica_id) or {}
            warm_tokens = (sum((s.get("entries") or {}).values())
                           if s.get("enabled", True) else 0)
            cands.append((warm_tokens,
                          in_flight.get(rep.replica_id, 0),
                          -rep.replica_id, rep))
        if not cands:
            return None, 0
        cands.sort(key=lambda c: c[:3])
        return cands[0][3], cands[0][0]

    # ---------------------------------------------------------------- tick
    def tick(self):
        """One control-loop iteration: poll signals, decide under the
        bands/cooldowns, act.  Returns the ``(direction, reason)`` of a
        scale event, or None.  Safe to call more often than
        ``poll_interval_s`` — early calls are no-ops."""
        fault_point("autoscaler.poll")
        now = self._clock()
        with self._lock:
            if self._last_poll is not None and self.poll_interval_s > 0 \
                    and now - self._last_poll < self.poll_interval_s:
                return None
            self._last_poll = now
            sig = self._signals_locked(now)
            self._last_signals = sig
            decision = self._decide_locked(sig, now)
            self.metrics.pressure.set(sig["pressure_s"])
            self.metrics.ready_replicas.set(sig["ready"])
            if decision is None:
                if self._target is None:
                    self._target = sig["healthy"]
                    self.metrics.target_replicas.set(self._target)
                return None
            direction, reason = decision
            event = {"time": now, "direction": direction,
                     "reason": reason,
                     "pressure_s": round(sig["pressure_s"], 4),
                     "pending_depth": sig["pending_depth"]}
            # the scale span opens BEFORE the action so a fault firing
            # mid-spawn (autoscaler.scale_up) lands on it as the
            # ambient active span
            span = self.tracer.start_trace(
                "autoscaler::scale", start_s=now, attributes=event)
            if direction == "up":
                with activate(span):
                    rep = self._spawn_locked()
                if rep is None:          # spawn budget exhausted
                    span.set_attribute("outcome", "spawn_failed")
                    span.end(self._clock())
                    return None
                self._last_up = now
                self._up_events += 1
                event["replica"] = rep.replica_id
                self._target = sig["healthy"] + 1
            else:
                victim, warm_tokens = self._pick_victim_locked()
                if victim is None:
                    span.set_attribute("outcome", "no_victim")
                    span.end(self._clock())
                    return None
                self.router.drain(victim.replica_id, restart=False)
                self._last_down = now
                self._down_events += 1
                event["replica"] = victim.replica_id
                event["victim_warm_tokens"] = warm_tokens
                self._target = sig["healthy"] - 1
            self._events.append(event)
            self.metrics.scale_events.labels(
                direction=direction, reason=reason).inc()
            self.metrics.target_replicas.set(self._target)
            span.set_attributes(event)
            span.end(self._clock())
            return decision

    # --------------------------------------------------------------- status
    def status(self):
        """The ``/fleet`` autoscaler block: bands, target, last
        signals, cooldown state, recent events.  Reads only autoscaler
        state (never the router), so the telemetry scrape can fold it
        into ``fleet_status`` without interleaving the two locks."""
        now = self._clock()

        def _cooldown(last, cooldown_s):
            if last is None:
                return 0.0
            return max(0.0, cooldown_s - (now - last))

        with self._lock:
            return {
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "target_replicas": self._target,
                "bands": {"up_pressure_s": self.up_pressure_s,
                          "down_pressure_s": self.down_pressure_s,
                          "up_pending_depth": self.up_pending_depth},
                "cooldown_remaining_s": {
                    "up": _cooldown(self._last_up,
                                    self.scale_up_cooldown_s),
                    "down": _cooldown(self._last_down,
                                      self.scale_down_cooldown_s)},
                "scale_events": {"up": self._up_events,
                                 "down": self._down_events},
                "spawn_failures": self._spawn_failures,
                "last_signals": ({k: v for k, v in
                                  self._last_signals.items()
                                  if not k.startswith("_")}
                                 if self._last_signals else None),
                "events": list(self._events)[-16:],
            }

    # --------------------------------------------------------------- thread
    def start(self, interval_s=None):
        """Run the control loop on a daemon thread every ``interval_s``
        (default: ``poll_interval_s`` or 1s).  Strictly opt-in — the
        soak harness and tests drive :meth:`tick` inline instead."""
        if self._thread is not None:
            return self
        beat = float(interval_s if interval_s is not None
                     else (self.poll_interval_s or 1.0))
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, args=(beat,),
                                        name="fleet-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self, interval_s):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                pass    # silent-ok: a flaky poll must not kill the
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
