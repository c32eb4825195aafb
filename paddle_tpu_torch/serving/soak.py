"""Chaos soak harness — every resilience subsystem at once, for hours
(the port of ``paddle_tpu/serving/soak.py``).

Unit tests kill one replica at one site; the soak replays a *diurnal,
bursty, shared-prefix* traffic trace (:mod:`.traffic`) through an
**autoscaled** fleet (:mod:`.autoscaler` over :mod:`.router`) while a
chaos timeline fires hard replica kills, admission stalls, control-
loop stalls, and spawn I/O errors — the standing kill matrix.  One
harness, :func:`run_soak`, backs both the full-width soak of
``chip_smoke.py`` (phase 25, 1.3B engines on the card) and the
compressed tier-1 tests on the CPU, so the invariants are asserted on
every run and measured at scale on the card:

- ``lost_requests == 0`` — every submitted request reaches FINISHED
  despite kills, stalls, drains, and scale events (the router's
  exactly-once failover contract, held across the whole run);
- **bounded TTFT p99** — recoveries cost latency, never starvation;
- **elasticity both ways** — at least one scale-up (burst) and one
  scale-down (trough) mid-run, recorded in ``/fleet``;
- **visibility** — every chaos event lands a ``soak::<action>`` record
  in the flight recorder (``/flight``) and every recovery shows in
  ``/fleet`` (failovers, drains, restarts, autoscaler events), scraped
  live over HTTP from the run's own telemetry server.

Chaos is a timeline of :class:`ChaosEvent`\\ s, not a random spray:
``kill`` hard-kills a healthy replica (``router.kill_replica`` — the
SIGKILL emulation), ``stall_admit``/``stall_poll`` arm a one-shot
``stall`` at the ``serving.admit`` / ``autoscaler.poll`` fault sites,
``spawn_io_error`` arms a one-shot ``io_error`` at
``autoscaler.scale_up`` (the next spawn attempt dies and is retried
out of the bounded backoff budget), ``bitflip`` arms a one-shot
seeded bit flip in a live KV page at ``serving.step`` (silent state
corruption: at worst one request's output degrades — the fleet must
not notice), and ``poison_storm`` arms a content-matched
``poison_request`` spec (``ev.pattern``) and submits ``ev.count``
requests CARRYING that pattern — every replica they board dies, and
the run asserts the router's blast-radius containment quarantines
them while innocents keep the zero-loss guarantee.  Arming appends a
``FaultSpec(site, kind, occurrence=hits+1)`` to the installed
injector (the poison spec is content-matched instead — it fires on
every step whose batch carries the pattern), so each event fires
deterministically and fully audited (``report["injector_fired"]``).
"""
from __future__ import annotations

import dataclasses
import json
import time
import urllib.error
import urllib.request

from ..observability.flight import FlightRecorder
from ..observability.exporter import ResourceSampler, \
    start_telemetry_server
from ..observability.profiling import StackSampler, \
    phase as profiling_phase
from ..observability.slo import SLOEngine
from ..observability.timeseries import TimeSeriesStore
from ..resilience.faults import FaultInjector, FaultSpec, install, uninstall
from .autoscaler import Autoscaler
from .engine import SamplingParams
from .router import FleetRouter, FleetRequestState, ReplicaState

__all__ = ["ChaosEvent", "run_soak"]

_wall = time.perf_counter


@dataclasses.dataclass
class ChaosEvent:
    """One scheduled chaos action: at trace-time ``t`` (seconds from
    run start), do ``action`` — one of ``kill`` (hard replica death),
    ``stall_admit`` / ``stall_poll`` (one-shot stall at the
    ``serving.admit`` / ``autoscaler.poll`` site, ``stall_s`` long),
    ``spawn_io_error`` (one-shot OSError at ``autoscaler.scale_up``),
    ``bitflip`` (one-shot KV-page bit flip at ``serving.step`` —
    silent live-state corruption), ``poison_storm`` (arm a
    ``poison_request`` spec matching ``pattern`` and submit ``count``
    poison requests carrying it; their FleetRequest ids land in
    ``detail["request_ids"]``).  ``fired``/``detail`` are filled in by
    the run."""

    t: float
    action: str
    stall_s: float = 0.3
    pattern: tuple = None        # poison_storm: the token-ID pattern
    count: int = 3               # poison_storm: poison requests to send
    max_new_tokens: int = 8      # poison_storm: their decode budget
    fired: bool = False
    detail: object = None


def _percentile(values, pct):
    if not values:
        return None
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(pct / 100.0 * (len(vs) - 1)))))
    return vs[idx]


def _get_text(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def _get_json(url, timeout=5.0):
    return json.loads(_get_text(url, timeout))


def _fire_chaos(ev, router, inj, flight, log, reqs):
    """Apply one due chaos event; every action leaves a flight-recorder
    record so ``/flight`` shows the full chaos timeline.  Actions that
    submit traffic (``poison_storm``) append their FleetRequests to
    ``reqs`` so the run's accounting covers them."""
    detail = None
    if ev.action == "kill":
        victim = next((rep for rep in router.replicas
                       if rep.state == ReplicaState.HEALTHY), None)
        if victim is None:
            detail = "no healthy replica to kill"
        else:
            router.kill_replica(victim.replica_id)
            detail = {"replica": victim.replica_id}
    elif ev.action == "stall_admit":
        inj.specs.append(FaultSpec(
            "serving.admit", "stall",
            occurrence=inj.hits("serving.admit") + 1,
            stall_s=ev.stall_s))
        detail = {"site": "serving.admit", "stall_s": ev.stall_s}
    elif ev.action == "stall_poll":
        inj.specs.append(FaultSpec(
            "autoscaler.poll", "stall",
            occurrence=inj.hits("autoscaler.poll") + 1,
            stall_s=ev.stall_s))
        detail = {"site": "autoscaler.poll", "stall_s": ev.stall_s}
    elif ev.action == "spawn_io_error":
        inj.specs.append(FaultSpec(
            "autoscaler.scale_up", "io_error",
            occurrence=inj.hits("autoscaler.scale_up") + 1))
        detail = {"site": "autoscaler.scale_up"}
    elif ev.action == "bitflip":
        # one seeded bit flip in a live KV page on the next step: the
        # blast radius is at most the request whose page corrupted —
        # the fleet must sail on (no replica failure, no cascade)
        inj.specs.append(FaultSpec(
            "serving.step", "bitflip",
            occurrence=inj.hits("serving.step") + 1))
        detail = {"site": "serving.step"}
    elif ev.action == "poison_storm":
        if not ev.pattern:
            raise ValueError("poison_storm needs a token-ID pattern")
        pattern = tuple(int(t) for t in ev.pattern)
        inj.specs.append(FaultSpec(
            "serving.step", "poison_request", pattern=pattern))
        storm = [router.submit(list(pattern),
                               SamplingParams(
                                   max_new_tokens=ev.max_new_tokens))
                 for _ in range(int(ev.count))]
        reqs.extend(storm)
        detail = {"site": "serving.step", "pattern": list(pattern),
                  "request_ids": [r.id for r in storm]}
    else:
        raise ValueError(f"unknown chaos action {ev.action!r}")
    ev.fired = True
    ev.detail = detail
    with flight.record(f"soak::{ev.action}", group="chaos"):
        pass
    log.append({"t": ev.t, "action": ev.action, "detail": detail})


def run_soak(engine_factory, traffic, horizon_s, *,
             initial_replicas=2, chaos=(), scaler_kw=None,
             router_kw=None, registry=None, deadline_s=120.0,
             grace_s=10.0, min_down_events=1, ttft_bound_s=None,
             prewarm=True, telemetry=True, time_scale=1.0,
             slos=None, scrape_interval_s=0.05,
             rss_slope_bound_bytes_per_s=None, profile=True,
             burn_feedback=None):
    """Replay ``traffic.trace(horizon_s)`` through an autoscaled fleet
    under the ``chaos`` timeline; return the invariant report.

    ``engine_factory`` is the zero-arg factory both the initial fleet
    and every scale-up build through.  ``scaler_kw``/``router_kw``
    override :class:`Autoscaler`/:class:`FleetRouter` knobs.
    ``deadline_s`` hard-bounds the drive loop (wall time);
    ``grace_s`` bounds the post-trace settle loop that lets drains
    finish and the trough scale-down land (``min_down_events``).
    ``time_scale`` multiplies arrival timestamps (0.5 = replay the
    trace twice as fast).  ``ttft_bound_s`` is echoed into the report
    (``ttft_p99_ok``) when set.  With ``telemetry=True`` the run hosts
    its own telemetry server and the report's ``scraped`` section is
    fetched over live HTTP — the recoveries-visible-in-``/fleet``-and-
    ``/flight`` check, not an in-process shortcut.

    Every run hosts a :class:`TimeSeriesStore` scraping the router's
    registry (plus a :class:`ResourceSampler` feeding it) every
    ``scrape_interval_s``, wired into the autoscaler's windowed
    shed/goodput signals and the ``/timeseries`` endpoint; the report
    carries the whole-run RSS leak slope
    (``rss_slope_bytes_per_s``; ``rss_slope_ok`` when a bound is
    given).  Passing ``slos`` (a tuple of
    :class:`~paddle_tpu_torch.observability.slo.SLO`) adds an
    :class:`SLOEngine` evaluated at every scrape: its alert
    transitions land in ``report["slo"]`` and on the scraped ``/slo``
    endpoint, a firing page escalates the autoscaler, and the settle
    loop also waits (inside ``grace_s``) for every alert to clear
    through its hysteresis.

    ``profile=True`` (default) hosts a continuous
    :class:`~paddle_tpu_torch.observability.profiling.StackSampler`: the
    sampler thread runs for the whole soak, a firing SLO page arms a
    high-rate capture linked to the transition span, the report
    carries ``report["profiling"]`` (self-stats + finished captures),
    and the scraped section fetches the live ``/profilez`` payload.
    ``burn_feedback`` closes the load loop: ``True`` thins due
    arrivals by the run's own SLO burn
    (:meth:`~paddle_tpu_torch.observability.slo.SLOEngine.max_burn_rate`
    through :meth:`~.traffic.TrafficGenerator.feedback_factor`) but
    only *while a page is active* — backoff is a mitigation for a
    firing page, not a pre-emptive throttle, and thinning at sub-page
    burns would starve the short-window dispatch denominator the page
    detector itself needs (a traffic-free window reads as burn 0).  A
    callable supplies the burn itself, ungated, and ``None`` defers to
    the generator's own ``burn_feedback`` hook (open loop when
    absent).
    Thinning decisions use each arrival's pre-drawn ``u``, so the
    precomputed trace — and the replay contract — are untouched;
    drops are accounted in ``report["burn_feedback"]``, never counted
    as lost.

    The port takes one last scrape after the settle loop (the scraped
    gauges are the settled state's) and adds ``report["loop"]``: the
    drive loop's beats, its longest gap between two beats
    (``max_gap_s``: a respawn's engine build and graph capture stall
    the loop) and the host seconds spent scraping and evaluating
    (``observe_s``); and to ``scraped``, the
    ``/metrics`` text (``metrics``) and ``/timeseries``' windowed answer
    for ``router_dispatches_total`` over the whole run
    (``timeseries_query``)."""
    scaler_kw = dict(scaler_kw or {})
    router_kw = dict(router_kw or {})
    arrivals = traffic.trace(horizon_s)
    chaos = sorted((dataclasses.replace(ev) for ev in chaos),
                   key=lambda ev: ev.t)
    router_kw.setdefault("warmup", lambda eng: eng.warmup())
    router = FleetRouter([engine_factory] * int(initial_replicas),
                         registry=registry, **router_kw)
    store = TimeSeriesStore(registry=registry, clock=_wall,
                            interval_s=scrape_interval_s,
                            max_points=4096)
    sampler = ResourceSampler(registry=store.registry)
    profiler = None
    if profile:
        profiler = StackSampler(registry=store.registry,
                                tracer=router.tracer, clock=_wall)
    slo_engine = None
    if slos:
        slo_engine = SLOEngine(store, slos, registry=registry,
                               tracer=router.tracer, clock=_wall,
                               profiler=profiler)
        scaler_kw.setdefault("slo", slo_engine)
    scaler_kw.setdefault("timeseries", store)
    scaler = Autoscaler(router, engine_factory, registry=registry,
                        **scaler_kw)
    if prewarm:
        # pay every initial replica's first step (kernel load, graph
        # capture) before t=0 (scale-ups still pay theirs mid-run —
        # that's part of the scenario) while keeping the decode EWMA
        # unsampled: replicas start on the drain floor exactly like
        # freshly spawned ones
        for rep in router.replicas:
            rep.engine.warmup()
    flight = FlightRecorder()
    server = None
    if telemetry:
        server = start_telemetry_server(
            port=0, router=router, registry=registry,
            tracer=router.tracer, flight=flight,
            slo=slo_engine, timeseries=store, profiler=profiler)
    inj = install(FaultInjector([], seed=traffic.seed))
    if profiler is not None:
        profiler.start()
    # closed-loop load: resolve the burn source once, thin per arrival.
    # The engine-driven loop reports burn 0 until the page fires —
    # see the docstring for why backoff must be page-gated.
    feedback = None
    if burn_feedback is True and slo_engine is not None:
        def feedback(engine=slo_engine):
            return engine.max_burn_rate() if engine.page_active() \
                else 0.0
    elif callable(burn_feedback):
        feedback = burn_feedback
    fb_dropped, fb_dropped_page = 0, 0
    chaos_log, reqs = [], []
    timed_out = False
    t0 = _wall()
    last_scrape = None
    # the drive loop's own host time: the longest gap between two
    # beats (a respawn's engine build and capture stall the loop) and
    # the seconds spent scraping and evaluating — both share the GIL
    # with the router's and the engines' host work
    loop = {"beats": 0, "max_gap_s": 0.0, "observe_s": 0.0,
            "last": None}

    def _beat():
        now_w = _wall()
        if loop["last"] is not None:
            loop["max_gap_s"] = max(loop["max_gap_s"],
                                    now_w - loop["last"])
        loop["last"] = now_w
        loop["beats"] += 1

    def _observe():
        # one scrape+evaluate beat per scrape_interval_s of wall time:
        # resources → gauges → store point, then the SLO windows read
        # the fresh history (driven inline, never on a thread — the
        # soak is driven from one thread by design)
        nonlocal last_scrape
        now_w = _wall()
        if last_scrape is not None and \
                now_w - last_scrape < scrape_interval_s:
            return
        last_scrape = now_w
        with profiling_phase("scrape"):
            sampler.sample_once()
            store.scrape_once()
            if slo_engine is not None:
                slo_engine.evaluate()
        loop["observe_s"] += _wall() - now_w

    try:
        idx = 0
        while True:
            now = (_wall() - t0) / time_scale
            for ev in chaos:
                if not ev.fired and now >= ev.t:
                    _fire_chaos(ev, router, inj, flight, chaos_log,
                                reqs)
            while idx < len(arrivals) and arrivals[idx].t <= now:
                a = arrivals[idx]
                idx += 1
                # closed-loop backoff: keep iff u < factor (u is the
                # arrival's pre-drawn uniform; factor is 1.0 open-loop,
                # so nothing drops without feedback)
                factor = (traffic.feedback_factor(feedback())
                          if feedback is not None
                          else traffic.live_factor())
                if a.u >= factor:
                    fb_dropped += 1
                    if slo_engine is not None \
                            and slo_engine.page_active():
                        fb_dropped_page += 1
                    continue
                reqs.append(router.submit(a.prompt, SamplingParams(
                    max_new_tokens=a.max_new_tokens)))
            router.step()
            scaler.tick()
            _observe()
            _beat()
            if _wall() - t0 >= deadline_s:
                timed_out = True
                break
            if idx >= len(arrivals) and not router.has_work() and \
                    all(ev.fired for ev in chaos):
                break
        # settle: the trace is over and the fleet is idle — keep the
        # control loop beating so in-progress drains complete, the
        # quiet-trough scale-down lands (its cooldown may still be
        # running when the last request finishes), and every SLO alert
        # clears through its hysteresis (the storm's fire/clear pair
        # must both be on record before the report is cut)
        g0 = _wall()
        while _wall() - g0 < grace_s:
            router.step()
            scaler.tick()
            _observe()
            _beat()
            downs = scaler.status()["scale_events"]["down"]
            draining = any(rep.state == ReplicaState.DRAINING
                           for rep in router.replicas)
            alerts_pending = (slo_engine is not None
                              and slo_engine.alerts_active())
            if downs >= min_down_events and not draining and \
                    not router.has_work() and not alerts_pending:
                break
            time.sleep(0.002)
        # one last beat of the observer at the settled state, so the
        # gauges the report scrapes (device memory among them) are the
        # end state's and not up to one scrape interval older
        last_scrape = None
        _observe()
    finally:
        uninstall()
        if profiler is not None:
            profiler.stop()
    # ---- invariants -----------------------------------------------------
    ttfts = [r.t_first_token - r.t_submit for r in reqs
             if r.t_first_token is not None]
    finished = sum(1 for r in reqs
                   if r.state == FleetRequestState.FINISHED)
    quarantined = [r.id for r in reqs
                   if r.state == FleetRequestState.QUARANTINED]
    failed = [r.id for r in reqs
              if r.state == FleetRequestState.FAILED]
    fleet = router.fleet_status()
    # lost = requests in NO terminal state: a quarantined poison or a
    # row-failed request was contained and accounted, not lost
    terminal = (FleetRequestState.FINISHED, FleetRequestState.REJECTED,
                FleetRequestState.EVICTED, FleetRequestState.FAILED,
                FleetRequestState.QUARANTINED)
    lost = (sum(1 for r in reqs if r.state not in terminal)
            + int(fleet["counters"]["lost"]))
    p99 = _percentile(ttfts, 99)
    report = {
        "wall_s": _wall() - t0,
        "horizon_s": horizon_s,
        "timed_out": timed_out,
        "requests_submitted": len(reqs),
        "requests_finished": finished,
        "requests_quarantined": quarantined,
        "requests_failed": failed,
        # per-request outcome: lets callers parity-check innocents
        # against a poison-free oracle (greedy output is token-
        # identical no matter what was co-batched or quarantined)
        "requests": [{"id": r.id, "state": r.state,
                      "prompt": list(r.prompt), "output": r.output}
                     for r in reqs],
        "lost_requests": lost,
        "ttft_p50_s": _percentile(ttfts, 50),
        "ttft_p99_s": p99,
        "redispatched": fleet["counters"]["redispatched"],
        "scale_events": fleet.get("autoscaler", {}).get(
            "scale_events", {}),
        "spawn_failures": fleet.get("autoscaler", {}).get(
            "spawn_failures", 0),
        "chaos": chaos_log,
        "injector_fired": [{"site": s, "kind": k, "occurrence": o}
                           for s, k, o in inj.fired],
        "traffic": traffic.summary(horizon_s),
        "fleet": fleet,
        "flight": flight.summary(),
        "timeseries": store.stats(),
        # the leak query: least-squares RSS trend over the whole run
        # (bytes/s) — a soak that grows memory shows it here long
        # before the OOM killer would
        "rss_slope_bytes_per_s": store.slope(
            "process_rss_bytes", window_s=_wall() - t0 + 1.0),
        "loop": {"beats": loop["beats"],
                   "max_gap_s": loop["max_gap_s"],
                   "observe_s": loop["observe_s"]},
    }
    if rss_slope_bound_bytes_per_s is not None:
        slope = report["rss_slope_bytes_per_s"]
        report["rss_slope_bound_bytes_per_s"] = float(
            rss_slope_bound_bytes_per_s)
        report["rss_slope_ok"] = (
            slope is None
            or slope <= float(rss_slope_bound_bytes_per_s))
    if slo_engine is not None:
        report["slo"] = slo_engine.status()
    if profiler is not None:
        report["profiling"] = {"stats": profiler.stats(),
                               "captures": profiler.captures()}
    report["burn_feedback"] = {
        "enabled": (feedback is not None
                    or traffic.burn_feedback is not None),
        "dropped": fb_dropped,
        "dropped_while_page": fb_dropped_page,
    }
    if ttft_bound_s is not None:
        report["ttft_bound_s"] = float(ttft_bound_s)
        report["ttft_p99_ok"] = (p99 is not None
                                 and p99 <= float(ttft_bound_s))
    if server is not None:
        try:
            scraped = {"url": server.url,
                       "fleet": _get_json(server.url + "/fleet"),
                       "flight": _get_json(server.url + "/flight"),
                       # the merged fleet trace view: a hard-killed-and-
                       # failed-over request must read as ONE trace here
                       "traces": _get_json(
                           server.url + "/traces?fleet=1"),
                       "timeseries": _get_json(
                           server.url + "/timeseries"),
                       # the port's additions: the exposition (the
                       # resource gauges at the last scrape) and one
                       # windowed answer over the whole run
                       "metrics": _get_text(server.url + "/metrics"),
                       "timeseries_query": _get_json(
                           server.url + "/timeseries?name="
                           "router_dispatches_total&window_seconds="
                           f"{_wall() - t0 + 1.0:.3f}")}
            if slo_engine is not None:
                scraped["slo"] = _get_json(server.url + "/slo")
            if profiler is not None:
                scraped["profilez"] = _get_json(
                    server.url + "/profilez")
            try:
                scraped["healthz"] = _get_json(server.url + "/healthz")
                scraped["healthz_ok"] = True
            except urllib.error.HTTPError as e:
                # /healthz answers 503 when no replica can admit — a
                # fleet scaled to zero at the end of the settle is a
                # report field, not a crash
                scraped["healthz_ok"] = False
                scraped["healthz_status"] = e.code
            report["scraped"] = scraped
        finally:
            server.stop()
    return report
