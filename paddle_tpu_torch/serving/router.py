"""Fault-tolerant serving fleet — the multi-replica router (the port of
``paddle_tpu/serving/router.py``).

One engine (``serving/engine.py``) is fast; a fleet of them is only
*survivable* if something above the replicas treats failure as routine.
Every engine exports the router signals — health, queue depth,
``estimated_drain_s``, soft ``RETRY_AFTER`` with a machine-readable
back-off hint — and this module is their consumer:

- **drain-based load balancing** — new admissions go to the replica
  with the smallest ``estimated_drain_s`` (queue depth breaks ties),
  so a slow or backlogged replica sheds traffic to its peers instead
  of growing an unbounded queue.
- **cache-aware placement** — every replica publishes a bounded radix
  summary of its prefix cache (chain hashes of cached page-aligned
  prefixes + hit stats; in-process fleets pull
  ``engine.prefix_summary()`` directly, and ``prefix_summary_source``
  takes a cross-process collector).  Dispatch scores each
  candidate by ``drain − expected_hit_tokens × cache_hit_token_s``:
  a request whose system prompt is warm on replica 2 goes there even
  when replica 1 is marginally less drained — the prefill FLOPs
  avoided outweigh the wait.  The summary is advisory: the chosen
  replica re-walks its OWN tree at admission (failover re-dispatches
  included), so stale gossip can only cost FLOPs, never correctness
  or the exactly-once guarantee.
- **backpressure, not hammering** — a replica answering RETRY_AFTER is
  put in a per-replica back-off window: ``max(retry_after_s hint,
  jittered exponential delay)`` capped at ``backoff_cap_s`` (the delay
  generator is :func:`paddle_tpu_torch.resilience.retry.backoff_delays` —
  the same full-jitter scheme every other blocking edge uses).  The
  window resets on the next successful dispatch.
- **failure detection + circuit breaker** — a replica fails by raising
  ``OSError`` from ``step()``/``add_request()``/``health()`` (a real
  deployment's RPC error; the ``serving.step`` io_error fault site
  reproduces it deterministically), by wedging in admission (wall time
  over ``stall_timeout_s``; the ``serving.admit`` stall site), or by
  missing ``probe_miss_threshold`` consecutive health probes.  After
  ``breaker_threshold`` failures the per-replica circuit breaker
  opens: the replica leaves rotation (``router_breaker_open`` = 1)
  until it is explicitly restarted.
- **zero-loss failover** — when a breaker opens, every in-flight
  request assigned to that replica is re-enqueued **exactly once** at
  the head of the router queue, as an ordinary admission carrying
  ``prompt + already-harvested tokens``.  The dead replica's paged KV
  state is rebuilt elsewhere, never trusted; only tokens harvested
  after a *completed* step count as emitted, so nothing is delivered
  twice and greedy output stays token-identical to an un-failed run
  (the engine's own recompute-parity guarantee, lifted to the fleet).
- **blast-radius containment** — replica failures are attributed to
  *requests*, not just replicas.  Every request aboard at an
  uncontrolled replica failure earns one suspicion point (keyed by
  prompt hash, so failover re-dispatches and retries accumulate); a
  request present at ≥ ``canary_threshold`` distinct failures is only
  ever dispatched ALONE on a reserved *canary* replica, and killing
  the canary too convicts it: terminal ``QUARANTINED`` with the
  failure evidence attached, never re-dispatched.  Canary deaths are
  controlled (the replica restarts from its factory; counted in
  ``router_canary_deaths_total``, not the failure window).  A *cascade
  breaker* opens at ≥ ``cascade_threshold`` uncontrolled failures
  inside ``cascade_window_s``: every suspect (≥ 1 point) then goes
  through canary trial before rejoining normal dispatch, a
  ``router::cascade`` span brackets the storm, and the autoscaler
  holds scale-up while the breaker is open (poison is not load).
  Innocent co-batched requests keep the exactly-once token-identical
  failover guarantee throughout — re-dispatch replays
  ``prompt + harvested tokens`` and host-side greedy sampling is
  batch-composition-independent, so a neighbour's quarantine never
  perturbs their output.
- **graceful drain / rolling restart** — :meth:`FleetRouter.drain`
  marks a replica draining: no new admissions, in-flight decode runs
  to completion bounded by a drain deadline, stragglers are
  re-dispatched exactly once, then the replica's engine is rebuilt
  from its factory and re-enters rotation.  Restart a whole fleet one
  replica at a time with zero dropped requests.

Observability: ``router_*`` metrics (dispatches / failovers /
backpressure retries / breaker state / restarts per replica, fleet
TTFT histogram), tracer spans ``router::dispatch`` /
``router::failover`` / ``router::drain``, and the ``/fleet`` and
``/healthz`` payloads as :meth:`FleetRouter.fleet_status` and
:meth:`FleetRouter.fleet_health` (the telemetry server that serves
them is a later slice of the port).

On the card, two things differ from the JAX router:

- **A replica that leaves rotation lets its engine go.**  An engine
  holds its KV pool on the device (gigabytes at full width), so when a
  breaker opens, a drain ends without a restart, or a restart rebuilds
  the engine, the router first evacuates the old engine and then drops
  its last reference (a :class:`_DeadEngine` keeps only its tracer, so
  :meth:`FleetRouter.collect_traces` still reads its ring); a restart
  builds the new engine after the old one is gone.  The JAX router
  keeps a dead replica's engine until it is restarted.
- **Only synchronous errors are attributed to the step that raised
  them.**  A kernel launch is asynchronous: a device fault surfaces at
  the next synchronisation, which may be another replica's step.  The
  exactly-once contract rests on a failing ``step()`` raising before
  any request state changed — true of the ``serving.step`` fault site,
  which fires before the step queues any work, and of host-side
  failures; an asynchronous device error is not contained that way.

Clocks: scheduling (backpressure windows, drain deadlines, TTLs) reads
the injectable ``clock``; stall detection always uses the real
``time.perf_counter``, because an injected stall sleeps wall time no
matter what the logical clock says.  Replica engines should share the
router's clock so TTL hand-off across failover stays coherent.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import deque

from ..observability.tracing import (Tracer, activate, default_tracer,
                                     merge_traces)
from ..resilience.faults import fault_point
from ..resilience.retry import backoff_delays
from .engine import Engine, RequestState, SamplingParams
from .kv_cache import prefix_hashes
from .metrics import RouterMetrics

__all__ = ["FleetRouter", "FleetRequest", "FleetRequestState",
           "Replica", "ReplicaState"]

_wall = time.perf_counter      # stall detection is real elapsed time


class ReplicaState:
    HEALTHY = "healthy"        # in rotation (may be shedding — that's soft)
    DRAINING = "draining"      # no new admissions; finishing in-flight work
    DEAD = "dead"              # breaker open / drained-out; needs restart


class FleetRequestState:
    PENDING = "pending"        # in the router queue, on no replica
    DISPATCHED = "dispatched"  # admitted to some replica's scheduler
    FINISHED = "finished"
    REJECTED = "rejected"      # infeasible on the replica that saw it
    EVICTED = "evicted"        # fleet-level TTL passed
    FAILED = "failed"          # the replica's per-row isolation pinned an
    #                            exception on THIS request (terminal)
    QUARANTINED = "quarantined"  # convicted poison: suspected at >= 2
    #                              replica failures, then killed the
    #                              canary it ran on alone (terminal,
    #                              evidence attached — never re-dispatched)


@dataclasses.dataclass
class FleetRequest:
    """The router's view of one request across dispatches.

    ``tokens_out`` holds every token *harvested* so far — synced from
    the current replica after each successful step, and the only token
    state that survives a failover (what a streaming front-end has
    already sent downstream).  ``redispatches`` counts how many times
    the request was pulled off a failed/drained replica; the zero-loss
    tests assert it is exactly 1 per failure event."""

    id: int
    prompt: list
    sampling: SamplingParams
    state: str = FleetRequestState.PENDING
    tokens_out: list = dataclasses.field(default_factory=list)
    replica_id: int = None
    finish_reason: str = None
    dispatches: int = 0
    redispatches: int = 0
    t_submit: float = 0.0
    t_first_token: float = None
    t_finished: float = None
    deadline: float = None       # router-clock absolute; None = no TTL
    quarantine_evidence: dict = None   # set iff state == QUARANTINED
    _engine_req: object = None   # Request on the current replica
    _dispatch_base: int = 0      # len(tokens_out) when this dispatch began
    _span: object = None         # root trace span
    _prompt_key: int = 0         # content hash — suspicion is keyed by
    #                              prompt so retries/failovers accumulate

    @property
    def output(self):
        return list(self.tokens_out)


class Replica:
    """One engine slot in the fleet: the live engine, its factory (how
    a rolling restart rebuilds it), breaker/backpressure bookkeeping."""

    def __init__(self, replica_id, engine, factory=None):
        self.replica_id = replica_id
        self.engine = engine
        self.factory = factory
        self.state = ReplicaState.HEALTHY
        self.consecutive_failures = 0
        self.probe_misses = 0
        self.not_before = 0.0          # backpressure window (router clock)
        self.backoff = None            # lazy backoff_delays generator
        self.drain_deadline = None
        self.restart_after_drain = True
        self._drain_span = None
        self.canary_for = None         # FleetRequest.id reserved alone here

    def __repr__(self):
        return (f"Replica({self.replica_id}, {self.state}, "
                f"failures={self.consecutive_failures})")


class _DeadEngine:
    """Stand-in for a hard-killed replica process: every access fails
    the way a connection to a dead host does, so the router's normal
    detection path — failed step, missed probe — finds the corpse.  It
    holds no engine; a retired engine's ``tracer`` may ride along so the
    fleet trace view keeps its ring (a hard kill passes none: a SIGKILL
    loses the ring too)."""

    def __init__(self, replica_id, tracer=None):
        object.__setattr__(self, "_rid", replica_id)
        if tracer is not None:
            object.__setattr__(self, "tracer", tracer)

    def __getattr__(self, name):
        raise OSError(f"replica {self._rid} process is dead "
                      f"(attempted .{name})")


class FleetRouter:
    """Health-routed fan-out over N in-process serving engines.

    ``replicas`` is a list whose items are either zero-arg callables
    returning a fresh :class:`~paddle_tpu_torch.serving.Engine` (the normal
    form — restarts rebuild through the factory) or live ``Engine``
    instances (restart unavailable).  Drive it like an engine:
    :meth:`submit` then :meth:`step` in a loop, or :meth:`generate`.

    Knobs: ``breaker_threshold`` failures open a replica's breaker
    (default 1 — fail fast, re-dispatch is exactly-once and cheap);
    ``probe_miss_threshold`` consecutive failed health probes count as
    one failure path; ``stall_timeout_s`` bounds the *wall* time an
    admission may take before the replica is declared wedged;
    ``backoff_base_s``/``backoff_cap_s`` shape the jittered
    backpressure window; ``drain_deadline_s`` is the default rolling-
    restart drain budget; ``warmup`` (a callable taking an Engine) runs
    on every factory-rebuilt engine before it re-enters rotation, so a
    restarted replica doesn't serve its first request cold.

    Cache-aware placement: ``cache_aware`` (default on) folds each
    replica's expected prefix-cache hit into the dispatch score at
    ``cache_hit_token_s`` seconds of credit per hit token.
    ``prefix_summary_source`` (a zero-arg callable returning
    ``{replica_id: summary}``, a cross-process collector) replaces the
    default in-process ``engine.prefix_summary()`` pull.
    ``clock``/``tracer``/``registry`` mirror the engine's injection
    points."""

    def __init__(self, replicas, *, clock=None, tracer=None, registry=None,
                 breaker_threshold=1, probe_miss_threshold=2,
                 stall_timeout_s=0.25, backoff_base_s=0.05,
                 backoff_cap_s=2.0, drain_deadline_s=5.0, warmup=None,
                 cache_aware=True, cache_hit_token_s=0.01,
                 prefix_summary_source=None, rng=None,
                 canary_threshold=2, cascade_threshold=3,
                 cascade_window_s=10.0):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.warmup = warmup
        self._clock = clock or time.perf_counter
        if tracer is None:
            tracer = (default_tracer() if clock is None
                      else Tracer(clock=self._clock))
        self.tracer = tracer
        self.metrics = RouterMetrics(registry=registry)
        self.breaker_threshold = int(breaker_threshold)
        self.probe_miss_threshold = int(probe_miss_threshold)
        self.stall_timeout_s = float(stall_timeout_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.drain_deadline_s = float(drain_deadline_s)
        # cache-aware dispatch: score replicas by expected prefix-hit
        # length jointly with the drain estimate.  Each hit token is
        # worth ``cache_hit_token_s`` seconds of avoided prefill in the
        # score (default ~one assumed decode-step per token), so a warm
        # replica beats an equally-drained cold one but a deeply
        # backlogged warm replica still loses to an idle cold peer.
        self.cache_aware = bool(cache_aware)
        self.cache_hit_token_s = float(cache_hit_token_s)
        self._summary_source = prefix_summary_source
        # blast-radius containment: a request in flight at a replica
        # failure earns one suspicion point per DISTINCT failure event
        # (keyed by prompt hash).  At ``canary_threshold`` points it is
        # only ever dispatched alone, on a canary replica; killing the
        # canary too is conviction -> terminal QUARANTINED.
        # ``cascade_threshold`` uncontrolled replica failures inside
        # ``cascade_window_s`` open the fleet cascade breaker: suspects
        # (>=1 point) drain through canary mode only, and the attached
        # autoscaler treats the storm as poison, not load.
        self.canary_threshold = int(canary_threshold)
        self.cascade_threshold = int(cascade_threshold)
        self.cascade_window_s = float(cascade_window_s)
        self._suspects = {}          # prompt_key -> set(failure event ids)
        # prompt_key -> conviction evidence: the verdict OUTLIVES the
        # convicted request, so a storm of requests all carrying the
        # same poison content is quarantined at admission after the
        # first conviction instead of serially re-killing canaries
        self._convicted = {}
        self._failure_seq = 0        # distinct uncontrolled failure events
        self._failure_times = deque()  # their router-clock timestamps
        self._cascade_open = False
        self._cascade_span = None
        self._rng = rng or random
        self.replicas = []
        for item in replicas:
            rid = len(self.replicas)
            # a callable (that isn't itself an engine) is a factory —
            # restarts rebuild through it; anything else is taken as a
            # live engine-shaped object (restart unavailable)
            if callable(item) and not isinstance(item, Engine):
                self.replicas.append(Replica(rid, item(), factory=item))
            else:
                self.replicas.append(Replica(rid, item, factory=None))
            self.metrics.breaker_open.labels(replica=str(rid)).set(0)
        # the telemetry server's scrape thread reads fleet_status()/
        # fleet_health()/has_work() while the driving thread mutates
        # routing state mid-step — serialize on one re-entrant lock
        # (step() nests into helpers that retake it)
        self._lock = threading.RLock()
        self._pending = deque()     # guarded-by: self._lock
        # guarded-by: self._lock
        self._assigned = {rep.replica_id: {} for rep in self.replicas}
        self._next_id = 0           # guarded-by: self._lock
        # per-replica radix gossip: the freshest bounded prefix summary
        # each replica published (direct engine pull, or a TCPStore
        # collector via prefix_summary_source)
        self._prefix_summaries = {}  # guarded-by: self._lock
        self._autoscaler = None      # attach_autoscaler() wires one
        self._update_gauges()

    # ------------------------------------------------------------- lookup
    def _rep(self, replica_id):
        for rep in self.replicas:
            if rep.replica_id == replica_id:
                return rep
        raise KeyError(f"no replica {replica_id!r}")

    # ------------------------------------------------------------- submit
    def submit(self, prompt, sampling: SamplingParams = None):
        """Enqueue a prompt with the router; returns a
        :class:`FleetRequest`.  Dispatch to a replica happens on the
        next :meth:`step` (drain-based placement needs fresh health)."""
        sampling = sampling or SamplingParams()
        now = self._clock()
        with self._lock:
            freq = FleetRequest(id=self._next_id, prompt=list(prompt),
                                sampling=sampling, t_submit=now)
            # suspicion is tracked by CONTENT, not request id: a poison
            # prompt re-submitted (or failover re-dispatched) keeps
            # accumulating points instead of starting innocent
            freq._prompt_key = hash(tuple(freq.prompt))
            self._next_id += 1
            if sampling.ttl_s is not None:
                # the fleet-level deadline: survives failover (the
                # remaining budget, not a fresh TTL, rides to the next
                # replica)
                freq.deadline = now + float(sampling.ttl_s)
            freq._span = self.tracer.start_trace(
                f"fleet#{freq.id}", start_s=now,
                attributes={"request_id": freq.id,
                            "prompt_len": len(freq.prompt),
                            "max_new_tokens": sampling.max_new_tokens})
            self._pending.append(freq)
            self.metrics.pending_depth.set(len(self._pending))
        return freq

    # ----------------------------------------------------------- lifecycle
    def _finish(self, freq, state, reason):
        freq.state = state
        freq.finish_reason = reason
        freq.t_finished = self._clock()
        if freq._span is not None:
            freq._span.set_attributes({
                "state": state, "finish_reason": reason,
                "tokens_out": len(freq.tokens_out),
                "dispatches": freq.dispatches,
                "redispatches": freq.redispatches})
            freq._span.end(freq.t_finished)
            freq._span = None

    def _harvest(self, rep, finished):
        """Sync sampled tokens off ``rep`` after a successful step and
        retire requests the engine finished.  Harvested tokens are the
        failover ground truth — what the fleet has already emitted."""
        with self._lock:
            table = self._assigned[rep.replica_id]
            self._harvest_table(table, finished)
            if rep.canary_for is not None and rep.canary_for not in table:
                # the canaried suspect reached a terminal state without
                # killing its host: the reservation lifts
                rep.canary_for = None

    def _harvest_table(self, table, finished):
        for freq in list(table.values()):
            ereq = freq._engine_req
            out = ereq.output
            # engine preemption rewinds ereq.output and replays the
            # identical tokens; never un-harvest on the rewind
            if len(out) > len(freq.tokens_out) - freq._dispatch_base:
                freq.tokens_out[freq._dispatch_base:] = list(out)
                if freq.t_first_token is None and freq.tokens_out:
                    freq.t_first_token = self._clock()
                    self.metrics.ttft.observe(
                        freq.t_first_token - freq.t_submit,
                        exemplar=getattr(freq._span, "trace_id", None))
            if ereq.state == RequestState.FINISHED:
                del table[freq.id]
                self._finish(freq, FleetRequestState.FINISHED,
                             ereq.finish_reason)
                self.metrics.finished.inc()
                # completing normally exonerates the prompt: a suspect
                # that survives a full run was collateral, not poison
                self._suspects.pop(freq._prompt_key, None)
                finished.append(freq)
            elif ereq.state == RequestState.EVICTED:
                del table[freq.id]
                self._finish(freq, FleetRequestState.EVICTED,
                             ereq.finish_reason)
                self._suspects.pop(freq._prompt_key, None)
                finished.append(freq)
            elif ereq.state == RequestState.FAILED:
                # the engine's per-row isolation pinned an exception on
                # this specific request — terminal at fleet level too,
                # never re-dispatched (the failure is deterministic to
                # the row, not the replica)
                del table[freq.id]
                self._finish(freq, FleetRequestState.FAILED,
                             ereq.finish_reason)
                self._suspects.pop(freq._prompt_key, None)
                finished.append(freq)

    # ------------------------------------------------------------ failure
    def _reclaim(self, rep, reason="failover", exc=None,
                 failure_event=None):
        """Pull every request assigned to ``rep`` back into the router
        queue (front, original admission order), each exactly once.
        Only tokens harvested after a completed step ride along — the
        re-dispatch admission is ``prompt + tokens_out``, so the next
        replica rebuilds KV state from scratch and cannot double-emit.
        ``failure_event`` (a distinct uncontrolled-failure id) charges
        every reclaimed request one suspicion point — all of them were
        aboard when the replica died, and one of them may be why.  Each
        moved request gets a ``router::failover`` child span on ITS OWN
        fleet trace — the original trace continues through re-dispatch
        instead of being severed at the most interesting moment."""
        with self._lock:
            table = self._assigned[rep.replica_id]
            # sort by request id (== admission order): the assignment
            # table is keyed per-dispatch, so relying on dict insertion
            # order would re-enqueue a mixed harvest (original + prior
            # failovers) in arbitrary relative order
            moved = sorted(table.values(), key=lambda f: f.id)
            table.clear()
            rep.canary_for = None
            try:
                # frees the abandoned engine's pages (and closes
                # request traces) when it is still reachable; a
                # hard-dead engine has nothing left to salvage
                rep.engine.evacuate()
            except Exception:
                pass  # silent-ok: a hard-dead engine has nothing to free
            now = self._clock()
            for freq in reversed(moved):
                freq.state = FleetRequestState.PENDING
                freq.replica_id = None
                freq._engine_req = None
                freq.redispatches += 1
                if failure_event is not None:
                    self._suspects.setdefault(
                        freq._prompt_key, set()).add(failure_event)
                if freq._span is not None:
                    self.tracer.start_span(
                        "router::failover", freq._span, start_s=now,
                        attributes={
                            "replica": rep.replica_id, "reason": reason,
                            "error": (repr(exc) if exc is not None
                                      else None),
                            "harvested_tokens": len(freq.tokens_out),
                        }).end(now)
                self._pending.appendleft(freq)
                self.metrics.redispatched.inc()
            self.metrics.pending_depth.set(len(self._pending))
        return moved

    def _on_replica_failure(self, rep, reason, exc=None):
        """Count a failure against ``rep``; at ``breaker_threshold``
        open the breaker and fail everything over.  A canary replica
        dying under its lone suspect is handled as a conviction
        (quarantine + controlled restart) instead — it never feeds the
        cascade window, because the blast was contained by design."""
        if rep.state == ReplicaState.DEAD:
            return
        rep.consecutive_failures += 1
        if rep.consecutive_failures < self.breaker_threshold:
            return
        with self._lock:
            if rep.canary_for is not None and \
                    self._assigned[rep.replica_id]:
                self._on_canary_death(rep, reason, exc)
                return
            rep.canary_for = None   # reservation died before admission
        if rep._drain_span is not None:      # failed mid-drain
            rep._drain_span.set_attributes({"failed": reason})
            rep._drain_span.end()
            rep._drain_span = None
        rep.state = ReplicaState.DEAD
        rep.drain_deadline = None
        rid = str(rep.replica_id)
        self.metrics.breaker_open.labels(replica=rid).set(1)
        self.metrics.failovers.labels(replica=rid, reason=reason).inc()
        # an UNCONTROLLED failure: distinct event id charges suspicion
        # to everything aboard, its timestamp feeds the cascade window
        now = self._clock()
        with self._lock:
            self._failure_seq += 1
            event = self._failure_seq
            self._failure_times.append(now)
            self.metrics.failure_events.inc()
            self._maybe_open_cascade_locked(now)
        # no standalone failover trace: the event lands as a
        # router::failover span on every affected request's own trace
        # (see _reclaim), so the timeline survives the re-dispatch
        self._reclaim(rep, reason=reason, exc=exc, failure_event=event)
        self._retire(rep)
        self._update_gauges()

    def _retire(self, rep):
        """Drop the router's reference to ``rep``'s engine (evacuated
        already, or hard-dead): its device pool is freed now, not at a
        restart that may never come.  The tracer stays reachable."""
        try:
            tracer = rep.engine.tracer
        except (OSError, AttributeError):
            tracer = None
        rep.engine = _DeadEngine(rep.replica_id, tracer)

    def _on_canary_death(self, rep, reason, exc):
        """The canary replica died while running its suspect ALONE —
        conclusive guilt.  The suspect goes terminal ``QUARANTINED``
        with the evidence attached (never re-dispatched), the canary is
        rebuilt from its factory (a controlled death: counted in
        ``canary_deaths``, not in the cascade window — the blast radius
        was exactly one reserved replica).  Caller holds ``self._lock``."""
        table = self._assigned[rep.replica_id]
        victims = sorted(table.values(), key=lambda f: f.id)
        table.clear()
        rep.canary_for = None
        try:
            rep.engine.evacuate()
        except Exception:
            pass  # silent-ok: a hard-dead engine has nothing to free
        self.metrics.canary_deaths.inc()
        for freq in victims:
            self._quarantine_locked(freq, rep, reason, exc)
        if rep.factory is not None:
            self._restart(rep)
        else:
            rep.state = ReplicaState.DEAD
            self._retire(rep)
            self.metrics.breaker_open.labels(
                replica=str(rep.replica_id)).set(1)
        self._update_gauges()

    def _quarantine_locked(self, freq, rep, reason, exc):
        evidence = {
            "suspicion": len(self._suspects.get(freq._prompt_key, ())),
            "failure_events": sorted(
                self._suspects.get(freq._prompt_key, ())),
            "canary_replica": rep.replica_id,
            "reason": reason,
            "error": repr(exc) if exc is not None else None,
        }
        freq.quarantine_evidence = evidence
        self._convicted[freq._prompt_key] = evidence
        self._suspects.pop(freq._prompt_key, None)
        if freq._span is not None:
            self.tracer.start_span(
                "router::quarantine", freq._span,
                start_s=self._clock(),
                attributes=dict(evidence)).end(self._clock())
        self._finish(freq, FleetRequestState.QUARANTINED,
                     f"poison request: killed canary replica "
                     f"{rep.replica_id} ({reason})")
        self.metrics.quarantined.inc()

    # --------------------------------------------------- cascade breaker
    def _trim_failure_window_locked(self, now):
        cutoff = now - self.cascade_window_s
        while self._failure_times and self._failure_times[0] <= cutoff:
            self._failure_times.popleft()

    def _maybe_open_cascade_locked(self, now):
        self._trim_failure_window_locked(now)
        if self._cascade_open or \
                len(self._failure_times) < self.cascade_threshold:
            return
        self._cascade_open = True
        self.metrics.cascade_opens.inc()
        self.metrics.cascade_open.set(1)
        self._cascade_span = self.tracer.start_trace(
            "router::cascade", start_s=now,
            attributes={"failures_in_window": len(self._failure_times),
                        "threshold": self.cascade_threshold,
                        "window_s": self.cascade_window_s})

    def _maybe_close_cascade_locked(self, now):
        if not self._cascade_open:
            return
        self._trim_failure_window_locked(now)
        if self._failure_times:
            return            # a failure is still inside the window
        if any(rep.canary_for is not None for rep in self.replicas):
            return            # a suspect is mid-trial on a canary
        if any(self._suspicion_locked(f) > 0 for f in self._pending):
            return            # suspects still queued for canary trial
        self._cascade_open = False
        self.metrics.cascade_open.set(0)
        if self._cascade_span is not None:
            self._cascade_span.set_attribute(
                "quarantined_total", int(self.metrics.quarantined.value))
            self._cascade_span.end(now)
            self._cascade_span = None

    def _suspicion_locked(self, freq):
        return len(self._suspects.get(freq._prompt_key, ()))

    def cascade_open(self):
        """Whether the fleet cascade breaker is open (>= K uncontrolled
        replica failures inside the sliding window; suspects draining
        through canary mode).  The autoscaler reads this to keep a
        poison storm from masquerading as load."""
        with self._lock:
            return self._cascade_open

    # ---------------------------------------------------- prefix gossip
    def _refresh_prefix_summaries(self):
        """Pull the freshest per-replica radix summaries: from the
        configured gossip source (a TCPStore collector) when one is
        wired, else straight off each live engine.  A replica whose
        summary can't be fetched keeps its previous one — stale gossip
        only mis-scores a dispatch, it never blocks one."""
        if self._summary_source is not None:
            try:
                fresh = dict(self._summary_source())
            except Exception:   # silent-ok: stale gossip is tolerated —
                return          # scoring falls back to the last summaries
        else:
            fresh = {}
            for rep in self.replicas:
                if rep.state != ReplicaState.HEALTHY:
                    continue
                try:
                    fresh[rep.replica_id] = rep.engine.prefix_summary()
                except (OSError, AttributeError):
                    continue    # dead/foreign engine: keep what we had
        with self._lock:
            self._prefix_summaries.update(fresh)

    def _expected_hit_tokens_locked(self, tokens, replica_id,
                                    hash_cache=None):
        """Expected prefix-cache hit length (tokens) of an admission
        carrying ``tokens`` on ``replica_id``, from its gossiped
        summary: hash the prompt's page-aligned prefixes client-side
        and take the deepest hash the replica's radix summary knows.
        The hash chain depends only on the prompt and the page size —
        ``hash_cache`` (page_size -> chain) lets the _admit loop hash a
        queue head once and score every candidate replica against it.
        Caller holds ``self._lock`` (summaries are shared state)."""
        summary = self._prefix_summaries.get(replica_id)
        if not summary or not summary.get("enabled", True):
            return 0
        entries = summary.get("entries") or {}
        if not entries:
            return 0
        page_size = int(summary.get("page_size") or 16)
        if hash_cache is None:
            hash_cache = {}
        hashes = hash_cache.get(page_size)
        if hashes is None:
            hashes = hash_cache[page_size] = prefix_hashes(
                tokens, page_size)
        best = 0
        for i, h in enumerate(hashes):
            if h in entries:
                best = (i + 1) * page_size
        return min(best, max(len(tokens) - 1, 0))

    # -------------------------------------------------------------- admit
    def _can_admit(self, rep, now):
        # a replica reserved as a canary admits ONLY its suspect: no
        # innocent may be co-batched with a request on trial
        return (rep.state == ReplicaState.HEALTHY
                and now >= rep.not_before
                and rep.canary_for is None)

    def _pick_canary_locked(self, now):
        """An idle healthy replica to run a suspect ALONE on — nothing
        assigned, no reservation, admission window open.  Lowest id
        wins (determinism)."""
        cands = [rep for rep in self.replicas
                 if rep.state == ReplicaState.HEALTHY
                 and rep.canary_for is None
                 and now >= rep.not_before
                 and not self._assigned[rep.replica_id]]
        return min(cands, key=lambda r: r.replica_id) if cands else None

    def _backpressure(self, rep, hint_s, now):
        """RETRY_AFTER from ``rep``: close its admission window for
        max(drain hint, jittered exponential delay), capped — bounded
        backoff that neither hammers nor abandons a loaded replica."""
        if rep.backoff is None:
            rep.backoff = backoff_delays(base=self.backoff_base_s,
                                         cap=self.backoff_cap_s,
                                         rng=self._rng)
        delay = min(self.backoff_cap_s,
                    max(float(hint_s or 0.0), next(rep.backoff)))
        rep.not_before = now + delay
        self.metrics.backpressure_retries.labels(
            replica=str(rep.replica_id)).inc()
        return delay

    def _dispatch_locked(self, freq, rep, now, expected_hit=0,
                         canary=False):
        """Try the queue-head request on ``rep`` (caller holds
        ``self._lock`` — the ``_admit`` loop owns the queue while it
        places work).  ``expected_hit`` is the gossip-predicted prefix
        hit length that steered the placement (telemetry only — the
        target replica re-walks its own tree at admission, so a stale
        prediction costs FLOPs, never correctness).  Returns one of
        "dispatched" / "backpressure" / "rejected" / "evicted" /
        "failed" (replica, not request, at fault)."""
        already = len(freq.tokens_out)
        kw = {"max_new_tokens": freq.sampling.max_new_tokens - already}
        if freq.deadline is not None:
            remaining = freq.deadline - now
            if remaining <= 0:
                self._pending.popleft()
                self._finish(freq, FleetRequestState.EVICTED, "deadline")
                return "evicted"
            kw["ttl_s"] = remaining
        esp = dataclasses.replace(freq.sampling, **kw)
        # the dispatch span is a CHILD of the fleet trace, opened
        # *before* admission so its context rides ``add_request`` into
        # the engine: the replica's request#N segment parents here, and
        # a fault firing inside admission lands on this span (activate)
        dattrs = {"request_id": freq.id, "replica": rep.replica_id,
                  "expected_prefix_hit_tokens": expected_hit,
                  "redispatch": freq.redispatches > 0}
        if canary:
            dattrs["canary"] = True
        if freq._span is not None:
            dspan = self.tracer.start_span("router::dispatch", freq._span,
                                           start_s=now, attributes=dattrs)
        else:
            dspan = self.tracer.start_trace("router::dispatch",
                                            start_s=now, attributes=dattrs)
        t0 = _wall()
        try:
            with activate(dspan):
                ereq = rep.engine.add_request(
                    freq.prompt + freq.tokens_out, esp,
                    trace_context=dspan.context())
        except OSError as e:
            dspan.set_attributes({"outcome": "replica_failed",
                                  "error": repr(e)}).end()
            self._on_replica_failure(rep, "io_error", e)
            return "failed"
        except BaseException as e:
            # SimulatedCrash (and any other non-OSError) rides through;
            # the span still closes so the trace shows where it died
            dspan.set_attribute("error", repr(e)).end()
            raise
        stalled = (_wall() - t0) > self.stall_timeout_s
        if ereq.state == RequestState.RETRY_AFTER:
            dspan.set_attribute("outcome", "backpressure").end()
            self._backpressure(rep, ereq.retry_after_s, now)
            if stalled:
                self._on_replica_failure(rep, "stall")
            return "backpressure"
        if ereq.state == RequestState.REJECTED:
            dspan.set_attribute("outcome", "rejected").end()
            self._pending.popleft()
            self._finish(freq, FleetRequestState.REJECTED,
                         ereq.finish_reason)
            return "rejected"
        # QUEUED: the replica's scheduler owns it now
        self._pending.popleft()
        freq.state = FleetRequestState.DISPATCHED
        freq.replica_id = rep.replica_id
        freq._engine_req = ereq
        freq._dispatch_base = already
        freq.dispatches += 1
        self._assigned[rep.replica_id][freq.id] = freq
        rep.backoff = None                   # successful admission resets
        self.metrics.dispatches.labels(replica=str(rep.replica_id)).inc()
        if expected_hit > 0:
            self.metrics.cache_aware_dispatches.inc()
        dspan.set_attribute("outcome", "dispatched").end()
        if stalled:
            # admission wedge (serving.admit stall site): the request IS
            # assigned, so the failure path reclaims it exactly once
            self._on_replica_failure(rep, "stall")
        return "dispatched"

    def _canary_dispatch_locked(self, head, now, suspicion, skip):
        """Route the queue-head suspect to a canary: an idle healthy
        replica reserved for it ALONE.  Returns ``"wait"`` when no
        replica is free to canary on (the head blocks; in-flight work
        keeps completing elsewhere, so a replica frees up next ticks),
        otherwise the ``_dispatch_locked`` status.  Caller holds
        ``self._lock``."""
        rep = self._pick_canary_locked(now)
        if rep is None or rep.replica_id in skip:
            return "wait"
        try:
            # the canary-dispatch RPC edge: an injected io_error here
            # is a transient dispatch failure — the suspect stays at
            # the queue head and the trial retries next tick
            fault_point("router.canary_dispatch")
        except OSError:
            return "wait"
        rep.canary_for = head.id
        self.metrics.canary_dispatches.inc()
        if head._span is not None:
            self.tracer.start_span(
                "router::canary", head._span, start_s=now,
                attributes={"replica": rep.replica_id,
                            "suspicion": suspicion}).end(now)
        status = self._dispatch_locked(head, rep, now, canary=True)
        if status != "dispatched":
            rep.canary_for = None
        if status in ("backpressure", "failed"):
            skip.add(rep.replica_id)
        return status

    def _admit(self, now):
        """Place queued requests on the best admittable replica.  The
        score is the drain estimate MINUS the expected prefix-cache
        credit (hit tokens x cache_hit_token_s): the fleet routes a
        shared-system-prompt request to the replica already holding its
        prefix unless that replica's backlog outweighs the prefill it
        would save.  A backpressuring or failing replica is skipped for
        the rest of this tick."""
        skip = set()
        with self._lock:
            while self._pending:
                head = self._pending[0]
                verdict = self._convicted.get(head._prompt_key)
                if verdict is not None:
                    # identical content to an already-convicted poison:
                    # the kill is deterministic, so skip the canary and
                    # quarantine on the sibling's evidence
                    self._pending.popleft()
                    head.quarantine_evidence = dict(
                        verdict, convicted_sibling=True)
                    if head._span is not None:
                        self.tracer.start_span(
                            "router::quarantine", head._span,
                            start_s=now,
                            attributes=dict(
                                head.quarantine_evidence)).end(now)
                    self._finish(
                        head, FleetRequestState.QUARANTINED,
                        "poison request: prompt content already "
                        "convicted")
                    self.metrics.quarantined.inc()
                    continue
                suspicion = self._suspicion_locked(head)
                if suspicion >= self.canary_threshold or \
                        (self._cascade_open and suspicion >= 1):
                    # suspect: canary trial only — alone, on a reserved
                    # replica, so a kill convicts exactly one request
                    # and co-batched innocents don't exist to lose
                    status = self._canary_dispatch_locked(
                        head, now, suspicion, skip)
                    if status == "wait":
                        break       # no idle replica to canary on yet
                    continue
                admission_tokens = head.prompt + head.tokens_out
                hash_cache = {}    # page_size -> prefix hash chain
                cands = []
                for rep in self.replicas:
                    if rep.replica_id in skip or \
                            not self._can_admit(rep, now):
                        continue
                    try:
                        h = rep.engine.health()
                    except OSError as e:
                        self._on_replica_failure(rep, "probe", e)
                        continue
                    drain = float(h.get("estimated_drain_s") or 0.0)
                    hit = (self._expected_hit_tokens_locked(
                        admission_tokens, rep.replica_id, hash_cache)
                        if self.cache_aware else 0)
                    cands.append(
                        (drain - hit * self.cache_hit_token_s,
                         (h.get("queue_depth") or 0)
                         + (h.get("running") or 0),
                         rep.replica_id, rep, hit))
                if not cands:
                    break
                cands.sort(key=lambda c: c[:3])
                rep, hit = cands[0][3], cands[0][4]
                status = self._dispatch_locked(head, rep, now,
                                               expected_hit=hit)
                if status in ("backpressure", "failed"):
                    skip.add(rep.replica_id)
            self.metrics.pending_depth.set(len(self._pending))

    # --------------------------------------------------------------- drain
    def drain(self, replica_id, deadline_s=None, restart=True):
        """Graceful rolling-restart entry: stop admitting to the
        replica, let in-flight decode finish within the deadline
        (stragglers re-dispatched), then rebuild its engine from the
        factory and re-enter rotation (``restart=False`` leaves it out
        of rotation instead)."""
        rep = self._rep(replica_id)
        if rep.state != ReplicaState.HEALTHY:
            raise ValueError(f"replica {replica_id} is {rep.state}; only "
                             f"a healthy replica can start draining")
        if restart and rep.factory is None:
            raise ValueError(f"replica {replica_id} has no factory; "
                             f"drain(restart=False) or rebuild manually")
        rep.state = ReplicaState.DRAINING
        rep.drain_deadline = self._clock() + (
            self.drain_deadline_s if deadline_s is None else
            float(deadline_s))
        rep.restart_after_drain = restart
        with self._lock:
            in_flight = len(self._assigned[replica_id])
        rep._drain_span = self.tracer.start_trace(
            "router::drain",
            attributes={"replica": replica_id,
                        "deadline_s": rep.drain_deadline,
                        "in_flight": in_flight})
        self.metrics.drains.labels(replica=str(replica_id)).inc()
        self._update_gauges()
        return rep

    def _finish_drain(self, rep, now):
        stragglers = self._reclaim(rep, reason="drain_deadline")
        if rep._drain_span is not None:
            rep._drain_span.set_attributes(
                {"stragglers": len(stragglers),
                 "deadline_hit": bool(stragglers)})
            rep._drain_span.end(now)
            rep._drain_span = None
        rep.drain_deadline = None
        if rep.restart_after_drain:
            self._restart(rep)
        else:
            rep.state = ReplicaState.DEAD
            self._retire(rep)
            self.metrics.breaker_open.labels(
                replica=str(rep.replica_id)).set(1)

    # ------------------------------------------------------------- restart
    def _restart(self, rep):
        # the old engine goes before the new one is built: two pools of
        # one replica never share the card
        self._retire(rep)
        eng = rep.factory()
        if self.warmup is not None:
            # e.g. a tiny generate() that compiles the unified step:
            # a replica re-enters rotation warm, so the first real
            # request routed to it doesn't pay the compile
            self.warmup(eng)
        rep.engine = eng
        rep.state = ReplicaState.HEALTHY
        rep.consecutive_failures = 0
        rep.probe_misses = 0
        rep.not_before = 0.0
        rep.backoff = None
        rep.drain_deadline = None
        self.metrics.breaker_open.labels(replica=str(rep.replica_id)).set(0)
        self.metrics.restarts.labels(replica=str(rep.replica_id)).inc()
        self._update_gauges()

    def restart_replica(self, replica_id):
        """Rebuild a dead/drained replica's engine from its factory and
        close the breaker — the fleet supervisor's revive hook."""
        rep = self._rep(replica_id)
        if rep.factory is None:
            raise ValueError(f"replica {replica_id} was built from a "
                             f"live Engine, not a factory — cannot "
                             f"restart")
        self._restart(rep)
        return rep

    def kill_replica(self, replica_id):
        """Emulate a hard replica death (process SIGKILL): the engine
        is replaced by a stub whose every access raises ``OSError``, so
        the normal detection path — failed step, missed probe — finds
        the corpse on the next tick.  Test/bench/ops hook."""
        rep = self._rep(replica_id)
        rep.engine = _DeadEngine(replica_id)
        return rep

    def add_replica(self, factory):
        """Append fresh capacity mid-flight: build an engine through
        ``factory`` (zero-arg callable), run the router warmup on it,
        and enter it into rotation — the autoscaler's scale-up path.
        The engine is built and warmed *before* the replica becomes
        visible, so in-rotation replicas are never half-constructed."""
        if not callable(factory):
            raise ValueError("add_replica needs a zero-arg engine "
                             "factory (restarts rebuild through it)")
        eng = factory()
        if self.warmup is not None:
            self.warmup(eng)
        with self._lock:
            rid = max((r.replica_id for r in self.replicas),
                      default=-1) + 1
            rep = Replica(rid, eng, factory=factory)
            self.replicas.append(rep)
            self._assigned[rid] = {}
            self.metrics.breaker_open.labels(replica=str(rid)).set(0)
        self._update_gauges()
        return rep

    # ---------------------------------------------------------------- step
    def step(self):
        """One fleet tick: advance every live replica one scheduler
        step (harvesting outputs and detecting failures), progress
        drains, probe health, then place queued requests.  Returns the
        fleet requests that reached a terminal state this tick."""
        now = self._clock()
        finished = []
        for rep in self.replicas:
            if rep.state == ReplicaState.DEAD:
                continue
            try:
                has_work = rep.engine.has_work()
            except OSError as e:
                self._on_replica_failure(rep, "crash", e)
                continue
            if not has_work or (rep.state == ReplicaState.DRAINING
                                and now >= rep.drain_deadline):
                continue          # deadline-hit drains reclaim below
            try:
                rep.engine.step()
            except OSError as e:
                self._on_replica_failure(rep, "io_error", e)
                continue
            rep.consecutive_failures = 0
            self._harvest(rep, finished)
        # drain completion runs after the step pass so the tick that
        # harvests a draining replica's last request also restarts it —
        # callers looping on has_work() never strand a drain
        for rep in self.replicas:
            if rep.state != ReplicaState.DRAINING:
                continue
            try:
                drained = not rep.engine.has_work()
            except OSError as e:
                self._on_replica_failure(rep, "crash", e)
                continue
            if drained or now >= rep.drain_deadline:
                self._finish_drain(rep, now)
        # health probes: a wedged-but-idle replica never fails a step,
        # so the probe path is what retires it
        for rep in self.replicas:
            if rep.state == ReplicaState.DEAD:
                continue
            try:
                rep.engine.health()
                rep.probe_misses = 0
            except OSError as e:
                rep.probe_misses += 1
                if rep.probe_misses >= self.probe_miss_threshold:
                    self._on_replica_failure(rep, "probe", e)
        if self.cache_aware:
            # refresh the radix gossip before placement so this tick's
            # admissions (failover re-dispatches included) score
            # against each target replica's current tree
            self._refresh_prefix_summaries()
        self._admit(now)
        with self._lock:
            # re-read the clock: a poison trial earlier in this tick
            # may have burned real window time (canary restart)
            self._maybe_close_cascade_locked(self._clock())
            self.metrics.suspects.set(len(self._suspects))
        self._update_gauges()
        return finished

    def has_work(self):
        with self._lock:
            return bool(self._pending) or \
                any(self._assigned[rep.replica_id]
                    for rep in self.replicas)

    def pending_depth(self):
        """Requests waiting in the router queue (on no replica yet) —
        one of the autoscaler's scale-up signals."""
        with self._lock:
            return len(self._pending)

    def in_flight_counts(self):
        """``{replica_id: requests currently assigned}`` — the
        autoscaler's victim-selection tie-break input."""
        with self._lock:
            return {rep.replica_id: len(self._assigned[rep.replica_id])
                    for rep in self.replicas}

    def prefix_summaries(self):
        """The freshest gossiped radix summary per replica (a copy) —
        the autoscaler scores cache warmth from these."""
        with self._lock:
            return dict(self._prefix_summaries)

    def refresh_prefix_summaries(self):
        """Public refresh hook: re-pull every replica's radix summary
        now (the autoscaler calls this before picking a drain victim,
        so warmth scores reflect the current trees, not the last
        dispatch tick's)."""
        self._refresh_prefix_summaries()

    def attach_autoscaler(self, scaler):
        """Surface ``scaler.status()`` inside the ``/fleet`` payload.
        The fold happens after the router lock is released (the
        autoscaler takes its own lock *before* calling router methods,
        so the two locks must never interleave the other way)."""
        self._autoscaler = scaler
        return scaler

    def generate(self, prompts, sampling=None):
        """Batch convenience mirroring ``Engine.generate``: submit all,
        step the fleet until every request is terminal (or no replica
        is left alive), return each request's output tokens."""
        if sampling is None or isinstance(sampling, SamplingParams):
            sampling = [sampling] * len(prompts)
        reqs = [self.submit(p, s) for p, s in zip(prompts, sampling)]
        while self.has_work():
            if all(rep.state == ReplicaState.DEAD
                   for rep in self.replicas):
                break                     # nobody left to run on
            self.step()
        return [r.output for r in reqs]

    # -------------------------------------------------------------- health
    def _update_gauges(self):
        admittable = sum(1 for rep in self.replicas
                         if rep.state == ReplicaState.HEALTHY)
        self.metrics.replicas_admittable.set(admittable)
        self.metrics.fleet_healthy.set(1 if admittable else 0)

    def fleet_health(self):
        """The ``/healthz`` fleet fold: healthy iff at least one
        replica can admit new work.  A single shedding replica is a
        soft signal (its own RETRY_AFTER says so) — only a fleet where
        every breaker is open or every replica is draining is down."""
        with self._lock:
            per = {}
            for rep in self.replicas:
                per[str(rep.replica_id)] = {
                    "state": rep.state,
                    "breaker_open": rep.state == ReplicaState.DEAD,
                    "in_flight": len(self._assigned[rep.replica_id]),
                }
            admittable = sum(1 for rep in self.replicas
                             if rep.state == ReplicaState.HEALTHY)
            # the cascade breaker being open is SOFT while any replica
            # can still admit: suspects drain through canary trials and
            # innocents keep flowing, so /healthz must not 503
            return {"healthy": admittable > 0,
                    "replicas_admittable": admittable,
                    "replicas_total": len(self.replicas),
                    "pending": len(self._pending),
                    "quarantined": int(self.metrics.quarantined.value),
                    "suspects": len(self._suspects),
                    "cascade_breaker_open": self._cascade_open,
                    "replicas": per}

    def fleet_status(self):
        """The ``/fleet`` endpoint payload: per-replica state + live
        engine health (guarded — a dead replica reports its error
        instead of wedging the scrape) and the router counters."""
        now = self._clock()
        with self._lock:
            per = {}
            for rep in self.replicas:
                entry = {
                    "state": rep.state,
                    "breaker_open": rep.state == ReplicaState.DEAD,
                    "consecutive_failures": rep.consecutive_failures,
                    "probe_misses": rep.probe_misses,
                    "backpressure_for_s": max(0.0,
                                              rep.not_before - now),
                    "in_flight": len(self._assigned[rep.replica_id]),
                    "restartable": rep.factory is not None,
                    "canary_for": rep.canary_for,
                }
                if rep.drain_deadline is not None:
                    entry["drain_deadline_in_s"] = \
                        rep.drain_deadline - now
                try:
                    entry["engine"] = rep.engine.health()
                except OSError as e:
                    entry["engine"] = {"error": repr(e)}
                summary = self._prefix_summaries.get(rep.replica_id)
                if summary is not None:
                    entry["prefix_cache"] = {
                        "enabled": summary.get("enabled", True),
                        "summary_entries": len(summary.get("entries")
                                               or {}),
                        **(summary.get("stats") or {})}
                per[str(rep.replica_id)] = entry
            out = self.fleet_health()
            out["replicas"] = per
            out["cache_aware"] = self.cache_aware
            out["counters"] = self.metrics.snapshot()
        # autoscaler fold OUTSIDE the router lock: status() takes the
        # autoscaler's lock, and ticks take that lock before calling
        # into the router — folding under the router lock would
        # interleave the two in opposite orders (deadlock hazard)
        scaler = self._autoscaler
        if scaler is not None:
            try:
                out["autoscaler"] = scaler.status()
            except Exception as e:
                out["autoscaler"] = {"error": repr(e)}
        return out

    def collect_traces(self, limit=None):
        """The in-process fleet trace view: the router's ring plus each
        live replica engine's ring, merged by trace_id
        (:func:`~paddle_tpu_torch.observability.tracing.merge_traces`)
        — the ``/traces?fleet=1`` payload when the fleet shares one
        process.
        Tracer objects shared between router and engines (the
        default-tracer case) are read once; a replica whose tracer is
        unreachable (hard-killed engine stub) is skipped — exactly the
        information a SIGKILLed process would lose.  Cross-process
        fleets (a later slice of the port) gather rings over the store
        instead."""
        rings = [("router", self.tracer.traces(limit=limit))]
        seen = {id(self.tracer)}
        for rep in self.replicas:
            try:
                tracer = rep.engine.tracer
            except Exception:
                continue    # silent-ok: a dead engine's ring died with it
            if tracer is None or id(tracer) in seen:
                continue
            seen.add(id(tracer))
            rings.append((f"replica{rep.replica_id}",
                          tracer.traces(limit=limit)))
        return merge_traces(rings)
