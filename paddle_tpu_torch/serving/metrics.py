"""Serving metrics — the engine's facade over the port's metrics registry
(the port of ``ServingMetrics`` in ``paddle_tpu/serving/metrics.py``):

  queue_wait   — submit -> admission (scheduler pressure)
  ttft         — submit -> first SAMPLED token, i.e. the step in which
                 the prompt's last chunk completed
  decode_token — per-token decode step time (steady-state speed)
  prefill_chunks — prompt chunks run through the unified step
  page_occupancy — page-pool utilisation gauge, 0..1 (hard use only:
                 evictable cached prefix pages count as free)
  prefix_cache_* — radix prefix-cache hits / hit tokens / LRU
                 evictions (counters) + cached pages (gauge)

Every metric is registered (serving_-prefixed) into the registry with
replace semantics, so rebuilding ``ServingMetrics`` swaps fresh series
in.  :class:`RouterMetrics` (``router_*``, per-replica labels) and
:class:`AutoscalerMetrics` (``autoscaler_*``) are the fleet's facades
over the same registry.
"""
from __future__ import annotations

from ..observability.metrics import (Counter, Gauge, Histogram,
                                     default_registry)

__all__ = ["ServingMetrics", "RouterMetrics", "AutoscalerMetrics"]


class ServingMetrics:
    """The engine's metric facade; snapshot() is the bench/ops surface.

    ``registry=None`` publishes into the process-wide default registry
    (pass an explicit MetricsRegistry to isolate, e.g. in tests)."""

    def __init__(self, registry=None):
        self.registry = default_registry() if registry is None else registry
        reg = self.registry

        def add(metric):
            return reg.register(metric, replace=True)

        self.requests_submitted = add(Counter(
            "serving_requests_submitted_total"))
        self.requests_admitted = add(Counter(
            "serving_requests_admitted_total"))
        self.requests_finished = add(Counter(
            "serving_requests_finished_total"))
        self.requests_rejected = add(Counter(
            "serving_requests_rejected_total"))
        self.requests_preempted = add(Counter(
            "serving_requests_preempted_total"))
        self.requests_shed = add(Counter(
            "serving_requests_shed_total",
            help="requests refused with RETRY_AFTER by watermark "
                 "load shedding"))
        self.deadline_evictions = add(Counter(
            "serving_deadline_evictions_total",
            help="requests evicted (mid-decode or queued) past their "
                 "deadline/TTL"))
        self.requests_failed = add(Counter(
            "serving_requests_failed_total",
            help="requests retired FAILED by per-row exception "
                 "isolation"))
        self.engine_healthy = add(Gauge(
            "serving_engine_healthy",
            help="1 = healthy (admitting), 0 = degraded (shedding)"))
        self.engine_healthy.set(1)
        self.prefix_cache_hits = add(Counter(
            "serving_prefix_cache_hits_total",
            help="admissions whose prompt prefix was served from the "
                 "radix cache"))
        self.prefix_cache_evictions = add(Counter(
            "serving_prefix_cache_evictions_total",
            help="zero-ref cached prefix pages LRU-evicted to make "
                 "room for new allocations"))
        self.prefix_hit_tokens = add(Counter(
            "serving_prefix_hit_tokens_total",
            help="prompt tokens served from the prefix cache"))
        self.prefix_cache_pages = add(Gauge(
            "serving_prefix_cache_pages",
            help="pages currently held by the radix prefix cache"))
        self.prefill_tokens = add(Counter("serving_prefill_tokens_total"))
        self.prefill_chunks = add(Counter(
            "serving_prefill_chunks_total",
            help="prompt chunks run through the unified step"))
        self.tokens_generated = add(Counter(
            "serving_tokens_generated_total"))
        self.queue_wait = add(Histogram("serving_queue_wait_seconds"))
        self.ttft = add(Histogram("serving_ttft_seconds"))
        self.decode_token = add(Histogram("serving_decode_token_seconds"))
        self.page_occupancy = add(Gauge("serving_page_occupancy"))
        self.queue_depth = add(Gauge(
            "serving_queue_depth",
            help="requests waiting in the admission queue"))
        self.estimated_drain_s = add(Gauge(
            "serving_estimated_drain_seconds",
            help="estimated seconds to drain all queued + running work "
                 "at the EWMA decode rate — the RETRY_AFTER hint"))

    def snapshot(self):
        return {
            "requests": {
                "submitted": self.requests_submitted.value,
                "admitted": self.requests_admitted.value,
                "finished": self.requests_finished.value,
                "rejected": self.requests_rejected.value,
                "preempted": self.requests_preempted.value,
                "shed": self.requests_shed.value,
                "deadline_evicted": self.deadline_evictions.value,
                "failed": self.requests_failed.value,
            },
            "engine_healthy": self.engine_healthy.value,
            "tokens": {
                "prefill": self.prefill_tokens.value,
                "prefill_chunks": self.prefill_chunks.value,
                "generated": self.tokens_generated.value,
            },
            "prefix_cache": {
                "hits": self.prefix_cache_hits.value,
                "hit_tokens": self.prefix_hit_tokens.value,
                "evictions": self.prefix_cache_evictions.value,
                "cached_pages": self.prefix_cache_pages.value,
            },
            "queue_wait_s": self.queue_wait.summary(),
            "ttft_s": self.ttft.summary(),
            "decode_token_s": self.decode_token.summary(),
            "page_occupancy": {"current": self.page_occupancy.value,
                               "peak": self.page_occupancy.peak},
            "queue_depth": self.queue_depth.value,
            "estimated_drain_s": self.estimated_drain_s.value,
        }

    def summary(self):
        """Human-readable one-screen summary (Profiler.summary style)."""
        s = self.snapshot()
        lines = [f"{'requests':<16} " + "  ".join(
            f"{k}={v}" for k, v in s["requests"].items())]
        lines.append(f"{'tokens':<16} prefill={s['tokens']['prefill']} "
                     f"generated={s['tokens']['generated']}")

        def ms(v):
            # an empty histogram reports None: a dash, not a crash
            return f"{v * 1e3:8.2f}ms" if v is not None else "       -"

        for key in ("queue_wait_s", "ttft_s", "decode_token_s"):
            h = s[key]
            lines.append(
                f"{key:<16} n={h['count']:<6} mean={ms(h['mean'])} "
                f"p50={ms(h['p50'])} p95={ms(h['p95'])}")
        occ = s["page_occupancy"]
        lines.append(f"{'page_occupancy':<16} current={occ['current']:.2f} "
                     f"peak={occ['peak']:.2f}")
        lines.append(f"{'health':<16} "
                     f"{'healthy' if s['engine_healthy'] else 'degraded'}")
        return "\n".join(lines)


class RouterMetrics:
    """Fleet-router metric facade (``router_*`` series, per-replica
    labels).  One instance per
    :class:`~paddle_tpu_torch.serving.FleetRouter`;
    like :class:`ServingMetrics` it registers into the default registry
    with replace semantics unless an explicit registry is passed."""

    def __init__(self, registry=None):
        self.registry = default_registry() if registry is None else registry
        reg = self.registry

        def add(metric):
            return reg.register(metric, replace=True)

        self.dispatches = add(Counter(
            "router_dispatches_total", labelnames=("replica",),
            help="requests handed to a replica engine (re-dispatches "
                 "after failover/drain included)"))
        self.failovers = add(Counter(
            "router_failovers_total", labelnames=("replica", "reason"),
            help="replica failures that opened the circuit breaker and "
                 "moved every in-flight request elsewhere"))
        self.redispatched = add(Counter(
            "router_redispatched_requests_total",
            help="in-flight requests re-enqueued off a failed or "
                 "drained replica (each exactly once per event)"))
        self.finished = add(Counter(
            "router_requests_finished_total",
            help="fleet requests harvested to FINISHED — the goodput "
                 "numerator the autoscaler reads"))
        self.backpressure_retries = add(Counter(
            "router_backpressure_retries_total", labelnames=("replica",),
            help="dispatches deferred because the replica answered "
                 "RETRY_AFTER (router backs off by the drain hint)"))
        self.cache_aware_dispatches = add(Counter(
            "router_cache_aware_dispatches_total",
            help="dispatches placed on a replica whose gossiped radix "
                 "summary predicted a prefix-cache hit for the request"))
        self.drains = add(Counter(
            "router_drains_total", labelnames=("replica",),
            help="graceful drains started (rolling restarts)"))
        self.restarts = add(Counter(
            "router_replica_restarts_total", labelnames=("replica",),
            help="replica engines rebuilt (post-drain or manual revive)"))
        self.lost = add(Counter(
            "router_requests_lost_total",
            help="requests the router could not place or recover — "
                 "MUST stay 0; anything else is a failover bug"))
        self.quarantined = add(Counter(
            "router_requests_quarantined_total",
            help="requests retired terminal QUARANTINED: suspected of "
                 "poisoning replicas and convicted by killing a canary "
                 "they ran on alone"))
        self.canary_dispatches = add(Counter(
            "router_canary_dispatches_total",
            help="suspect requests admitted alone to a reserved canary "
                 "replica (no co-batched innocents in the blast radius)"))
        self.canary_deaths = add(Counter(
            "router_canary_deaths_total",
            help="canary replicas killed by the lone suspect aboard — "
                 "each is a conviction, not a failover (the replica is "
                 "rebuilt, the request is quarantined, nothing is "
                 "re-dispatched)"))
        self.failure_events = add(Counter(
            "router_replica_failure_events_total",
            help="uncontrolled replica failures (breaker-opening "
                 "crashes/stalls/probe losses; canary deaths excluded) "
                 "— the cascade breaker's sliding-window input"))
        self.cascade_opens = add(Counter(
            "router_cascade_breaker_opens_total",
            help="times the fleet-wide cascade breaker opened "
                 "(>= K uncontrolled replica failures in the window)"))
        self.cascade_open = add(Gauge(
            "router_cascade_breaker_open",
            help="1 = cascade breaker open: suspected requests drain "
                 "through canary-only dispatch and the autoscaler "
                 "holds scale-up (poison is not load)"))
        self.suspects = add(Gauge(
            "router_suspected_requests",
            help="prompt-hash keys currently holding >= 1 suspicion "
                 "point (present at a replica failure)"))
        self.breaker_open = add(Gauge(
            "router_breaker_open", labelnames=("replica",),
            help="1 = circuit breaker open (replica out of rotation)"))
        self.replicas_admittable = add(Gauge(
            "router_replicas_admittable",
            help="replicas currently accepting new admissions"))
        self.fleet_healthy = add(Gauge(
            "router_fleet_healthy",
            help="1 = at least one replica can admit (the /healthz "
                 "fleet fold)"))
        self.pending_depth = add(Gauge(
            "router_pending_depth",
            help="requests waiting in the router queue (not yet on "
                 "any replica)"))
        self.ttft = add(Histogram(
            "router_ttft_seconds",
            help="fleet-level submit -> first token, failover and "
                 "backpressure delays included"))

    @staticmethod
    def _family(metric):
        return {",".join(lv) or "": child.snapshot_value()
                for lv, child in metric._series()}

    def snapshot(self):
        return {
            "dispatches": self._family(self.dispatches),
            "failovers": self._family(self.failovers),
            "redispatched": self.redispatched.value,
            "finished": self.finished.value,
            "backpressure_retries": self._family(self.backpressure_retries),
            "cache_aware_dispatches": self.cache_aware_dispatches.value,
            "drains": self._family(self.drains),
            "restarts": self._family(self.restarts),
            "lost": self.lost.value,
            "quarantined": self.quarantined.value,
            "canary_dispatches": self.canary_dispatches.value,
            "canary_deaths": self.canary_deaths.value,
            "failure_events": self.failure_events.value,
            "cascade_breaker_opens": self.cascade_opens.value,
            "cascade_breaker_open": self.cascade_open.value,
            "suspected_requests": self.suspects.value,
            "breaker_open": self._family(self.breaker_open),
            "replicas_admittable": self.replicas_admittable.value,
            "fleet_healthy": self.fleet_healthy.value,
            "pending_depth": self.pending_depth.value,
            "ttft_s": self.ttft.summary(),
        }


class AutoscalerMetrics:
    """Autoscaler metric facade (``autoscaler_*`` series).  One
    instance per :class:`~paddle_tpu_torch.serving.Autoscaler`; registers
    into the default registry with replace semantics unless an
    explicit registry is passed (the test-isolation idiom)."""

    def __init__(self, registry=None):
        self.registry = default_registry() if registry is None else registry
        reg = self.registry

        def add(metric):
            return reg.register(metric, replace=True)

        self.scale_events = add(Counter(
            "autoscaler_scale_events_total",
            labelnames=("direction", "reason"),
            help="scale decisions acted on — direction up|down, reason "
                 "pressure|pending|shed|no_capacity|idle"))
        self.spawn_failures = add(Counter(
            "autoscaler_spawn_failures_total",
            help="scale-up attempts that exhausted the bounded spawn "
                 "retry budget (backoff included) without a replica"))
        self.target_replicas = add(Gauge(
            "autoscaler_target_replicas",
            help="in-rotation replica count the last decision aimed "
                 "for (healthy count when holding steady)"))
        self.ready_replicas = add(Gauge(
            "autoscaler_ready_replicas",
            help="healthy replicas with a real decode-rate sample — "
                 "warming replicas are excluded from capacity"))
        self.pressure = add(Gauge(
            "autoscaler_pressure_seconds",
            help="fleet pressure signal: mean estimated drain seconds "
                 "per ready replica plus the pending-depth term"))

    def snapshot(self):
        return {
            "scale_events": RouterMetrics._family(self.scale_events),
            "spawn_failures": self.spawn_failures.value,
            "target_replicas": self.target_replicas.value,
            "ready_replicas": self.ready_replicas.value,
            "pressure_s": self.pressure.value,
        }
