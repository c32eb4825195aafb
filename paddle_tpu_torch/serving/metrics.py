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
in.  The router and autoscaler metric facades are later slices.
"""
from __future__ import annotations

from ..observability.metrics import (Counter, Gauge, Histogram,
                                     default_registry)

__all__ = ["ServingMetrics"]


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
