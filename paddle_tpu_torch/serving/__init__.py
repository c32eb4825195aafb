"""Continuous-batching serving over a paged KV cache, and the fleet above
it (the port of ``paddle_tpu.serving``'s engine, cache, metrics, router,
autoscaler and traffic model).

- :class:`Engine` — one replica: the unified chunked-prefill step over
  the paged pool, with the fleet surface (``health``,
  ``prefix_summary``, ``evacuate``, the ``serving.admit`` /
  ``serving.step`` fault sites).
- :class:`FleetRouter` — drain- and cache-aware dispatch over replicas,
  backpressure windows, circuit breakers, exactly-once failover,
  rolling restarts and poison containment (canary, quarantine, cascade
  breaker).
- :class:`Autoscaler` — the elastic control loop over a router.
- :class:`TrafficGenerator` — seeded diurnal + bursty arrivals with
  shared-prefix cohorts.

Prefix gossip over a store, the replica server, the soak harness and
the telemetry endpoints are later slices.
"""
from .engine import Engine, Request, RequestState, SamplingParams
from .kv_cache import PagedKVCache, prefix_hashes
from .metrics import AutoscalerMetrics, RouterMetrics, ServingMetrics
from .router import (FleetRequest, FleetRequestState, FleetRouter, Replica,
                     ReplicaState)
from .autoscaler import Autoscaler
from .traffic import Arrival, TrafficGenerator

__all__ = ["Engine", "SamplingParams", "Request", "RequestState",
           "PagedKVCache", "ServingMetrics", "prefix_hashes",
           "RouterMetrics", "AutoscalerMetrics", "FleetRouter",
           "FleetRequest", "FleetRequestState", "Replica", "ReplicaState",
           "Autoscaler", "Arrival", "TrafficGenerator"]
