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
  shared-prefix cohorts, thinned live by an SLO burn when asked.
- :class:`PrefixSummaryPublisher` / :func:`collect_prefix_summaries` —
  prefix-cache gossip over a ``TCPStore``, the source a cross-process
  ``FleetRouter(prefix_summary_source=)`` reads.
- :class:`ReplicaServer` — one replica process's serve loop with its
  prefix and trace publishers.
- :func:`run_soak` / :class:`ChaosEvent` — the chaos soak: a seeded
  trace through an autoscaled fleet under a timeline of kills, stalls,
  spawn errors, bit flips and poison storms, with its own time series,
  SLO engine, sampler and telemetry server (the endpoints live in
  ``paddle_tpu_torch.observability.exporter``).
"""
from .engine import Engine, Request, RequestState, SamplingParams
from .kv_cache import PagedKVCache, prefix_hashes
from .metrics import AutoscalerMetrics, RouterMetrics, ServingMetrics
from .router import (FleetRequest, FleetRequestState, FleetRouter, Replica,
                     ReplicaState)
from .autoscaler import Autoscaler
from .traffic import Arrival, TrafficGenerator
from .prefix_gossip import PrefixSummaryPublisher, collect_prefix_summaries
from .replica import ReplicaServer
from .soak import ChaosEvent, run_soak

__all__ = ["Engine", "SamplingParams", "Request", "RequestState",
           "PagedKVCache", "ServingMetrics", "prefix_hashes",
           "RouterMetrics", "AutoscalerMetrics", "FleetRouter",
           "FleetRequest", "FleetRequestState", "Replica", "ReplicaState",
           "Autoscaler", "Arrival", "TrafficGenerator",
           "PrefixSummaryPublisher", "collect_prefix_summaries",
           "ReplicaServer", "ChaosEvent", "run_soak"]
