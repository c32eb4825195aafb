"""Observability of the port (the counterpart of
``paddle_tpu/observability``): metrics, request tracing, the compile
watchdog (``compile_watchdog``: builds of a watched step, here the
CUDA-graph captures of the serving and the training steps) and the
sampling profiler
(``profiling``: ``StackSampler`` and the ``phase`` markers the serving
engine sets), and the training health layer: ``goodput``
(``GoodputMonitor``, MFU against ``PEAK_FLOPS``) and ``health``
(``HealthMonitor``, ``TrainingHealthError``); across ranks, ``aggregate``
(``RankMetricsPublisher`` / ``ClusterAggregator`` over the world's
``TCPStore``) and ``flight``, the distributed flight recorder
(``FlightRecorder``, ``record_collective``, ``HangWatchdog``); and the
serving half of the plane: ``timeseries`` (``TimeSeriesStore``, the
windowed history over a registry), ``slo`` (``SLO``, ``BurnRateAlert``,
``SLOEngine``: error budgets and multi-window burn-rate alerts),
``exporter`` (``start_telemetry_server``: ``/metrics``, ``/varz``,
``/healthz``, ``/traces``, ``/flight``, ``/fleet``, ``/integrity``,
``/slo``, ``/profilez``, ``/timeseries``; ``ResourceSampler``), and the
store-plane gossip of ``trace_gossip`` (``TraceRingPublisher``,
``collect_fleet_traces``) and ``slo_gossip`` (``SLOStatusPublisher``,
``collect_fleet_slo``, ``merge_fleet_slo``)."""
from .aggregate import (ClusterAggregator, RankMetricsPublisher,
                        StorePublisher)
from .exporter import (ResourceSampler, TelemetryServer,
                       start_telemetry_server)
from .compile_watchdog import (CompileWatchdog, WatchedFunction,
                               default_watchdog, disable_compile_watchdog,
                               enable_compile_watchdog, watch,
                               watchdog_enabled)
from .flight import (CollectiveRecord, FlightRecorder, HangWatchdog,
                     default_flight_recorder, record_collective,
                     thread_stacks, use_flight_recorder)
from .goodput import (PEAK_FLOPS, GoodputMonitor, TrainingCallback,
                      device_peak_flops, last_report, mfu)
from .health import HealthMonitor, TrainingHealthError
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)
from .profiling import PROFILING_SERIES, StackSampler, current_phase, \
    diff_profiles
from .profiling import phase as profiling_phase
from .slo import SEVERITIES, SLO, BurnRateAlert, SLOEngine
from .slo_gossip import (SLOStatusPublisher, collect_fleet_slo,
                         collect_slo_statuses, merge_fleet_slo)
from .timeseries import TimeSeriesStore
from .trace_gossip import (TraceRingPublisher, collect_fleet_traces,
                           collect_trace_rings)
from .tracing import (Span, TailRetention, TraceContext, Tracer, activate,
                      active_span, active_span_for_thread, default_tracer,
                      export_traces_chrome, merge_traces,
                      traces_to_chrome_events)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "Span", "TailRetention", "TraceContext",
           "Tracer", "activate", "active_span", "active_span_for_thread",
           "default_tracer", "merge_traces", "CompileWatchdog",
           "WatchedFunction", "default_watchdog", "watch",
           "enable_compile_watchdog", "disable_compile_watchdog",
           "watchdog_enabled", "StackSampler", "profiling_phase",
           "current_phase", "diff_profiles", "PROFILING_SERIES",
           "GoodputMonitor", "PEAK_FLOPS", "device_peak_flops", "mfu",
           "last_report", "TrainingCallback", "HealthMonitor",
           "TrainingHealthError", "StorePublisher",
           "RankMetricsPublisher", "ClusterAggregator", "CollectiveRecord",
           "FlightRecorder", "HangWatchdog", "default_flight_recorder",
           "use_flight_recorder", "record_collective", "thread_stacks",
           "traces_to_chrome_events", "export_traces_chrome",
           "ResourceSampler", "TelemetryServer", "start_telemetry_server",
           "TimeSeriesStore", "SEVERITIES", "SLO", "BurnRateAlert",
           "SLOEngine", "SLOStatusPublisher", "collect_slo_statuses",
           "collect_fleet_slo", "merge_fleet_slo", "TraceRingPublisher",
           "collect_trace_rings", "collect_fleet_traces"]
