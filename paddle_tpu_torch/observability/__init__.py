"""Observability of the port (the counterpart of
``paddle_tpu/observability``): metrics, request tracing, the compile
watchdog (``compile_watchdog``: builds of a watched step, here the
CUDA-graph captures of the serving and the training steps) and the
sampling profiler
(``profiling``: ``StackSampler`` and the ``phase`` markers the serving
engine sets)."""
from .compile_watchdog import (CompileWatchdog, WatchedFunction,
                               default_watchdog, disable_compile_watchdog,
                               enable_compile_watchdog, watch,
                               watchdog_enabled)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)
from .profiling import PROFILING_SERIES, StackSampler, current_phase, \
    diff_profiles
from .profiling import phase as profiling_phase
from .tracing import (Span, TailRetention, TraceContext, Tracer, activate,
                      active_span, active_span_for_thread, default_tracer,
                      merge_traces)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "Span", "TailRetention", "TraceContext",
           "Tracer", "activate", "active_span", "active_span_for_thread",
           "default_tracer", "merge_traces", "CompileWatchdog",
           "WatchedFunction", "default_watchdog", "watch",
           "enable_compile_watchdog", "disable_compile_watchdog",
           "watchdog_enabled", "StackSampler", "profiling_phase",
           "current_phase", "diff_profiles", "PROFILING_SERIES"]
