from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)
from .tracing import (Span, TailRetention, TraceContext, Tracer, activate,
                      active_span, default_tracer, merge_traces)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "Span", "TailRetention", "TraceContext",
           "Tracer", "activate", "active_span", "default_tracer",
           "merge_traces"]
