from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)
from .tracing import Span, Tracer, default_tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "Span", "Tracer", "default_tracer"]
