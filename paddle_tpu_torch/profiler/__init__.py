"""Profiler (the port of ``paddle_tpu/profiler``; parity:
paddle/fluid/platform/profiler/ + python/paddle/profiler/).

Host-side RecordEvent tracing with chrome-trace export, composed with
``torch.profiler``'s device trace (CUPTI, as the reference's CudaTracer).
Step-aware scheduling (``make_scheduler``) and metric counter tracks come
from the ``paddle_tpu_torch.observability`` layer.
"""
from .profiler import (  # noqa: F401
    Profiler,
    ProfilerState,
    ProfilerTarget,
    RecordEvent,
    export_chrome_tracing,
    make_scheduler,
)
from .timer import Benchmark  # noqa: F401
