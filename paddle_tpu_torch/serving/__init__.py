"""Continuous-batching serving over a paged KV cache (the port of
``paddle_tpu.serving``'s engine, cache and metrics)."""
from .engine import Engine, Request, RequestState, SamplingParams
from .kv_cache import PagedKVCache, prefix_hashes
from .metrics import ServingMetrics

__all__ = ["Engine", "SamplingParams", "Request", "RequestState",
           "PagedKVCache", "ServingMetrics", "prefix_hashes"]
