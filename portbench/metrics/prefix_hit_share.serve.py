"""The share of the prompt tokens admitted in the window that the prefix
cache served: the engine's ``hit_tokens`` counter over the prompts."""
LAYER = "prefix cache (serving/kv_cache.py)"
UNIT = "%"
MOVES = "ttft_p95_ms"
SOURCE = "program_counter"


def read(ctx, out):
    run = out["run"]
    c0, c1 = run["counters"]
    if not run["prompt_tokens_admitted"]:
        return None
    return (c1["hit_tokens"] - c0["hit_tokens"]) \
        / run["prompt_tokens_admitted"] * 100.0
