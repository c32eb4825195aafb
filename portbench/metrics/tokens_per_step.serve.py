"""Tokens a serving step computes, over the window: the engine's counters
of prompt tokens prefilled and tokens generated, over its step count."""
LAYER = "scheduler (serving/engine.py)"
UNIT = "tokens/step"
MOVES = "serve_tokens_per_s"
SOURCE = "program_counter"


def read(ctx, out):
    c0, c1 = out["run"]["counters"]
    steps = c1["steps"] - c0["steps"]
    if not steps:
        return None
    return (c1["prefill"] - c0["prefill"] + c1["generated"]
            - c0["generated"]) / steps
