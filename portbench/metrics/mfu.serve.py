"""The forward FLOPs of the tokens the engine computed in the traced
run's window (``work.serve_step_flops``; prompt tokens the prefix cache
served are not computed), over the window, as a share of the card's
bf16 peak."""
from portbench import readers, work

LAYER = "serving step (serving/engine.py Engine.step)"
UNIT = "%"
MOVES = "serve_tokens_per_s"
SOURCE = "host_clock"


def read(ctx, out):
    run = out["run"]
    if not run["rows"]:
        return None
    flops = sum(work.serve_step_flops(ctx.config, rows)
                for rows in run["rows"])
    return readers.peak_share(ctx, flops, run["window_s"])
