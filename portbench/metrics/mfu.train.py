"""The training step's model FLOPs (``work.train_flops_per_token``: 6·N
+ 12·L·D·S a token, recompute not counted) at the traced run's rate,
as a share of the card's bf16 peak."""
from portbench import readers, work

LAYER = "training step (distributed/engine.py HybridEngine.step)"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "host_clock"


def read(ctx, out):
    run = out["run"]
    S = ctx.cell["traffic"]["seq_len"]
    flops = run["tokens"] * work.train_flops_per_token(ctx.config, S)
    return readers.peak_share(ctx, flops, run["window_s"])
