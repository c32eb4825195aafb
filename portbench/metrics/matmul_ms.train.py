"""Device milliseconds a traced training step spends in GEMM kernels."""
from portbench import readers

LAYER = "model blocks (models/gpt.py, models/bert.py) forward and backward"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(ctx, out):
    return readers.ms_per_step(ctx, out, readers.is_gemm)
