"""Device milliseconds a traced training step spends in operations that
are neither GEMMs nor the port's attention kernels: the elementwise
passes, norms, loss and the optimizer's update (one replayed graph, so
not apart)."""
from portbench import readers

LAYER = "elementwise, norms, loss and optimizer (distributed/engine.py)"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(ctx, out):
    return readers.ms_per_step(
        ctx, out, lambda k: not readers.is_gemm(k)
        and not readers.is_port_attention(k))
