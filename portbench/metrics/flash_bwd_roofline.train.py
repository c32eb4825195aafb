"""The bf16 flash backward kernel's (dQ, dK and dV in one launch) share
of its roofline in the traced training steps."""
from portbench import readers

LAYER = "flash attention (kernels/flash_attention.py, csrc/flash_*_sm90.cu)"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(ctx, out):
    return readers.flash_roofline(ctx, out, readers.FLASH_BWD, "bwd")
