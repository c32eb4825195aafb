"""The bf16 flash forward kernel's share of its roofline in the traced
training steps (every call, the recompute's included)."""
from portbench import readers

LAYER = "flash attention (kernels/flash_attention.py, csrc/flash_*_sm90.cu)"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(ctx, out):
    return readers.flash_roofline(ctx, out, readers.FLASH_FWD, "fwd")
