"""The share of the traced serving window in which no operation ran on
the device."""
from portbench import readers

LAYER = "device"
UNIT = "%"
MOVES = "serve_tokens_per_s"
SOURCE = "device_trace"


def read(ctx, out):
    return readers.idle_share(ctx, out)
