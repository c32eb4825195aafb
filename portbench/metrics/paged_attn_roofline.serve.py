"""The ragged paged-attention kernels' share of their roofline over the
traced steps: the bytes and products the steps' rows and contexts need
(``work.paged_attention_work``) at the card's peaks, over the device
time of the kernel and its split combine."""
from portbench import readers, work

LAYER = "ragged paged attention (kernels/paged_attention.py)"
UNIT = "%"
MOVES = "serve_tokens_per_s"
SOURCE = "device_trace"


def read(ctx, out):
    s = readers.traced(ctx, out)
    rows = out["run"].get("traced_rows")
    if s is None or not rows:
        return None
    secs, calls = readers.device_seconds(
        s, lambda k: readers.PAGED in k)
    if not calls:
        return None
    least = 0.0
    for step in rows:
        nbytes, flops = work.paged_attention_work(ctx.config, step)
        least += work.roofline_s(flops, nbytes)[0]
    return least / secs * 100.0
