"""What the per-layer metric readers share: sorting the traced device
operations into kinds by name, and the shares they report.

GEMM kernels are known by the words cuBLAS and CUTLASS put in their
names; the port's attention kernels by their own names
(``paddle_tpu_torch/kernels/csrc``).  Every reader returns None where
its run has nothing for it to read, such as a run without a card."""
from __future__ import annotations

from . import work

GEMM_WORDS = ("gemm", "nvjet", "xmma", "cutlass", "cublas")
#: parts of the port's kernels' names (the trace gives them with their
#: namespace and template arguments)
FLASH_FWD = "flash_fwd_sm90_kernel"
FLASH_BWD = "flash_bwd_sm90_kernel"
PAGED = "ragged_paged_attention_"
PORT_ATTENTION = ("flash_", PAGED)


def is_gemm(name):
    low = name.lower()
    return any(w in low for w in GEMM_WORDS)


def is_port_attention(name):
    return any(w in name for w in PORT_ATTENTION)


def traced(ctx, out):
    """The trace summary of a run on the card, else None."""
    if ctx.device.type != "cuda" or not out.get("trace"):
        return None
    return out["trace"]


def device_seconds(summary, keep):
    """Device seconds and calls of the traced operations ``keep`` takes."""
    secs = sum(v for k, v in summary["by_name"].items() if keep(k))
    calls = sum(v for k, v in summary["calls"].items() if keep(k))
    return secs, calls


def ms_per_step(ctx, out, keep):
    s = traced(ctx, out)
    if s is None or not s["steps"]:
        return None
    secs, calls = device_seconds(s, keep)
    return secs / s["steps"] * 1e3 if calls else None


def idle_share(ctx, out):
    s = traced(ctx, out)
    if s is None or s["window_s"] <= 0:
        return None
    return (1.0 - s["busy_s"] / s["window_s"]) * 100.0


def flash_roofline(ctx, out, kernel, which):
    """A flash kernel's share of its roofline over the traced calls: the
    least time of each call (``work.flash_work`` at the step's attention
    shape) over the kernel's device time, in percent."""
    s = traced(ctx, out)
    if s is None:
        return None
    secs, calls = device_seconds(s, lambda k: kernel in k)
    if not calls:
        return None
    B, H, S, D, causal = out["run"]["flash"]
    nbytes, flops = work.flash_work(B, H, S, D, causal)[which]
    least, _ = work.roofline_s(flops, nbytes)
    return calls * least / secs * 100.0


def peak_share(ctx, flops, seconds):
    if ctx.device.type != "cuda" or seconds <= 0:
        return None
    return flops / seconds / work.PEAK_BF16_FLOPS * 100.0
