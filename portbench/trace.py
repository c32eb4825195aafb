"""The traced window of a ``--trace 1`` run, and its reduction.

``Window`` runs ``torch.profiler`` over a stretch of the timed path,
synchronised at both ends, inside a ``portbench.window`` range.  The
driver's own spans (``span``: ``train.step``, ``engine.step``,
``add_request``) are ``record_function`` ranges, so they share the
profiler's clock with the device's kernels.  ``reduce`` turns the trace
into what the per-layer readers and the result's ``device`` and
``breakdown`` read: every device operation in the window (kernels,
copies, fills; the device-side marks of host ranges left out), the
union of their intervals (busy seconds), the idle gaps between them,
each named by the driver span the host was in when it began, and the
device seconds by operation name.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

WINDOW = "portbench.window"
SPANS = ("train.step", "engine.step", "add_request")


def span(name, on):
    """A driver span: a ``record_function`` range when tracing, else
    nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


class Window:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.rng = record_function(WINDOW)
        self.rng.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rng.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = reduce(self.prof)
        self.prof = None
        return False


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(prof):
    """The trace's summary (times in seconds, from the window's start)."""
    cpu = torch.autograd.DeviceType.CPU
    events = list(prof.events())
    host_names = {e.name for e in events if e.device_type == cpu}
    win = [e for e in events if e.device_type == cpu and e.name == WINDOW]
    if not win:
        raise RuntimeError("the traced window's range is not in the trace")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    ops = []
    for e in events:
        if e.device_type == cpu or e.name in host_names:
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b > a:
            ops.append((e.name, a, b))
    busy = _union([(a, b) for _, a, b in ops])
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == cpu
                   and e.name in SPANS)
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    idle = defaultdict(float)
    for a, b in gaps:
        inside = [s for s in spans if s[0] <= a < s[1]]
        name = max(inside)[2] if inside else "harness"
        idle[name] += (b - a) / 1e6
    by_name = defaultdict(float)
    calls = defaultdict(int)
    for name, a, b in ops:
        by_name[name] += (b - a) / 1e6
        calls[name] += 1
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "ops": ops, "by_name": dict(by_name), "calls": dict(calls),
            "idle": dict(idle),
            "steps": sum(1 for s in spans if s[2] in ("train.step",
                                                        "engine.step"))}


def breakdown(summary):
    """The result's ``breakdown``: the ten device operations that took
    most time and the ten host spans the longest idle time fell in."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(summary["by_name"]),
            "idle_gaps": top(summary["idle"])}
