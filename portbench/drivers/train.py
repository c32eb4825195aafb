"""The training driver: ``HybridEngine.step`` on its captured route.

Set-up builds the engine, hands it the benchmark's weights and drives
it through the first ``checked_steps`` steps on the feed's first
batches, through the same call the window makes.  It keeps what the
comparison reads: each step's loss, each leaf's gradient norm at the
first step as the optimizer got it (its first moment over 1 - β1) and
each leaf's change from the start after the last of them (its fp32
master against the weights made again from the seed, kept on the host
in bfloat16).  The window then
steps the same engine on new batches for ``--seconds`` and ends in a
synchronise.  Once it has closed and the peak memory is read, the
engine is freed and the float32 reference follows the checked steps.
"""
from __future__ import annotations

import collections
import gc
import math
import time

import torch

from .. import compare, program, trace, traffic, weights
from ..reference import models, training


def first_steps(ctx):
    """The engine over the benchmark's weights after the checked steps,
    and what the comparison reads of them: ``(eng, params, opt, feed,
    prog)``."""
    c, cell = ctx.config, ctx.cell
    dev = ctx.device
    eng = program.hybrid_engine(c, cell, dev)
    params = weights.make(c, ctx.seed, dev)
    opt = eng.init_opt(params)
    feed = traffic.TrainFeed(cell["traffic"], ctx.seed, dev)
    b1 = c["optimizer"]["beta1"]

    def slots(path):
        node = opt["slots"]
        for k in path.split("/"):
            node = node[k]
        return node

    prog = {"loss": []}
    for i in range(cell["checked_steps"]):
        tokens, labels = feed.next()
        params, opt, loss = eng.step(params, opt, tokens, labels)
        prog["loss"].append(loss)
        if i == 0:
            prog["grad"] = {p: float(slots(p)["m"].norm() / (1 - b1))
                            for p, _ in weights.leaves(params)}
    # the float32 master where the engine keeps one, else the parameter
    held = dict(weights.leaves(params))
    prog["change"] = {
        p: (slots(p).get("master", held[p]).float() - t.float()).to(
            "cpu", torch.bfloat16)
        for p, t in weights.leaves(weights.make(c, ctx.seed, dev))}
    prog["loss"] = [float(x) for x in prog["loss"]]
    return eng, params, opt, feed, prog


def reference(ctx, mm=models.matmul, keep_rows=None):
    """The float32 reference over the checked steps, from the weights and
    batches made again from the seed (``training.follow``)."""
    c, cell, dev = ctx.config, ctx.cell, ctx.device
    if dev.type == "cuda":
        models.exact_fp32()
    w0 = dict(weights.leaves(weights.make(c, ctx.seed, dev)))
    batches = traffic.TrainFeed(cell["traffic"], ctx.seed,
                                dev).take(cell["checked_steps"])
    return training.follow(c, w0, batches, cell["reference_rows"], mm,
                           keep_rows)


#: steps the host may queue on the card beyond the one running: enough to
#: keep the card busy, few enough that the window's host clock ends with
#: the card's work and not with a queue of it
AHEAD = 2


def pacer(dev):
    """A call for after each step: it waits until the step ``AHEAD``
    steps back has finished on the card."""
    if dev.type != "cuda":
        return lambda: None
    marks = collections.deque()

    def after_step():
        marks.append(torch.cuda.Event())
        marks[-1].record()
        if len(marks) > AHEAD:
            marks.popleft().synchronize()

    return after_step


def run(ctx):
    c, cell = ctx.config, ctx.cell
    tr = cell["traffic"]
    dev = ctx.device
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    eng, params, opt, feed, prog = first_steps(ctx)
    ctx.setup_done()

    B, S = tr["batch"], tr["seq_len"]
    pace = pacer(dev)
    losses, steps = [], 0
    traced = None
    t0 = time.perf_counter()
    while True:
        if ctx.trace and traced is None and \
                time.perf_counter() - t0 >= ctx.seconds / 2:
            with trace.Window(dev) as traced:
                for _ in range(cell["trace_steps"]):
                    tokens, labels = feed.next()
                    with trace.span("train.step", True):
                        params, opt, loss = eng.step(params, opt, tokens,
                                                     labels)
                    pace()
                    losses.append(loss)
                    steps += 1
        tokens, labels = feed.next()
        with trace.span("train.step", ctx.trace):
            params, opt, loss = eng.step(params, opt, tokens, labels)
        pace()
        losses.append(loss)
        steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    window = time.perf_counter() - t0
    failed = sum(1 for x in losses if not math.isfinite(float(x)))
    ctx.read_memory()

    del eng, params, opt, losses, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = reference(ctx)
    readings = compare.training(prog, ref)
    D, H = c["hidden"], c["num_heads"]
    return {
        "attempted": steps, "failed": failed,
        "metrics": {"train_tokens_per_s": steps * B * S / window},
        "readings": readings, "check_s": time.perf_counter() - t_check,
        "trace": traced.summary if traced else None,
        "run": {"window_s": window, "tokens": steps * B * S,
                "flash": (B, H, S, D // H, c["family"] == "gpt")},
    }
