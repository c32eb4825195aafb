"""The serving driver: the ``Engine`` behind a closed loop of
``clients``.  Each client has one request in flight and sends its next
the moment the last one finishes, as a gateway capped at that many
concurrent requests does.  Set-up builds the engine over the
benchmark's weights and runs the loop until ``warmup_finished``
requests have finished: the step's capture and the first prompts' burst
are behind it and the loop has reached its steady mix.  The window then
runs for ``--seconds``; the driver's clock stamps each request's
submission and each step's output tokens as the step returns them.
After the close no request is sent, and the loop runs on until every
request sent in the window has its first token, a minute at most.

Once the engine is freed, a sample of the requests finished in the
window, drawn from the seed and with the longest among them, goes
through the float32 reference: each prompt with its served tokens, and
the widest gap by which a served token's logit lies below the
reference's best at its position.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from .. import compare, program, trace, traffic, weights
from ..reference import models

ENDED_BADLY = ("rejected", "retry_after", "evicted", "evacuated", "failed")


class Record:
    __slots__ = ("req", "t_sent", "times")

    def __init__(self, req, t_sent):
        self.req, self.t_sent, self.times = req, t_sent, []


class Loop:
    """A closed loop: a request is sent for each one that ends."""

    def __init__(self, eng, requests, rows):
        self.eng, self.requests = eng, requests
        self.records, self.live = [], []
        self.next_k = 0
        self.sending = True
        self.finished = 0
        self.rows = rows          # None, or a list gaining each step's rows

    def start(self, clients):
        for _ in range(clients):
            self.submit(False)

    def submit(self, on):
        prompt, new = self.requests(self.next_k)
        self.next_k += 1
        with trace.span("add_request", on):
            t = time.perf_counter()
            req = self.eng.add_request(prompt, program.sampling(new))
        rec = Record(req, t)
        self.records.append(rec)
        self.live.append(rec)

    def step(self, on):
        before = None
        if self.rows is not None:
            before = [(r, r.req.state, r.req.prompt_pos, len(r.req.tokens))
                      for r in self.live]
        with trace.span("engine.step", on):
            done = self.eng.step()
        now = time.perf_counter()
        for rec in self.live:
            for _ in range(len(rec.req.output) - len(rec.times)):
                rec.times.append(now)
        if before is not None:
            self.rows.append(step_rows(before))
        if done:
            ended = {id(r) for r in done}
            self.live = [r for r in self.live if id(r.req) not in ended]
            self.finished += sum(r.state == "finished" for r in done)
            if self.sending:
                for _ in done:
                    self.submit(on)


def step_rows(before):
    """``(q, ctx, prefill)`` of each row one step ran, from the requests'
    state
    before and after it: a decoding row computes its last token over the
    context it had; a prefilling row computes its prompt from where it
    stood (a newly admitted one from the prefix the engine's span says
    the cache matched) to where it stands."""
    rows = []
    for rec, state, pos, ntok in before:
        req = rec.req
        if state == "running" and pos >= len(req.prompt):
            if len(req.tokens) > ntok:
                rows.append((1, ntok, False))
        elif req.prompt_pos > pos or (state == "queued"
                                      and req.state != "queued"):
            if state == "queued":
                pos = req._span.attributes.get("prefix_hit_tokens", 0)
            if req.prompt_pos > pos:
                rows.append((req.prompt_pos - pos, req.prompt_pos, True))
    return rows


def p95(values):
    """Nearest-rank 95th percentile (inf for a request that failed)."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def counters(eng):
    snap = eng.metrics.snapshot()
    return {"prefill": snap["tokens"]["prefill"],
            "generated": snap["tokens"]["generated"], "steps": eng.steps,
            "hit_tokens": eng.health()["prefix_cache"]["hit_tokens"]}


def run(ctx):
    result, sample = window(ctx)
    t_check = time.perf_counter()
    result["readings"] = {"logit_gap": served_gap(ctx.config, ctx.seed,
                                                  ctx.device, sample)}
    result["check_s"] = time.perf_counter() - t_check
    return result


def window(ctx):
    """Set-up, the window and the drain: ``(result without readings, the
    sample of served requests to check)``; the engine is freed."""
    c, cell = ctx.config, ctx.cell
    tr = cell["traffic"]
    dev = ctx.device
    eng = program.serving_engine(c, cell, weights.gpt(c, ctx.seed, dev), dev)
    loop = Loop(eng, traffic.Requests(tr, ctx.seed),
                [] if ctx.trace else None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    loop.start(tr["clients"])
    while loop.finished < tr["warmup_finished"]:
        loop.step(False)
    ctx.setup_done()

    c0 = counters(eng)
    if loop.rows is not None:
        loop.rows.clear()
    traced, traced_rows = None, None
    t0 = time.perf_counter()
    while True:
        if ctx.trace and traced is None and \
                time.perf_counter() - t0 >= ctx.seconds / 2:
            first = len(loop.rows)
            with trace.Window(dev) as traced:
                t_tr = time.perf_counter()
                while time.perf_counter() - t_tr < cell["trace_seconds"]:
                    loop.step(True)
            traced_rows = loop.rows[first:]
        loop.step(ctx.trace)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    t_end = time.perf_counter()
    loop.sending = False
    c1 = counters(eng)
    rows = list(loop.rows) if loop.rows is not None else None
    sent = [r for r in loop.records if t0 <= r.t_sent < t_end]
    limit = time.perf_counter() + 60.0
    while time.perf_counter() < limit and any(
            not r.times and r.req.state not in ENDED_BADLY for r in sent):
        loop.step(False)
    ctx.read_memory()

    ttft = [r.times[0] - r.t_sent if r.times else math.inf for r in sent]
    itl = [b - a for r in loop.records for a, b in zip(r.times, r.times[1:])
           if t0 < b <= t_end]
    tokens = sum(1 for r in loop.records for t in r.times if t0 < t <= t_end)
    window = t_end - t0
    admitted = [r.req for r in loop.records
                if r.req.t_admitted is not None
                and t0 <= r.req.t_admitted < t_end]
    done = [r.req for r in loop.records if r.req.state == "finished"
            and t0 < r.req.t_finished <= t_end]
    sample = []
    if done:
        rng = np.random.default_rng(traffic.data_seed(ctx.seed))
        longest = max(done, key=lambda q: len(q.tokens))
        rest = [q for q in done if q is not longest]
        pick = rng.choice(len(rest), min(cell["check_requests"], len(rest)),
                          replace=False)
        sample = [longest] + [rest[i] for i in sorted(pick)]
        sample = [(list(q.prompt), list(q.output)) for q in sample]
    result = {
        "attempted": len(sent),
        "failed": sum(r.req.state in ENDED_BADLY for r in sent),
        "metrics": {"serve_tokens_per_s": tokens / window,
                    "ttft_p95_ms": p95(ttft) * 1e3,
                    "itl_p95_ms": p95(itl) * 1e3},
        "trace": traced.summary if traced else None,
        "run": {"window_s": window, "counters": (c0, c1),
                "rows": rows, "traced_rows": traced_rows,
                "prompt_tokens_admitted": sum(len(q.prompt)
                                              for q in admitted),
                "served_checked": sum(len(o) for _, o in sample)},
    }
    del eng, loop, done, admitted
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return result, sample


def reference_logits(c, w, prompt, output, mm=models.matmul):
    """The reference's logits at each position that chose a served token."""
    seq = torch.tensor(prompt + output[:-1], device=next(iter(w.values()))
                       .device)
    pos = torch.arange(len(prompt) - 1, len(seq), device=seq.device)
    return models.gpt_logits_at(c, w, seq, pos, mm)


def reference_weights(c, seed, device):
    if device.type == "cuda":
        models.exact_fp32()
    return {p: t.float() for p, t in weights.leaves(weights.gpt(c, seed,
                                                                device))}


def served_gap(c, seed, device, sample):
    """Widest gap of the served tokens below the reference's best (None
    where the window finished no request: nothing served was checked)."""
    if not sample:
        return None
    w = reference_weights(c, seed, device)
    return max(compare.widest_gap(reference_logits(c, w, p, o), o)
               for p, o in sample)
