"""Benchmark timer (the port of ``paddle_tpu/profiler/timer.py``; parity:
python/paddle/profiler/timer.py:325 ``Benchmark``; host-only Python,
carried over unchanged).

Reports steady-state ips (items/sec) skipping warmup, plus reader cost.
The host clock times what it brackets: a caller timing device work ends
each step with a ``torch.cuda.synchronize()`` (or a host read of the
result) before ``step_end``.
"""
from __future__ import annotations

import time

__all__ = ["Benchmark"]


class _StepInfo:
    def __init__(self):
        self.reader_cost = 0.0
        self.batch_cost = 0.0
        self.samples = 0
        self.steps = 0

    @property
    def ips(self):
        return self.samples / self.batch_cost if self.batch_cost > 0 else 0.0


class Benchmark:
    def __init__(self, warmup_steps: int = 10):
        self.warmup_steps = warmup_steps
        self.reset()

    def reset(self):
        self._step = 0
        self._reader_start = None
        self._batch_start = None
        self._pending_reader_cost = 0.0
        self._info = _StepInfo()

    def before_reader(self):
        self._reader_start = time.perf_counter()

    def after_reader(self):
        if self._reader_start is None:
            return
        # stash; step_end commits reader + batch cost under ONE warmup
        # test, so no call-order/convention skew can make a boundary step
        # contribute reader cost but not batch cost (or vice versa)
        self._pending_reader_cost += time.perf_counter() - self._reader_start
        self._reader_start = None

    def step_start(self):
        self._batch_start = time.perf_counter()

    def step_end(self, num_samples=1):
        if self._batch_start is None:
            return
        cost = time.perf_counter() - self._batch_start
        reader_cost, self._pending_reader_cost = \
            self._pending_reader_cost, 0.0
        self._step += 1
        if self._step > self.warmup_steps:
            self._info.reader_cost += reader_cost
            self._info.batch_cost += cost
            self._info.samples += num_samples
            self._info.steps += 1

    def step_info(self, unit="samples"):
        """Steady-state reader/step breakdown as a dict — the
        programmatic surface (goodput accounting and bench consume the
        totals; nothing should re-parse a formatted string).  Averages
        are per counted step; ``*_total`` fields are cumulative seconds
        over the counted (post-warmup) window."""
        i = self._info
        span = i.reader_cost + i.batch_cost
        return {
            "ips": i.ips,
            "avg_batch_cost": i.batch_cost / i.steps if i.steps else 0.0,
            "reader_cost": i.reader_cost / i.steps if i.steps else 0.0,
            "steps": i.steps,
            "unit": f"{unit}/sec",
            "samples": i.samples,
            "batch_cost_total": i.batch_cost,
            "reader_cost_total": i.reader_cost,
            "reader_ratio": i.reader_cost / span if span > 0 else 0.0,
        }

    def take_pending_reader_cost(self):
        """Return and clear reader time stashed by ``after_reader`` but
        not yet committed by ``step_end`` — callers that re-attribute a
        gap (e.g. the goodput accountant claiming epoch-end eval time)
        drain it here so the next step doesn't double-bill it."""
        pending, self._pending_reader_cost = self._pending_reader_cost, 0.0
        return pending

    @property
    def ips(self):
        return self._info.ips
