"""Goodput / MFU accounting (the port of
``paddle_tpu/observability/goodput.py``): what fraction of wall-clock is
useful work.

- **step time breakdown** — :class:`GoodputMonitor` (a hapi callback)
  splits every train-step interval into ``data_wait`` (the loader's
  ``next()``, by the profiler's ``Benchmark`` reader clock), ``compile``
  (the compile watchdog's build wall-time deltas: on the card the first
  call of a captured step, with its capture), ``checkpoint`` (the
  training-thread part of ``checkpoint_save_seconds``: ``sync`` and
  ``async``, never ``background``), ``eval`` (epoch-end evaluation) and
  the remainder ``compute``.  The phases sum to the measured interval.
  The monitor's own bookkeeping after a step falls in the next
  interval's gap (the JAX monitor leaves it out), so the intervals tile
  the fit's wall clock: on the port a small model's step is fast enough
  that the bookkeeping would otherwise be a visible share of it.
- **goodput ratio** — cumulative ``compute / total``, the
  ``training_goodput_ratio`` gauge.
- **MFU** — FLOPs a step (``flops_per_step=``; the port's watchdog has no
  compiler cost analysis to read them from) over step wall time and the
  device's peak: the ``training_mfu`` gauge.  Peaks come from
  :data:`PEAK_FLOPS` (bf16 dense, spec sheets) by the longest match on
  ``torch.cuda.get_device_name``, or ``PADDLE_TPU_PEAK_FLOPS``, or
  ``peak_flops=``.

A train step on the card returns once its loss is read on the host, so
the host clock brackets the device work of the step.
"""
from __future__ import annotations

import logging
import os
import time

__all__ = ["PEAK_FLOPS", "device_peak_flops", "mfu", "TrainingCallback",
           "GoodputMonitor", "last_report"]

logger = logging.getLogger("paddle_tpu_torch.observability")

# bf16 peak FLOPs by device kind substring (public spec sheets).  The
# table is deliberately a plain module-level dict: deployments with
# unlisted hardware update it (or set PADDLE_TPU_PEAK_FLOPS) instead of
# patching code.
PEAK_FLOPS = {
    "TPU v5 lite": 197.0e12, "TPU v5e": 197.0e12, "TPU v5p": 459.0e12,
    "TPU v5": 459.0e12, "TPU v4": 275.0e12, "TPU v3": 123.0e12,
    "TPU v2": 45.0e12,
    "H100": 989.0e12,
    "cpu": 1.0e12,
}

#: the breakdown's phase vocabulary, in display order
PHASES = ("compute", "data_wait", "compile", "checkpoint", "eval")


def device_peak_flops(device=None, table=None, default=None):
    """``(peak_flops, device_kind)`` for ``device`` (default: CUDA device
    0, or ``"cpu"`` without CUDA).  Resolution order: the
    ``PADDLE_TPU_PEAK_FLOPS`` environment variable, then the longest
    :data:`PEAK_FLOPS` substring match on the device kind, then
    ``default`` (``None`` = unknown: skip MFU rather than report one
    against a made-up peak)."""
    import torch

    env = os.environ.get("PADDLE_TPU_PEAK_FLOPS")
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type
    if env:
        return float(env), kind
    best = None
    for k, v in (table or PEAK_FLOPS).items():
        if k.lower() in kind.lower() and \
                (best is None or len(k) > best[0]):
            best = (len(k), v)
    if best is not None:
        return best[1], kind
    return default, kind


def mfu(flops_per_step, step_time_s, peak_flops):
    """Model FLOPs utilisation: achieved FLOP/s over peak FLOP/s."""
    if not flops_per_step or not step_time_s or not peak_flops:
        return None
    return flops_per_step / (step_time_s * peak_flops)


class TrainingCallback:
    """The hapi callback hook surface, duck-typed.

    Observability sits *below* hapi in the layer stack, so its callbacks
    do not import ``hapi``; ``CallbackList`` only needs
    ``set_model``/``set_params`` and the ``on_*`` hooks, so structural
    compatibility is enough."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = dict(params or {})

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...


_LAST_REPORT = None


def last_report():
    """The most recent :meth:`GoodputMonitor.report` in this process
    (``None`` before any monitored run) — the bench's embed hook."""
    return _LAST_REPORT


class GoodputMonitor(TrainingCallback):
    """Per-step goodput accountant for ``Model.fit``.

    Pass it in ``callbacks=[...]``.  Every train step interval (previous
    batch end → this batch end, i.e. the full cycle including loader
    wait) is split into :data:`PHASES`; cumulative phase seconds, the
    goodput ratio and MFU are published as registry gauges and the
    per-step interval into the ``training_step_seconds`` histogram
    (whose cross-rank spread is the aggregator's straggler-skew
    signal).

    ``flops_per_step=None`` reads FLOPs for ``fn`` from the compile
    watchdog's report where it has them (the port's has none, so MFU then
    stays None); ``peak_flops=None`` resolves via
    :func:`device_peak_flops`.
    """

    def __init__(self, peak_flops=None, flops_per_step=None,
                 fn="hapi::train_step", registry=None, watchdog=None,
                 clock=None):
        super().__init__()
        self._explicit_peak = peak_flops
        self._explicit_flops = flops_per_step
        self.fn = fn
        self._registry = registry
        self._watchdog = watchdog
        self._clock = clock or time.perf_counter
        self.peak_flops = None
        self.device_kind = None
        self._reset_accounting()

    # ---- wiring ---------------------------------------------------------
    def registry(self):
        if self._registry is None:
            from .metrics import default_registry

            self._registry = default_registry()
        return self._registry

    def watchdog(self):
        if self._watchdog is None:
            from .compile_watchdog import default_watchdog

            self._watchdog = default_watchdog()
        return self._watchdog

    def _reset_accounting(self):
        self._bm = None
        self._phase_seconds = dict.fromkeys(PHASES, 0.0)
        self._total_seconds = 0.0
        self._steps = 0
        self._last_reader_total = 0.0
        self._last_batch_total = 0.0
        self._ckpt_at_end = 0.0
        self._ckpt_in_gap = 0.0
        self._compile_at_end = 0.0
        self._mfu = None
        self._flops_seen = None

    # ---- telemetry taps -------------------------------------------------
    def _ckpt_blocking_sum(self):
        """Training-thread seconds spent in checkpoint saves so far:
        the sync + async(blocking-snapshot) children of the
        ``checkpoint_save_seconds`` histogram.  ``mode="background"``
        is excluded — overlapped write time is the point of async."""
        h = self.registry().get("checkpoint_save_seconds")
        if h is None or h.kind != "histogram":
            return 0.0
        total = 0.0
        for lv, child in h._series():
            if not lv or lv[0] in ("sync", "async"):
                with child._lock:
                    total += child.sum
        return total

    def _compile_sum(self):
        """Cumulative compile wall-time over every watched function —
        an eval-step or predictor compile stalls training just as much
        as the train step's own."""
        return sum(st.get("compile_time_s", 0.0)
                   for st in self.watchdog().report().values())

    def _flops_per_step(self):
        if self._explicit_flops:
            return float(self._explicit_flops)
        st = self.watchdog().report().get(self.fn)
        if st:
            return (st.get("cost_analysis") or {}).get("flops")
        return None

    # ---- hooks ----------------------------------------------------------
    def on_train_begin(self, logs=None):
        from ..profiler.timer import Benchmark

        self._reset_accounting()
        self._bm = Benchmark(warmup_steps=0)
        if self._explicit_peak is not None:
            self.peak_flops = float(self._explicit_peak)
            self.device_kind = "explicit"
        else:
            self.peak_flops, self.device_kind = device_peak_flops()
            if self.peak_flops is None:
                logger.debug("goodput: unknown device kind %r — MFU "
                             "disabled (set PADDLE_TPU_PEAK_FLOPS or "
                             "extend goodput.PEAK_FLOPS)",
                             self.device_kind)
        self._ckpt_at_end = self._ckpt_blocking_sum()
        self._compile_at_end = self._compile_sum()
        self._bm.before_reader()

    def on_train_batch_begin(self, step, logs=None):
        if self._bm is None:
            self.on_train_begin()
        self._bm.after_reader()
        # a checkpoint saved by another callback AFTER our last
        # step_end ran inside the reader gap — remember it so the gap
        # isn't double-billed as data_wait
        self._ckpt_in_gap = self._ckpt_blocking_sum() - self._ckpt_at_end
        self._bm.step_start()

    def on_train_batch_end(self, step, logs=None):
        if self._bm is None:
            return
        self._bm.step_end()
        # the next interval starts now: this bookkeeping falls in its gap,
        # so the intervals tile the fit's wall clock
        self._bm.before_reader()
        info = self._bm.step_info()
        step_wall = info["batch_cost_total"] - self._last_batch_total
        gap = info["reader_cost_total"] - self._last_reader_total
        self._last_batch_total = info["batch_cost_total"]
        self._last_reader_total = info["reader_cost_total"]

        ckpt_now = self._ckpt_blocking_sum()
        compile_now = self._compile_sum()
        ckpt = max(0.0, ckpt_now - self._ckpt_at_end)
        compile_dt = max(0.0, compile_now - self._compile_at_end)
        self._ckpt_at_end = ckpt_now
        self._compile_at_end = compile_now

        total = gap + step_wall
        data_wait = max(0.0, gap - self._ckpt_in_gap)
        self._ckpt_in_gap = 0.0
        # phases sum to the measured interval: compile/checkpoint were
        # measured inside it, the remainder is compute
        data_wait = min(data_wait, max(0.0, total - ckpt - compile_dt))
        compute = max(0.0, total - data_wait - ckpt - compile_dt)

        p = self._phase_seconds
        p["data_wait"] += data_wait
        p["compile"] += compile_dt
        p["checkpoint"] += ckpt
        p["compute"] += compute
        self._total_seconds += total
        self._steps += 1
        self._flops_seen = self._flops_per_step()
        self._mfu = mfu(self._flops_seen, total, self.peak_flops)
        self._publish(total)

    def on_epoch_end(self, epoch, logs=None):
        if self._bm is None:
            return
        # everything between the last batch end and here is epoch-end
        # work — dominated by fit's nested evaluate() (which runs with
        # its own callback list, so these hooks never see it directly);
        # claim the stashed gap as eval time instead of letting the next
        # step bill it as data wait
        self._bm.after_reader()
        gap = self._bm.take_pending_reader_cost()
        self._bm.before_reader()
        # a checkpoint saved in this gap (a later-listed callback's
        # batch-end save at the epoch's last step) is checkpoint time,
        # not eval — and must not be billed AGAIN at the next batch end
        ckpt_now = self._ckpt_blocking_sum()
        ckpt_gap = min(max(0.0, ckpt_now - self._ckpt_at_end), gap)
        self._ckpt_at_end = ckpt_now
        self._phase_seconds["checkpoint"] += ckpt_gap
        self._phase_seconds["eval"] += gap - ckpt_gap
        self._total_seconds += gap
        self._publish(None)

    def on_train_end(self, logs=None):
        global _LAST_REPORT
        _LAST_REPORT = self.report()

    # ---- publication ----------------------------------------------------
    def _publish(self, step_total):
        reg = self.registry()
        if step_total is not None:
            reg.histogram(
                "training_step_seconds",
                "full train-step interval (batch end to batch end)",
            ).observe(step_total)
        breakdown = reg.gauge(
            "training_step_breakdown_seconds",
            "cumulative seconds per step phase", labelnames=("phase",))
        for phase, secs in self._phase_seconds.items():
            breakdown.labels(phase=phase).set(secs)
        if self._total_seconds > 0:
            reg.gauge(
                "training_goodput_ratio",
                "productive compute fraction of training wall-clock",
            ).set(self._phase_seconds["compute"] / self._total_seconds)
        if self._mfu is not None:
            reg.gauge(
                "training_mfu",
                "model FLOPs utilisation vs device peak",
            ).set(self._mfu)

    def report(self):
        """JSON-able accounting summary — bench sections embed this."""
        out = {
            "steps": self._steps,
            "total_seconds": self._total_seconds,
            "phases_seconds": dict(self._phase_seconds),
            "goodput_ratio":
                (self._phase_seconds["compute"] / self._total_seconds
                 if self._total_seconds > 0 else None),
            "mfu": self._mfu,
            "flops_per_step": self._flops_seen,
            "peak_flops": self.peak_flops,
            "device": self.device_kind,
        }
        h = self.registry().get("training_step_seconds")
        if h is not None and h.kind == "histogram":
            out["step_seconds"] = h.summary()
        return out
