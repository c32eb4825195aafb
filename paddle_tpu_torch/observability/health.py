"""Training health monitor (the port of
``paddle_tpu/observability/health.py``) — is the run numerically and
mechanically OK?

Loss curves are reviewed after the fact; a production run needs the
*process itself* to notice, within a step, that something broke.
:class:`HealthMonitor` is a hapi-compatible callback watching four
failure signatures:

``non_finite_loss``
    NaN/Inf loss — the canonical silent killer (one bad batch poisons
    the params and every later step reports NaN "progress").
``grad_spike``
    gradient-norm outliers by rolling z-score (needs
    ``Model.enable_grad_norm_logging`` — the monitor turns it on at
    train begin when ``watch_grad_norm=True``); a non-finite gradient
    norm counts here too.
``loss_plateau``
    no windowed-mean improvement beyond ``plateau_min_delta`` for a full
    ``plateau_window`` of steps.
``step_time_outlier``
    step wall-time z-score spikes — a stalling host, a recompiling
    step, a dying storage mount.

Two further kinds arrive from OUTSIDE the monitor via
:meth:`HealthMonitor.external_anomaly` — the integrity sentinel
(``resilience.integrity``) reports ``param_divergence`` when this
rank's parameter fingerprint disagrees with its dp peers (a rollback
kind by default: the repair restores the last *verified* checkpoint
and **replays** the same data rather than skipping it, since the data
was fine and the state was not) and ``step_replay_mismatch`` when a
re-executed step produced different bytes (never a rollback kind:
replay cannot say which execution was right).

A condition *fires once per onset*: while it stays true on consecutive
steps it is "active" and not re-reported (an injected NaN batch is
flagged exactly once even though every following loss is NaN too).  On
each event the monitor

- increments ``training_anomalies_total{kind=...}``,
- holds the ``training_healthy`` gauge at 0 until every condition
  clears (``recover_after`` consecutive clean steps),
- records a ``health::<kind>`` span in the flight recorder (step, value
  and threshold as attributes — ``/traces`` shows *when* in the request
  /step timeline the run went bad), and
- applies ``action``: ``"warn"`` logs a WARNING, ``"gauge"`` only flips
  the gauge, ``"raise"`` raises :class:`TrainingHealthError` out of
  ``Model.fit`` (for CI canaries where a sick run must die loudly), and
  ``"rollback"`` turns the monitor from an observer into an actor: on a
  ``non_finite_loss``/``grad_spike`` anomaly (``rollback_kinds``) it
  asks ``Model.fit`` to restore the last-good checkpoint and skip the
  offending data window — training continues from known-good params
  with the poisoned batch never replayed (see
  ``Model._execute_rollback``; requires a ``CheckpointCallback`` in the
  same fit).  Each rollback increments
  ``training_rollbacks_total{reason=...}``; more than ``max_rollbacks``
  per run escalates to :class:`TrainingHealthError` — a run that needs
  rolling back every few steps is sick in a way rollback can't fix.
  Kinds outside ``rollback_kinds`` degrade to ``"warn"`` behaviour.

Across ranks these metrics reach one scrape through
``observability/aggregate.py``: each rank's ``RankMetricsPublisher``
(a ``StorePublisher``) writes its snapshot into the world's
``TCPStore`` and rank 0's ``ClusterAggregator`` merges them.
"""
from __future__ import annotations

import collections
import logging
import math
import time

from .goodput import TrainingCallback

__all__ = ["HealthMonitor", "TrainingHealthError"]

logger = logging.getLogger("paddle_tpu_torch.observability")

_ACTIONS = ("warn", "gauge", "raise", "rollback")


class TrainingHealthError(RuntimeError):
    """Raised by ``HealthMonitor(action="raise")`` on an anomaly."""

    def __init__(self, kind, message):
        super().__init__(message)
        self.kind = kind


class _RollingZ:
    """Rolling-window z-score detector.  Flagged samples are NOT added
    to the window — one spike must not inflate the std it is judged
    against (a second identical spike should still be an outlier)."""

    def __init__(self, window, zscore, min_samples):
        self.values = collections.deque(maxlen=window)
        self.zscore = zscore
        self.min_samples = min_samples

    def observe(self, x):
        """Returns ``(is_outlier, z)`` and absorbs inliers."""
        if not math.isfinite(x):
            return True, None
        n = len(self.values)
        if n >= self.min_samples:
            mean = sum(self.values) / n
            var = sum((v - mean) ** 2 for v in self.values) / n
            std = math.sqrt(var)
            if std > 0:
                z = (x - mean) / std
                if z > self.zscore:
                    return True, z
            elif x > mean * 2 and mean > 0:
                # zero variance (constant window) — any doubling is
                # anomalous even though z is undefined
                return True, None
        self.values.append(x)
        return False, None


class HealthMonitor(TrainingCallback):
    """Anomaly detection over ``Model.fit`` — see module docstring.

    ``clock`` is injectable (tests drive step-time outliers without
    sleeping); all state resets at ``on_train_begin`` so one monitor
    can watch successive fits.
    """

    def __init__(self, action="warn", window=50, min_samples=10,
                 grad_zscore=6.0, step_time_zscore=6.0,
                 plateau_window=0, plateau_min_delta=1e-4,
                 watch_grad_norm=True, skip_first_steps=1,
                 recover_after=1, rollback_kinds=("non_finite_loss",
                                                  "grad_spike",
                                                  "param_divergence"),
                 max_rollbacks=3, registry=None, tracer=None, clock=None,
                 profiler=None):
        super().__init__()
        if action not in _ACTIONS:
            raise ValueError(f"action must be one of {_ACTIONS}")
        self.action = action
        self.rollback_kinds = tuple(rollback_kinds)
        self.max_rollbacks = int(max_rollbacks)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.grad_zscore = float(grad_zscore)
        self.step_time_zscore = float(step_time_zscore)
        self.plateau_window = int(plateau_window)
        self.plateau_min_delta = float(plateau_min_delta)
        self.watch_grad_norm = watch_grad_norm
        self.skip_first_steps = int(skip_first_steps)
        self.recover_after = int(recover_after)
        self._registry = registry
        self._tracer = tracer
        self._profiler = profiler
        self._clock = clock or time.perf_counter
        self._reset_state()

    def _reset_state(self):
        self._grad = _RollingZ(self.window, self.grad_zscore,
                               self.min_samples)
        self._step_time = _RollingZ(self.window, self.step_time_zscore,
                                    self.min_samples)
        self._losses = collections.deque(maxlen=max(self.plateau_window, 1))
        self._best_window_mean = None
        self._steps_since_best = 0
        self._active = set()        # conditions currently true
        self._clean_streak = 0
        self._step = 0
        self._t_begin = None
        self.events = []            # [(kind, step, detail)] this run
        self.rollbacks = 0          # rollbacks requested this run

    # ---- wiring ---------------------------------------------------------
    def registry(self):
        if self._registry is None:
            from .metrics import default_registry

            self._registry = default_registry()
        return self._registry

    def tracer(self):
        if self._tracer is None:
            from .tracing import default_tracer

            self._tracer = default_tracer()
        return self._tracer

    @property
    def healthy(self):
        return not self._active

    # ---- hooks ----------------------------------------------------------
    def on_train_begin(self, logs=None):
        self._reset_state()
        self.registry().gauge(
            "training_healthy",
            "1 = no active training anomaly, 0 = unhealthy").set(1)
        model = self.model
        if self.watch_grad_norm and \
                hasattr(model, "enable_grad_norm_logging"):
            model.enable_grad_norm_logging()

    def on_train_batch_begin(self, step, logs=None):
        self._t_begin = self._clock()

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        self._step += 1
        firing = []

        loss = logs.get("loss")
        loss_bad = loss is not None and not math.isfinite(float(loss))
        if loss_bad:
            firing.append(("non_finite_loss",
                           {"loss": repr(float(loss)), "step": step}))
        else:
            # a non-finite loss makes every downstream signal (grad
            # norm, plateau) trivially insane — one root cause, one
            # event, not three echoes of it
            gnorm = logs.get("grad_norm")
            if gnorm is not None:
                out, z = self._grad.observe(float(gnorm))
                if out:
                    firing.append(("grad_spike",
                                   {"grad_norm": float(gnorm), "z": z,
                                    "threshold": self.grad_zscore,
                                    "step": step}))
            if loss is not None and self.plateau_window > 0:
                firing.extend(self._check_plateau(float(loss), step))

        if self._t_begin is not None and \
                self._step > self.skip_first_steps:
            dt = self._clock() - self._t_begin
            out, z = self._step_time.observe(dt)
            if out:
                firing.append(("step_time_outlier",
                               {"step_time_s": dt, "z": z,
                                "threshold": self.step_time_zscore,
                                "step": step}))
        self._t_begin = None
        self._resolve(firing, step)

    def on_train_end(self, logs=None):
        pass

    # ---- detection helpers ----------------------------------------------
    def _check_plateau(self, loss, step):
        self._losses.append(loss)
        if len(self._losses) < self.plateau_window:
            return []
        mean = sum(self._losses) / len(self._losses)
        if self._best_window_mean is None or \
                mean < self._best_window_mean - self.plateau_min_delta:
            self._best_window_mean = mean
            self._steps_since_best = 0
            return []
        self._steps_since_best += 1
        if self._steps_since_best == self.plateau_window:
            # fire once per stall; the counter resets so a *continuing*
            # plateau re-fires only after another full window
            self._steps_since_best = 0
            return [("loss_plateau",
                     {"window_mean": mean,
                      "best_window_mean": self._best_window_mean,
                      "window": self.plateau_window, "step": step})]
        return []

    # ---- event plumbing --------------------------------------------------
    def external_anomaly(self, kind, detail, step):
        """Report an anomaly detected by a subsystem OUTSIDE this
        monitor's own signals (the integrity sentinel's
        ``param_divergence`` / ``step_replay_mismatch``) through the
        same counter/span/action machinery — including
        ``action="rollback"`` for kinds in ``rollback_kinds``.  The
        caller owns onset dedup; ``detail`` may carry
        ``restore_before`` (bound the rollback's restore walk) and
        ``rewind`` (replay the data instead of skipping it)."""
        self._clean_streak = 0
        self._report(kind, dict(detail), step)

    def _resolve(self, firing, step):
        fired_kinds = {kind for kind, _ in firing}
        new = [(k, d) for k, d in firing if k not in self._active]
        # non_finite_loss is a *state* (the params are poisoned — every
        # later step reports it too) and stays active to dedup; spikes,
        # plateaus and outliers are instantaneous events
        self._active = {k for k in fired_kinds if k == "non_finite_loss"}
        self._clean_streak = 0 if fired_kinds else self._clean_streak + 1
        healthy = not self._active and (
            not self.events or self._clean_streak >= self.recover_after)
        self.registry().gauge(
            "training_healthy",
            "1 = no active training anomaly, 0 = unhealthy"
        ).set(1 if healthy else 0)
        for kind, detail in new:
            self._report(kind, detail, step)

    def _report(self, kind, detail, step):
        self.events.append((kind, step, detail))
        self.registry().counter(
            "training_anomalies_total",
            "training anomalies detected by HealthMonitor",
            labelnames=("kind",)).labels(kind=kind).inc()
        span = self.tracer().start_trace(f"health::{kind}",
                                         attributes=dict(detail))
        span.end()
        if self._profiler is not None:
            # escalate the stack sampler while the anomaly is hot; the
            # capture continues this health:: span's trace
            self._profiler.trigger_capture("health", detail=kind,
                                           context=span.context())
        msg = f"training anomaly {kind} at step {step}: {detail}"
        if self.action == "rollback" and kind in self.rollback_kinds:
            self.rollbacks += 1
            if self.rollbacks > self.max_rollbacks:
                raise TrainingHealthError(
                    kind, f"{msg} — rollback #{self.rollbacks} exceeds "
                          f"max_rollbacks={self.max_rollbacks}; the run "
                          f"is not recoverable by rewinding")
            logger.warning("%s — requesting rollback to last good "
                           "checkpoint", msg)
            if self.model is not None:
                # Model.fit executes this after the callback round for
                # the step completes (so the checkpoint callback's
                # bookkeeping for the poisoned step is already visible)
                req = {"reason": kind, "step": step}
                for key in ("restore_before", "rewind"):
                    if key in detail:
                        req[key] = detail[key]
                self.model._rollback_request = req
            return
        if self.action in ("warn", "rollback"):
            logger.warning(msg)
        elif self.action == "raise":
            raise TrainingHealthError(kind, msg)
