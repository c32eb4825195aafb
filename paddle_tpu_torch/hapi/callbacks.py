"""hapi callbacks (the port of ``paddle_tpu/hapi/callbacks.py``):
``Callback``, ``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping`` and ``LRScheduler``.  The JAX package's crash-safe
``CheckpointCallback`` (with ``restore_fit_state``) and
``ProfilerCallback`` are not ported and raise."""
from __future__ import annotations

import os
import sys
import time

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "ProfilerCallback", "CheckpointCallback",
           "CallbackList", "restore_fit_state"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = dict(params or {})

    # the reference's full hook surface
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


class CallbackList:
    def __init__(self, callbacks, model=None, params=None):
        self.callbacks = list(callbacks)
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def call(self, hook, *args, **kwargs):
        for c in self.callbacks:
            getattr(c, hook)(*args, **kwargs)

    def __getattr__(self, hook):
        if hook.startswith("on_"):
            return lambda *a, **k: self.call(hook, *a, **k)
        raise AttributeError(hook)


class ProgBarLogger(Callback):
    """Per-epoch progress line (reference: hapi/callbacks.py ProgBarLogger;
    rendered as plain log lines — terminals are not guaranteed)."""

    def __init__(self, log_freq=10, verbose=1):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}",
                  file=sys.stderr)

    def _fmt(self, logs):
        return " - ".join(
            f"{k}: {v:.4f}" if isinstance(v, (int, float, np.floating))
            else f"{k}: {v}" for k, v in (logs or {}).items())

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and (step + 1) % self.log_freq == 0:
            print(f"step {step + 1}/{self.steps or '?'} - "
                  f"{self._fmt(logs)}", file=sys.stderr)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            print(f"Epoch {epoch + 1} done ({dt:.1f}s) - "
                  f"{self._fmt(logs)}", file=sys.stderr)

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}", file=sys.stderr)


class ModelCheckpoint(Callback):
    """Save every N epochs (reference semantics: save_dir/{epoch}, plus
    'final' at train end)."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """Stop when a monitored metric stops improving (reference:
    hapi/callbacks.py EarlyStopping)."""

    def __init__(self, monitor="loss", mode="auto", patience=0,
                 min_delta=0, baseline=None, save_best_model=True,
                 save_dir=None):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.save_dir = save_dir
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.reset()

    def reset(self):
        self.wait = 0
        self.stopped_epoch = -1
        self.best = (-np.inf if self.mode == "max" else np.inf) \
            if self.baseline is None else self.baseline

    def _better(self, cur):
        if self.mode == "max":
            return cur > self.best + self.min_delta
        return cur < self.best - self.min_delta

    def on_train_begin(self, logs=None):
        self.reset()

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        if self._better(cur):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.save_dir:
                self.model.save(os.path.join(self.save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
                self.model.stop_training = True


class LRScheduler(Callback):
    """Step the optimizer's LRScheduler (reference: by_step/by_epoch)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        assert by_step != by_epoch, "choose exactly one trigger"
        self.by_step = by_step

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr_scheduler", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if not self.by_step and s is not None:
            s.step()


class CheckpointCallback(Callback):
    """Not ported: crash-safe checkpoints for ``fit(resume_from=)``."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "CheckpointCallback is not ported (see ROADMAP.md)")


class ProfilerCallback(Callback):
    """Not ported: step-aware profiling of ``fit``."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ProfilerCallback is not ported (see ROADMAP.md)")


def restore_fit_state(model, resume_from, before_step=None):
    raise NotImplementedError(
        "restore_fit_state is not ported (see ROADMAP.md)")
