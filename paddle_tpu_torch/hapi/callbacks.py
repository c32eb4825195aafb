"""hapi callbacks (the port of ``paddle_tpu/hapi/callbacks.py``):
``Callback``, ``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler``, ``ProfilerCallback`` and the
crash-safe ``CheckpointCallback`` with ``restore_fit_state``.

A fit checkpoint holds the JAX package's tree (``params``, ``buffers``,
``opt``: the ``{"step", "slots"}`` state of ``train_batch``) in its
format, so one package's fit checkpoint restores in the other.  The
random state differs by nature: the JAX package keeps threefry keys
under ``rng``, the port keeps each ``torch.Generator``'s state under
``torch_rng``, and each package restores only its own (neither key
can seed the other's generator).  A restore writes into the live
tensors in place, so the captured train step keeps replaying without a
new capture."""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

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


class ProfilerCallback(Callback):
    """Step-aware profiling of ``Model.fit``: each train batch runs inside
    a ``hapi::train_batch`` ``RecordEvent`` and ends with
    ``profiler.step()``, so the scheduler's window advances a batch at a
    time.  Pass a configured ``paddle_tpu_torch.profiler.Profiler``, or
    the arguments to build one (``scheduler=(wait, warmup, active,
    repeat)``, ``on_trace_ready=export_chrome_tracing(dir)``)."""

    def __init__(self, profiler=None, scheduler=None, on_trace_ready=None,
                 with_device=False):
        super().__init__()
        if profiler is None:
            from ..profiler import Profiler

            profiler = Profiler(scheduler=scheduler,
                                on_trace_ready=on_trace_ready,
                                with_device=with_device)
        self.profiler = profiler
        self._batch_event = None

    def on_train_begin(self, logs=None):
        self.profiler.start()

    def on_train_batch_begin(self, step, logs=None):
        from ..profiler import RecordEvent

        self._batch_event = RecordEvent("hapi::train_batch")
        self._batch_event.begin()

    def on_train_batch_end(self, step, logs=None):
        if self._batch_event is not None:
            self._batch_event.end()
            self._batch_event = None
        self.profiler.step()

    def on_train_end(self, logs=None):
        self.profiler.stop()


def _pack_fit_state(model):
    """The tree a killed ``fit`` needs to continue: params, buffers, the
    optimizer state of ``train_batch`` and every random stream's state
    (``torch_rng``: its key and each device generator's); with the manifest's ``rng_counters`` (the JAX
    package's stream counters; none here).  In a world the parameters
    and slots are whole, gathered from the ranks' windows, so every rank
    packs the same tree."""
    from ..core.random import get_rng_state

    net = model.network
    params, st = model._whole_state()
    tree = {"params": params, "buffers": dict(net.named_buffers())}
    if st is not None:
        tree["opt"] = st
    tree["torch_rng"] = dict(get_rng_state())
    return tree, {}


def _lr_scheduler_of(model):
    """The optimizer's LRScheduler, or None; its JSON-scalar state rides
    in the manifest's ``extra``."""
    opt = getattr(model, "_optimizer", None)
    sched = getattr(opt, "_lr_scheduler", None)
    return sched if hasattr(sched, "state_dict") else None


def _unflatten(flat):
    """path → leaf dict (the host form of ``load_sharded``) back to nested
    dicts."""
    out = {}
    for path, leaf in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else \
        torch.from_numpy(np.array(v, copy=True))


def _as_tensors(tree):
    return {k: _as_tensors(v) if isinstance(v, dict) else _as_tensor(v)
            for k, v in tree.items()}


def _copy_tree(dst, src):
    """Copy every leaf of ``src`` present in the tensor tree ``dst`` into
    it, in place (an optimizer without slots saves none)."""
    for k, v in (src or {}).items():
        if k not in dst:
            continue
        if isinstance(dst[k], dict):
            _copy_tree(dst[k], v)
        else:
            dst[k].copy_(_as_tensor(v))


@torch.no_grad()
def _apply_fit_state(model, tree, extra):
    from ..core.random import set_rng_state

    net = model.network
    model._unhold()     # a world's next step cuts the windows anew
    _copy_tree(dict(net.named_parameters()), tree.get("params"))
    _copy_tree(dict(net.named_buffers()), tree.get("buffers"))
    opt = model._optimizer
    if "opt" in tree and opt is not None and model._mesh is not None:
        # the tree's slots are whole: this rank keeps its windows
        whole = opt.init_state(dict(net.named_parameters()))
        _copy_tree(whole["slots"], tree["opt"].get("slots"))
        whole["step"] = int(np.asarray(tree["opt"]["step"]))
        model._opt_state = model._window_state(whole)
    elif "opt" in tree and opt is not None:
        if model._opt_state is None:
            model._opt_state = opt.init_state(dict(net.named_parameters()))
        _copy_tree(model._opt_state["slots"], tree["opt"].get("slots"))
        model._opt_state["step"] = int(np.asarray(tree["opt"]["step"]))
    rng = tree.get("torch_rng")
    if rng:
        set_rng_state(_as_tensors(rng))
    sched_state = extra.get("lr_scheduler")
    sched = _lr_scheduler_of(model)
    if sched_state and sched is not None:
        sched.set_state_dict(sched_state)


def restore_fit_state(model, resume_from, before_step=None):
    """Restore the newest intact fit checkpoint under ``resume_from`` (a
    directory or a ``CheckpointManager``) into ``model``, in place.
    Returns the manifest ``extra`` (epoch / next_step / global_step) or
    None when there is no checkpoint yet, so a first launch and a
    relaunch are one code path.  ``before_step``: only checkpoints
    strictly older (a rollback must not restore the anomalous step's own
    save)."""
    from ..resilience.checkpoint_manager import CheckpointManager

    mgr = resume_from if isinstance(resume_from, CheckpointManager) \
        else CheckpointManager(resume_from)
    try:
        _, flat, manifest = mgr.restore(before_step=before_step)
    except FileNotFoundError:
        return None
    extra = manifest.get("extra", {})
    _apply_fit_state(model, _unflatten(flat), extra)
    return dict(extra)


class CheckpointCallback(Callback):
    """Crash-safe periodic checkpointing for ``Model.fit``: every
    ``every_n_steps`` train batches the fit state is committed through a
    ``CheckpointManager``, so ``fit(resume_from=save_dir)`` continues a
    killed run from the last committed step with the loss curve of the
    uninterrupted run.  ``keep_last_n`` bounds disk; ``async_save`` moves
    the write off the training thread (the device→host snapshot stays on
    it, so the saved state is step-consistent)."""

    def __init__(self, save_dir=None, every_n_steps=10, keep_last_n=3,
                 async_save=False, manager=None, verify_on_save=False):
        super().__init__()
        if manager is None:
            from ..resilience.checkpoint_manager import CheckpointManager

            if save_dir is None:
                raise ValueError("CheckpointCallback needs save_dir "
                                 "or manager")
            manager = CheckpointManager(save_dir, keep_last_n=keep_last_n,
                                        async_save=async_save,
                                        verify_on_save=verify_on_save)
        self.manager = manager
        self.every_n_steps = int(every_n_steps)
        self._epoch = 0
        self._global_step = 0
        self._skipped_windows = []
        self._repairs = []

    def on_train_begin(self, logs=None):
        info = getattr(self.model, "_resume_info", None) or {}
        self._global_step = int(info.get("global_step", 0))
        # skipped windows and integrity repairs ride in every later
        # manifest, however many relaunches later
        self._skipped_windows = [dict(w) for w
                                 in info.get("skipped_windows", [])]
        self._repairs = [dict(r) for r in info.get("repairs", [])]

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        self._global_step += 1
        if self._global_step % self.every_n_steps == 0:
            self._save(next_step=step + 1)

    def on_train_end(self, logs=None):
        self.manager.wait()        # surface a failed async save here

    def rewind_to(self, global_step):
        """Integrity rewind-and-replay: step counting follows the restored
        checkpoint; replayed steps re-save at the same step numbers."""
        self._global_step = int(global_step)

    def record_repair(self, repair):
        """Remember an integrity repair (no data skipped)."""
        self._repairs.append(dict(repair))

    def record_rollback(self, window, next_step):
        """Make a health rollback durable: remember the skipped data
        window and commit the restored state at once, with ``next_step``
        past the window, so a kill right after resumes beyond it."""
        self._skipped_windows.append(dict(window))
        self._save(next_step=next_step)

    def _save(self, next_step):
        t0 = time.perf_counter()
        tree, rng_counters = _pack_fit_state(self.model)
        extra = {"kind": "hapi_fit", "epoch": self._epoch,
                 "next_step": next_step, "global_step": self._global_step,
                 "rng_counters": rng_counters}
        if self._skipped_windows:
            extra["skipped_windows"] = [dict(w) for w
                                        in self._skipped_windows]
        if self._repairs:
            extra["repairs"] = [dict(r) for r in self._repairs]
        sched = _lr_scheduler_of(self.model)
        if sched is not None:
            extra["lr_scheduler"] = sched.state_dict()
        self.manager.save(tree, step=self._global_step, extra=extra)
        # the training thread's cost of this save: the whole write for
        # sync, the device→host snapshot and handoff for async
        from ..observability.metrics import default_registry

        default_registry().histogram(
            "checkpoint_save_seconds",
            "checkpoint save duration by mode (sync/async block the "
            "training thread; background is the overlapped write)",
            labelnames=("mode",),
        ).labels(mode="async" if self.manager.async_save else "sync") \
            .observe(time.perf_counter() - t0)

