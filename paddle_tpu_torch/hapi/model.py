"""hapi ``Model`` (the port of ``paddle_tpu/hapi/model.py``): ``prepare``,
``train_batch``/``eval_batch``/``predict_batch``, ``fit``/``evaluate``/
``predict``, ``save``/``load`` and ``summary``.

``train_batch`` is the JAX package's jitted step done eagerly: forward,
loss, ``torch.autograd.grad`` over every named parameter, then
``optimizer.apply_gradients`` with the same math (clip, coupled decay,
the rule; no per-parameter learning rate, as in JAX's jitted path); batch
norm updates its running statistics in place during the forward.
``eval_batch`` and ``predict_batch`` run the network in whatever mode it
is in and, as JAX's pure eval step does, keep no buffer update.

``save``/``load`` use the JAX package's format, so a checkpoint saved by
either package loads in the other: ``path.pdparams`` is a pickled
``{"params": {name: array}, "buffers": {name: array}}`` of numpy arrays
(bf16 tensors as fp32), ``path.pdopt`` the ``{"step", "slots": {name:
{slot: array}}}`` tree of ``train_batch``'s optimizer state.  Both writes
are atomic.

Not ported, raising ``NotImplementedError``: ``prepare(device_mesh=)``,
``fit(resume_from=)`` and the rollback, health and fault-site paths."""
from __future__ import annotations

import contextlib
import os
import pickle

import numpy as np
import torch

from ..core.place import current_device
from ..io.dataloader import DataLoader
from ..models.convert import _to_numpy, opt_state_from_jax
from ..resilience.atomic import atomic_write
from .callbacks import CallbackList, ModelCheckpoint, ProgBarLogger

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _numpy(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class Model:
    """High-level facade over a ``Layer``.  Batches go to the device of
    ``set_device`` (CUDA unless the caller chose the CPU)."""

    def __init__(self, network, inputs=None, labels=None):
        self.device = current_device()
        self.network = network
        self.stop_training = False
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._opt_state = None        # train_batch's optimizer state
        self._watch_grad_norm = False

    def enable_grad_norm_logging(self):
        """Make ``train_batch`` report the global gradient norm
        (``logs["grad_norm"]``); one extra reduction and host read."""
        self._watch_grad_norm = True
        return self

    def prepare(self, optimizer=None, loss=None, metrics=None,
                device_mesh=None, sharding_rules=()):
        if device_mesh is not None or sharding_rules:
            raise NotImplementedError(
                "prepare(device_mesh=...): multi-GPU hapi is not ported "
                "(see ROADMAP.md)")
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        return self

    def _tensor(self, x):
        x = _to_list(x)[0]
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, copy=True))
        return x.to(self.device, non_blocking=True)

    # ------------------------------------------------- train / eval batch
    def train_batch(self, inputs, labels):
        """One optimization step; returns ``(loss, metric results)``."""
        x, y = self._tensor(inputs), self._tensor(labels)
        opt, net = self._optimizer, self.network
        params = dict(net.named_parameters())
        if self._opt_state is None:
            self._opt_state = opt.init_state(params)
        out = net(x)
        loss = self._loss(out, y)
        live = [k for k, p in params.items() if p.requires_grad]
        got = torch.autograd.grad(loss, [params[k] for k in live],
                                  allow_unused=True)
        # a parameter the loss does not reach has a zero gradient (JAX's
        # value_and_grad), so decay still applies to it; a frozen one
        # (trainable=False) is left as it is
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(live, got)}
        results = {}
        if self._watch_grad_norm:
            results["grad_norm"] = float(torch.sqrt(sum(
                torch.sum(torch.square(g.float())) for g in grads.values())))
        self._opt_state = opt.apply_gradients(params, grads, self._opt_state,
                                              opt.get_lr())
        results = {**self._update_metrics(out.detach(), y), **results}
        return float(loss.detach()), results

    @contextlib.contextmanager
    def _buffers_kept(self):
        """Run the network without keeping its buffer updates."""
        net = self.network
        if not any(m.training for m in net.modules()):
            yield
            return
        saved = {k: b.clone() for k, b in net.named_buffers()}
        try:
            yield
        finally:
            with torch.no_grad():
                for k, b in net.named_buffers():
                    b.copy_(saved[k])

    def eval_batch(self, inputs, labels):
        x, y = self._tensor(inputs), self._tensor(labels)
        with torch.no_grad(), self._buffers_kept():
            out = self.network(x)
            loss = self._loss(out, y) if self._loss else None
        results = self._update_metrics(out, y)
        return (float(loss) if loss is not None else 0.0), results

    def predict_batch(self, inputs):
        x = self._tensor(inputs)
        with torch.no_grad(), self._buffers_kept():
            out = self.network(x)
        return _numpy(out)

    def _update_metrics(self, out, y):
        """Each metric's compute → update; list-named results (Accuracy
        with several k) are reported one key each."""
        results = {}
        for m in self._metrics:
            res = m.compute(out, y)
            val = m.update(*res) if isinstance(res, tuple) else m.update(res)
            names = m.name()
            if isinstance(names, list):
                vals = val if isinstance(val, (list, tuple)) else [val]
                results.update(dict(zip(names, vals)))
            else:
                results[names] = val
        return results

    # ------------------------------------------------------------- the fit
    @staticmethod
    def _loader(data, batch_size, shuffle):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=1, shuffle=True, callbacks=None, resume_from=None,
            **kw):
        if resume_from is not None:
            raise NotImplementedError(
                "fit(resume_from=...) is not ported (see ROADMAP.md)")
        train_loader = self._loader(train_data, batch_size, shuffle)
        eval_loader = self._loader(eval_data, batch_size, False)
        cbs = _to_list(callbacks)
        if verbose and not any(isinstance(c, ProgBarLogger) for c in cbs):
            cbs = [ProgBarLogger(log_freq, verbose)] + cbs
        if save_dir:
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cblist = CallbackList(cbs, model=self,
                              params={"epochs": epochs, "steps": steps,
                                      "verbose": verbose,
                                      "metrics": self._metric_names()})
        self.stop_training = False
        cblist.on_train_begin()
        history, logs = [], {}
        for epoch in range(epochs):
            cblist.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(train_loader):
                cblist.on_train_batch_begin(step)
                loss, res = self.train_batch(batch[0], batch[1])
                logs = {"loss": loss, **res}
                cblist.on_train_batch_end(step, logs)
                if self.stop_training:
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, callbacks=[],
                                          verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cblist.on_epoch_end(epoch, logs)
            history.append(logs)
            if self.stop_training:
                break
        cblist.on_train_end(logs)
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=1,
                 callbacks=None, **kw):
        loader = self._loader(eval_data, batch_size, False)
        cblist = CallbackList(_to_list(callbacks), model=self, params={})
        for m in self._metrics:
            m.reset()
        cblist.on_eval_begin()
        logs = {}
        for step, batch in enumerate(loader):
            cblist.on_eval_batch_begin(step)
            loss, res = self.eval_batch(batch[0], batch[1])
            logs = {"loss": loss, **res}
            cblist.on_eval_batch_end(step, logs)
        cblist.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, **kw):
        loader = self._loader(test_data, batch_size, False)
        outs = []
        for batch in loader:
            x = batch[0] if isinstance(batch, (list, tuple)) else batch
            outs.append(self.predict_batch(x))
        return [np.concatenate(outs, axis=0)]

    # ---------------------------------------------------------- save/load
    def _metric_names(self):
        names = []
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def save(self, path):
        """``path.pdparams`` (+ ``path.pdopt`` when prepared), each
        written atomically."""
        net = self.network
        blob = {"params": {k: _numpy(p) for k, p in net.named_parameters()},
                "buffers": {k: _numpy(b) for k, b in net.named_buffers()}}
        with atomic_write(path + ".pdparams") as f:
            pickle.dump(blob, f, protocol=4)
        if self._opt_state is not None:
            st = self._opt_state
            opt_blob = {"step": np.asarray(st["step"], np.int32),
                        "slots": {k: {n: _numpy(t) for n, t in s.items()}
                                  for k, s in st["slots"].items()}}
        elif self._optimizer is not None:
            opt_blob = {k: _numpy(v) if isinstance(v, torch.Tensor) else v
                        for k, v in self._optimizer.state_dict().items()}
        else:
            return
        with atomic_write(path + ".pdopt") as f:
            pickle.dump(opt_blob, f, protocol=4)

    def load(self, path):
        """Load what ``save`` wrote, or what the JAX package's
        ``Model.save`` wrote: values are copied into the network's
        tensors (their dtype and device kept)."""
        with open(path + ".pdparams", "rb") as f:
            blob = pickle.load(f)
        net = self.network
        own = {**dict(net.named_parameters()), **dict(net.named_buffers())}
        with torch.no_grad():
            for k, v in {**blob["params"], **blob.get("buffers", {})}.items():
                if k in own:
                    own[k].copy_(torch.from_numpy(np.array(_to_numpy(v))))
        opt_path = path + ".pdopt"
        if os.path.exists(opt_path):
            with open(opt_path, "rb") as f:
                blob_opt = pickle.load(f)
            if isinstance(blob_opt, dict) and "slots" in blob_opt:
                templates = None
                if self._optimizer is not None:
                    templates = self._optimizer.init_state(dict(
                        net.named_parameters()))["slots"]
                self._opt_state = opt_state_from_jax(blob_opt, self.device,
                                                     templates)
            elif self._optimizer is not None:
                self._optimizer.set_state_dict(blob_opt)
        return self

    def parameters(self):
        return self.network.parameters()

    def summary(self, input_size=None):
        total = sum(p.numel() for p in self.network.parameters())
        return f"{type(self.network).__name__}: {total:,} parameters"
