"""Optimizer base (the port of ``paddle_tpu/optimizer/optimizer.py``).

Each optimizer is an update rule, ``update(param, grad, slots, lr, step)
→ (new_param, new_slots)``, over tensors with the JAX package's math.
Two paths apply it, as in JAX:

- ``step()``, the eager path: each parameter's ``.grad``, the gradient
  clip, coupled L2 decay (``grad + wd·param``; AdamW decouples it), the
  parameter's ``optimize_attr["learning_rate"]`` multiplier and, with
  ``multi_precision``, an fp32 master of a half-precision parameter;
- ``apply_gradients(params, grads, state, lr)``, the path of
  ``hapi.Model.train_batch`` (JAX's jitted step): named gradients and a
  ``{"step", "slots": {name: {...}}}`` state, with no per-parameter
  learning rate and no masters.  It writes the parameters and slots in
  place (nothing here is traced, so nothing needs a pure function) and
  returns the state with its step advanced.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        from .lr import LRScheduler

        self._lr = learning_rate
        self._lr_scheduler = (learning_rate if isinstance(
            learning_rate, LRScheduler) else None)
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._step_count = 0
        self._slots: dict[int, dict] = {}          # id(param) -> slots
        self._master_weights: dict[int, torch.Tensor] = {}

    # ------------------------------------------------------------ subclasses
    def init_slots(self, param):
        """The slot tensors (momentum, moments, …) of one parameter."""
        return {}

    def update(self, param, grad, slots, lr, step):
        """The update rule: returns ``(new_param, new_slots)``."""
        raise NotImplementedError

    # ------------------------------------------------------------ lr
    def get_lr(self):
        if self._lr_scheduler is not None:
            return self._lr_scheduler()
        return float(self._lr)

    def set_lr(self, value):
        if self._lr_scheduler is not None:
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = value

    # ------------------------------------------------------------ eager path
    @torch.no_grad()
    def step(self):
        params = self._parameter_list
        if params is None:
            raise ValueError("Optimizer constructed without parameters")
        lr = self.get_lr()
        step = self._step_count + 1
        grads = [(p, p.grad) for p in params
                 if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None and grads:
            clipped = self._grad_clip([g for _, g in grads])
            grads = [(p, g) for (p, _), g in zip(grads, clipped)]
        for p, g in grads:
            g = self._apply_decay(p, g)
            pid = id(p)
            if pid not in self._slots:
                self._slots[pid] = self.init_slots(p)
                if self._multi_precision and p.dtype in (torch.bfloat16,
                                                         torch.float16):
                    self._master_weights[pid] = p.detach().float()
            plr = lr * getattr(p, "optimize_attr", {}).get(
                "learning_rate", 1.0)
            if pid in self._master_weights:
                master, slots = self.update(
                    self._master_weights[pid], g.float(), self._slots[pid],
                    plr, step)
                self._master_weights[pid] = master
                p.copy_(master)
            else:
                new, slots = self.update(p, g.to(p.dtype), self._slots[pid],
                                         plr, step)
                p.copy_(new)
            self._slots[pid] = slots
        self._step_count = step

    def clear_grad(self):
        for p in self._parameter_list or ():
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    # ----------------------------------------------------------------- state
    def _keys(self):
        return [(p, getattr(p, "name", None) or f"param_{i}")
                for i, p in enumerate(self._parameter_list or ())]

    def state_dict(self):
        """``{"step", "<name>.<slot>", "<name>.master", "LR_Scheduler"}``,
        the JAX package's keys (``<name>`` is the parameter's name, else
        ``param_{i}``)."""
        out = {"step": self._step_count}
        for p, key in self._keys():
            for sname, t in self._slots.get(id(p), {}).items():
                out[f"{key}.{sname}"] = t
            if id(p) in self._master_weights:
                out[f"{key}.master"] = self._master_weights[id(p)]
        if self._lr_scheduler is not None:
            out["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return out

    def set_state_dict(self, state):
        """Loads what ``state_dict`` gives, or the JAX package's (numpy
        values are taken too)."""
        self._step_count = int(state.get("step", 0))
        for p, key in self._keys():
            slots = self.init_slots(p)
            found = False
            for sname in list(slots):
                if f"{key}.{sname}" in state:
                    slots[sname] = _like(state[f"{key}.{sname}"],
                                         slots[sname])
                    found = True
            if found:
                self._slots[id(p)] = slots
            if f"{key}.master" in state:
                self._master_weights[id(p)] = torch.as_tensor(
                    state[f"{key}.master"], dtype=torch.float32,
                    device=p.device)
        if self._lr_scheduler is not None and "LR_Scheduler" in state:
            self._lr_scheduler.set_state_dict(state["LR_Scheduler"])

    # ------------------------------------------------------- the hapi path
    def init_state(self, params):
        """``{name: param}`` → ``{"step": 0, "slots": {name: {...}}}``."""
        return {"step": 0,
                "slots": {k: self.init_slots(p) for k, p in params.items()}}

    @torch.no_grad()
    def apply_gradients(self, params, grads, state, lr=None):
        """One update of every named parameter from ``grads`` (the same
        names; a ``None`` gradient leaves its parameter as it is), in
        place; returns the new state.  JAX's order: clip, then decay
        (the gradient cast to the parameter's dtype), then the rule."""
        lr = self.get_lr() if lr is None else lr
        step = state["step"] + 1
        names = [k for k in params if grads.get(k) is not None]
        gs = [grads[k] for k in names]
        if self._grad_clip is not None:
            gs = self._grad_clip(gs)
        ps = [params[k] for k in names]
        gs = [self._apply_decay(p, g.to(p.dtype)) for p, g in zip(ps, gs)]
        slots = dict(state["slots"])
        self._apply_all(ps, gs, [slots[k] for k in names], lr, step)
        return {"step": step, "slots": slots}

    def _apply_all(self, ps, gs, slot_list, lr, step):
        """Apply the rule to each parameter in place (its slot dict too);
        an optimizer may override this with one batched update."""
        for p, g, s in zip(ps, gs, slot_list):
            new, new_slots = self.update(p, g, s, lr, step)
            p.copy_(new)
            s.update(new_slots)

    def _apply_decay(self, param, grad):
        """Coupled L2 (the reference's default); AdamW decouples it."""
        wd = self._weight_decay
        if wd is None or wd == 0.0 or not isinstance(wd, (int, float)):
            return grad
        return grad + wd * param.to(grad.dtype)


def _like(value, template):
    return torch.as_tensor(value, dtype=template.dtype,
                           device=template.device).clone()
