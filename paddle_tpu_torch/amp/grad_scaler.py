"""GradScaler (the port of ``paddle_tpu/amp/grad_scaler.py``): dynamic
loss scaling for fp16, with the JAX package's state machine and one host
sync a step (the finite check over every gradient is reduced on the
device, then read once)."""
from __future__ import annotations

import torch

__all__ = ["GradScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=None):
        self._enable = enable
        self._use_dynamic = (use_dynamic_loss_scaling
                             if use_dynamic_loss_scaling is not None else True)
        self._scale = float(init_loss_scaling) if self._use_dynamic else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False  # once-per-step latch (explicit-unscale flow)

    def scale(self, loss):
        if not self._enable or self._scale == 1.0:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer):
        # while dynamic scaling is on the finite check always runs, even at
        # the 1.0 floor of the scale
        if not self._enable or (not self._use_dynamic and self._scale == 1.0):
            return
        if self._unscaled:
            raise RuntimeError(
                "unscale_() has already been called on this scaler since "
                "the last step()")
        self._unscaled = True
        inv = 1.0 / self._scale
        found = None
        with torch.no_grad():
            for p in optimizer._parameter_list or []:
                if p.grad is None:
                    continue
                p.grad.mul_(inv)
                bad = ~torch.isfinite(p.grad).all()
                found = bad if found is None else found | bad
        self._found_inf = bool(found) if found is not None else False

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)  # no-ops itself when scaling is off
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            optimizer.step()
            self._good_steps += 1
            if self._use_dynamic and self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._unscaled = False

    def update(self):
        pass

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        optimizer.clear_grad()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._use_dynamic

    def get_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
