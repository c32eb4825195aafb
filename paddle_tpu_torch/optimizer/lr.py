"""LR schedulers (the port of ``paddle_tpu/optimizer/lr.py``: the same 16
schedulers, plain Python over the step count)."""
from __future__ import annotations

import math

__all__ = [
    "LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
    "InverseTimeDecay", "PolynomialDecay", "LinearWarmup", "ExponentialDecay",
    "MultiStepDecay", "StepDecay", "LambdaDecay", "ReduceOnPlateau",
    "CosineAnnealingDecay", "MultiplicativeDecay", "OneCycleLR",
    "CyclicLR",
]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = None
        self.step()

    def get_lr(self):
        raise NotImplementedError

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list, tuple, type(None)))}

    def set_state_dict(self, state):
        self.__dict__.update(state)

    set_dict = set_state_dict
    state_keys = state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        a = step ** -0.5
        b = step * (self.warmup_steps ** -1.5)
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * div
        else:
            step = min(step, decay_steps)
        frac = (1 - step / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.inner = learning_rate if isinstance(learning_rate, LRScheduler) else None
        self.peak_lr = learning_rate if not self.inner else None
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * self.last_epoch / \
                max(self.warmup_steps, 1) + self.start_lr
        if self.inner is not None:
            self.inner.last_epoch = self.last_epoch - self.warmup_steps
            return self.inner.get_lr()
        return self.peak_lr

    def state_dict(self):
        d = super().state_dict()
        if self.inner is not None:
            d["inner"] = self.inner.state_dict()
        return d

    def set_state_dict(self, state):
        inner = state.pop("inner", None)
        super().set_state_dict(state)
        if inner and self.inner is not None:
            self.inner.set_state_dict(inner)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** (self.last_epoch // self.step_size))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        self._cur = float(learning_rate)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self._cur = self._cur * self.lr_lambda(self.last_epoch)
        return self._cur


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self._current = float(learning_rate)
        super().__init__(learning_rate, -1, verbose)

    def get_lr(self):
        return self._current

    def step(self, metrics=None, epoch=None):
        self.last_epoch += 1
        if metrics is None:
            self.last_lr = self._current
            return
        m = float(metrics)
        if self.best is None or self._is_better(m):
            self.best = m
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self._current * self.factor, self.min_lr)
            if self._current - new_lr > self.epsilon:
                self._current = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        self.last_lr = self._current

    def _is_better(self, m):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return m < self.best * (1 - self.threshold)
            return m < self.best - self.threshold
        if self.threshold_mode == "rel":
            return m > self.best * (1 + self.threshold)
        return m > self.best + self.threshold


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return (end - start) * pct + start

    def get_lr(self):
        up_steps = int(self.total_steps * self.phase_pct)
        step = min(self.last_epoch, self.total_steps)
        if step <= up_steps and up_steps > 0:
            return self._interp(self.initial_lr, self.max_lr, step / up_steps)
        down = (step - up_steps) / max(self.total_steps - up_steps, 1)
        return self._interp(self.max_lr, self.end_lr, down)


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", gamma=1.0,
                 last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.step_up = step_size_up
        self.step_down = step_size_down or step_size_up
        self.mode = mode
        self.gamma = gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        cycle_len = self.step_up + self.step_down
        cycle = self.last_epoch // cycle_len
        pos = self.last_epoch % cycle_len
        if pos < self.step_up:
            pct = pos / self.step_up
        else:
            pct = 1 - (pos - self.step_up) / self.step_down
        amp = self.max_lr - self.base_lr
        if self.mode == "triangular2":
            amp = amp / (2 ** cycle)
        elif self.mode == "exp_range":
            amp = amp * (self.gamma ** self.last_epoch)
        return self.base_lr + amp * pct
