"""The optimizers (the port of ``paddle_tpu/optimizer/optimizers.py``),
each with the JAX package's update rule and slot names.  Momentum, the
ResNet path's optimizer, also updates a whole list at once with
``torch._foreach_*`` (the same arithmetic, fewer launches).

``update(param, grad, slots, lr, step)``: ``step`` is a 0-d fp32 tensor
on the device, ``lr`` a number or such a tensor; no rule reads a value
back to the host (``optimizer.py``)."""
from __future__ import annotations

import torch

from .optimizer import Optimizer, bias_correction

__all__ = ["SGD", "Momentum", "Adagrad", "RMSProp", "Adam", "AdamW", "Lamb",
           "Adadelta", "Adamax"]


def _scaled(t, lr):
    """``lr · t`` in ``t``'s dtype; for a half tensor the product is
    taken in fp32 and rounded once, as a Python-float ``lr`` is
    applied."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return (t.float() * lr).to(t.dtype)
    return t * lr


class SGD(Optimizer):
    def update(self, param, grad, slots, lr, step):
        return param - _scaled(grad, lr), slots


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_slots(self, param):
        return {"velocity": torch.zeros_like(param, requires_grad=False)}

    def update(self, param, grad, slots, lr, step):
        v = self._momentum * slots["velocity"] + grad
        if self._nesterov:
            new_param = param - _scaled(grad + self._momentum * v, lr)
        else:
            new_param = param - _scaled(v, lr)
        return new_param, {"velocity": v}

    def _apply_all(self, ps, gs, slot_list, lr, step):
        vs = [s["velocity"] for s in slot_list]
        torch._foreach_mul_(vs, self._momentum)
        torch._foreach_add_(vs, gs)
        if self._nesterov:
            upd = torch._foreach_add(gs, torch._foreach_mul(
                vs, self._momentum))
            torch._foreach_sub_(ps, torch._foreach_mul(upd, lr))
        else:
            torch._foreach_sub_(ps, torch._foreach_mul(vs, lr))


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def init_slots(self, param):
        return {"moment": torch.full_like(param, self._init_acc,
                                          requires_grad=False)}

    def update(self, param, grad, slots, lr, step):
        m = slots["moment"] + grad * grad
        new_param = param - _scaled(grad, lr) / (torch.sqrt(m)
                                                 + self._epsilon)
        return new_param, {"moment": m}


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def init_slots(self, param):
        z = lambda: torch.zeros_like(param, requires_grad=False)  # noqa: E731
        s = {"mean_square": z(), "momentum": z()}
        if self._centered:
            s["mean_grad"] = z()
        return s

    def update(self, param, grad, slots, lr, step):
        ms = self._rho * slots["mean_square"] + (1 - self._rho) * grad * grad
        out = dict(slots)
        out["mean_square"] = ms
        if self._centered:
            mg = self._rho * slots["mean_grad"] + (1 - self._rho) * grad
            out["mean_grad"] = mg
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * slots["momentum"] + _scaled(grad, lr) / denom
        out["momentum"] = mom
        return param - mom, out


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def init_slots(self, param):
        # fp32 moments for half-precision parameters, as in JAX
        mdt = (torch.float32 if param.dtype in (torch.bfloat16,
                                                torch.float16)
               else param.dtype)
        return {"moment1": torch.zeros(param.shape, dtype=mdt,
                                       device=param.device),
                "moment2": torch.zeros(param.shape, dtype=mdt,
                                       device=param.device)}

    def update(self, param, grad, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        gf = grad.to(slots["moment1"].dtype)
        m = b1 * slots["moment1"] + (1 - b1) * gf
        v = b2 * slots["moment2"] + (1 - b2) * gf * gf
        m_hat = m / bias_correction(b1, step)
        v_hat = v / bias_correction(b2, step)
        upd = (lr * m_hat / (torch.sqrt(v_hat) + self._epsilon)).to(
            param.dtype)
        return param - upd, {"moment1": m, "moment2": v}


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision)
        self._decoupled_wd = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun

    def _apply_decay(self, param, grad):
        return grad  # decoupled: applied in update

    def update(self, param, grad, slots, lr, step):
        new_param, new_slots = super().update(param, grad, slots, lr, step)
        if self._decoupled_wd:
            new_param = new_param - _scaled(param, lr * self._decoupled_wd)
        return new_param, new_slots


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def init_slots(self, param):
        return {"moment1": torch.zeros(param.shape, dtype=torch.float32,
                                       device=param.device),
                "moment2": torch.zeros(param.shape, dtype=torch.float32,
                                       device=param.device)}

    def _direction(self, param, grad, slots, step):
        """``(param in fp32, r, moment1, moment2)``: the rule before its
        trust ratio."""
        b1, b2 = self._beta1, self._beta2
        gf, pf = grad.float(), param.float()
        m = b1 * slots["moment1"] + (1 - b1) * gf
        v = b2 * slots["moment2"] + (1 - b2) * gf * gf
        m_hat = m / bias_correction(b1, step)
        v_hat = v / bias_correction(b2, step)
        r = m_hat / (torch.sqrt(v_hat) + self._epsilon) + self._wd * pf
        return pf, r, m, v

    @staticmethod
    def _trust(p_norm, r_norm):
        return torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                           1.0)

    def update(self, param, grad, slots, lr, step):
        pf, r, m, v = self._direction(param, grad, slots, step)
        trust = self._trust(torch.linalg.vector_norm(pf),
                            torch.linalg.vector_norm(r))
        return ((pf - lr * trust * r).to(param.dtype),
                {"moment1": m, "moment2": v})

    def _apply_windows(self, ps, gs, slot_list, lr, step, whole_sums):
        """The rule on windows: the trust ratio takes the whole
        parameter's and the whole update's norms (the squared sums of
        every window, one reduction for all parameters)."""
        dirs = [self._direction(p, g, s, step)
                for p, g, s in zip(ps, gs, slot_list)]
        sq = whole_sums([torch.stack([torch.sum(torch.square(pf)),
                                      torch.sum(torch.square(r))])
                         for pf, r, _, _ in dirs])
        for p, s, (pf, r, m, v), q in zip(ps, slot_list, dirs, sq):
            trust = self._trust(torch.sqrt(q[0]), torch.sqrt(q[1]))
            p.copy_((pf - lr * trust * r).to(p.dtype))
            s["moment1"].copy_(m)
            s["moment2"].copy_(v)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._rho = rho

    def init_slots(self, param):
        return {"avg_squared_grad": torch.zeros_like(param,
                                                     requires_grad=False),
                "avg_squared_update": torch.zeros_like(param,
                                                       requires_grad=False)}

    def update(self, param, grad, slots, lr, step):
        rho, eps = self._rho, self._epsilon
        asg = rho * slots["avg_squared_grad"] + (1 - rho) * grad * grad
        upd = grad * torch.sqrt(slots["avg_squared_update"] + eps) / \
            torch.sqrt(asg + eps)
        asu = rho * slots["avg_squared_update"] + (1 - rho) * upd * upd
        return param - _scaled(upd, lr), {"avg_squared_grad": asg,
                                  "avg_squared_update": asu}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def init_slots(self, param):
        return {"moment": torch.zeros_like(param, requires_grad=False),
                "inf_norm": torch.zeros_like(param, requires_grad=False)}

    def update(self, param, grad, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["moment"] + (1 - b1) * grad
        u = torch.maximum(b2 * slots["inf_norm"], grad.abs())
        new_param = param - _scaled(m, lr / bias_correction(b1, step)) / (
            u + self._epsilon)
        return new_param, {"moment": m, "inf_norm": u}
