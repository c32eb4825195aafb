"""Probability distributions (the port of
``paddle_tpu/distribution/__init__.py``; parity:
python/paddle/distribution/ — Distribution base, Normal, Uniform,
Categorical, Bernoulli, Beta, Dirichlet, kl_divergence).

Densities, entropies, moments and the KL table are the JAX package's
formulas in torch, on the device of the parameters (a Python or numpy
parameter lands on the device of ``set_device``).  Sampling draws from
the port's generator of that device (``core.random.generator``), which
``paddle.seed`` seeds: reproducible under one seed, but not the JAX
package's PRNG stream.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.place import current_device
from ..core.random import generator

__all__ = ["Distribution", "Normal", "Uniform", "Categorical", "Bernoulli",
           "Beta", "Dirichlet", "kl_divergence"]


def _arr(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=current_device())


def _val(value, like):
    return _arr(value).to(like.device)


def _bshape(*ts):
    return tuple(torch.broadcast_shapes(*(t.shape for t in ts)))


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def rsample(self, shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return torch.exp(self.log_prob(value))

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        return kl_divergence(self, other)


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _arr(loc)
        self.scale = _arr(scale).to(self.loc.device)

    def sample(self, shape=(), seed=0):
        dev = self.loc.device
        z = torch.randn(tuple(shape) + _bshape(self.loc, self.scale),
                        generator=generator(dev), device=dev)
        return self.loc + self.scale * z

    rsample = sample

    def log_prob(self, value):
        v = _val(value, self.loc)
        var = self.scale ** 2
        return (-((v - self.loc) ** 2) / (2 * var)
                - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return (0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)
                + torch.zeros_like(self.loc))

    @property
    def mean(self):
        return self.loc + torch.zeros_like(self.scale)

    @property
    def variance(self):
        return self.scale ** 2 + torch.zeros_like(self.loc)


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low = _arr(low)
        self.high = _arr(high).to(self.low.device)

    def sample(self, shape=(), seed=0):
        dev = self.low.device
        u = torch.rand(tuple(shape) + _bshape(self.low, self.high),
                       generator=generator(dev), device=dev)
        return self.low + (self.high - self.low) * u

    rsample = sample

    def log_prob(self, value):
        v = _val(value, self.low)
        inside = (v >= self.low) & (v < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, -math.inf)

    def entropy(self):
        return torch.log(self.high - self.low)


class Categorical(Distribution):
    def __init__(self, logits=None, probs=None, name=None):
        if logits is None and probs is None:
            raise ValueError("need logits or probs")
        if logits is None:
            logits = torch.log(torch.clamp(_arr(probs), min=1e-38))
        self.logits = _arr(logits)

    @property
    def probs(self):
        return torch.softmax(self.logits, dim=-1)

    def sample(self, shape=(), seed=0):
        """Gumbel-max over the logits (as ``jax.random.categorical``)."""
        dev = self.logits.device
        e = torch.empty(tuple(shape) + tuple(self.logits.shape),
                        device=dev).exponential_(generator=generator(dev))
        return torch.argmax(self.logits - torch.log(e), dim=-1)

    def log_prob(self, value):
        v = _arr(value).to(device=self.logits.device, dtype=torch.int64)
        logp = torch.log_softmax(self.logits, dim=-1)
        batch = torch.broadcast_shapes(logp.shape[:-1], v.shape)
        logp = logp.expand(*batch, logp.shape[-1])
        return torch.gather(logp, -1, v.expand(batch)[..., None])[..., 0]

    def entropy(self):
        logp = torch.log_softmax(self.logits, dim=-1)
        return -(torch.exp(logp) * logp).sum(-1)


class Bernoulli(Distribution):
    def __init__(self, probs=None, logits=None, name=None):
        if probs is not None:
            self.probs_ = _arr(probs)
        else:
            self.probs_ = torch.sigmoid(_arr(logits))

    def sample(self, shape=(), seed=0):
        dev = self.probs_.device
        u = torch.rand(tuple(shape) + tuple(self.probs_.shape),
                       generator=generator(dev), device=dev)
        return (u < self.probs_).to(torch.float32)

    def log_prob(self, value):
        v = _val(value, self.probs_)
        p = torch.clamp(self.probs_, 1e-7, 1 - 1e-7)
        return v * torch.log(p) + (1 - v) * torch.log1p(-p)

    def entropy(self):
        p = torch.clamp(self.probs_, 1e-7, 1 - 1e-7)
        return -(p * torch.log(p) + (1 - p) * torch.log1p(-p))

    @property
    def mean(self):
        return self.probs_


def _algdiv(a, b):
    """log(Γ(b) / Γ(a + b)) for b >= 8 (scipy cdflib ``algdiv``, as
    ``jax.scipy.special.betaln`` computes it; assumes a <= b)."""
    c0 = 0.833333333333333e-01
    c1 = -0.277777777760991e-02
    c2 = 0.793650666825390e-03
    c3 = -0.595202931351870e-03
    c4 = 0.837308034031215e-03
    c5 = -0.165322962780713e-02
    h = a / b
    c = h / (1 + h)
    x = h / (1 + h)
    d = b + (a - 0.5)
    x2 = x * x
    s3 = 1.0 + (x + x2)
    s5 = 1.0 + (x + x2 * s3)
    s7 = 1.0 + (x + x2 * s5)
    s9 = 1.0 + (x + x2 * s7)
    s11 = 1.0 + (x + x2 * s9)
    t = (1.0 / b) ** 2
    w = ((((c5 * s11 * t + c4 * s9) * t + c3 * s7) * t + c2 * s5) * t
         + c1 * s3) * t + c0
    w = w * (c / b)
    u = d * torch.log1p(a / b)
    v = a * (torch.log(b) - 1.0)
    return torch.where(u <= v, (w - v) - u, (w - u) - v)


def betaln(a, b):
    """log B(a, b), as ``jax.scipy.special.betaln``: lgamma sums below
    b = 8, scipy's ``algdiv`` correction above."""
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    small_b = torch.lgamma(a) + (torch.lgamma(b) - torch.lgamma(a + b))
    large_b = torch.lgamma(a) + _algdiv(a, b)
    return torch.where(b < 8, small_b, large_b)


class Beta(Distribution):
    def __init__(self, alpha, beta, name=None):
        self.alpha = _arr(alpha)
        self.beta = _arr(beta).to(self.alpha.device)

    def sample(self, shape=(), seed=0):
        """X / (X + Y) of X ~ Γ(α), Y ~ Γ(β)."""
        dev = self.alpha.device
        full = tuple(shape) + _bshape(self.alpha, self.beta)
        gen = generator(dev)
        x = torch._standard_gamma(self.alpha.expand(full).contiguous(),
                                  generator=gen)
        y = torch._standard_gamma(self.beta.expand(full).contiguous(),
                                  generator=gen)
        return x / (x + y)

    def log_prob(self, value):
        v = _val(value, self.alpha)
        return ((self.alpha - 1) * torch.log(v)
                + (self.beta - 1) * torch.log1p(-v)
                - betaln(self.alpha, self.beta))


class Dirichlet(Distribution):
    def __init__(self, concentration, name=None):
        self.concentration = _arr(concentration)

    def sample(self, shape=(), seed=0):
        a = self.concentration
        full = tuple(shape) + tuple(a.shape)
        return torch._sample_dirichlet(a.expand(full).contiguous(),
                                       generator=generator(a.device))

    def log_prob(self, value):
        v = _val(value, self.concentration)
        a = self.concentration
        return (((a - 1) * torch.log(v)).sum(-1)
                + torch.lgamma(a.sum(-1)) - torch.lgamma(a).sum(-1))


# ----------------------------------------------------------------- KL table


def kl_divergence(p, q):
    """Parity: paddle.distribution.kl_divergence (registered pairs)."""
    if isinstance(p, Normal) and isinstance(q, Normal):
        var_p, var_q = p.scale ** 2, q.scale ** 2
        return (torch.log(q.scale / p.scale)
                + (var_p + (p.loc - q.loc) ** 2) / (2 * var_q) - 0.5)
    if isinstance(p, Categorical) and isinstance(q, Categorical):
        logp = torch.log_softmax(p.logits, -1)
        logq = torch.log_softmax(q.logits, -1)
        return (torch.exp(logp) * (logp - logq)).sum(-1)
    if isinstance(p, Bernoulli) and isinstance(q, Bernoulli):
        pp = torch.clamp(p.probs_, 1e-7, 1 - 1e-7)
        qq = torch.clamp(q.probs_, 1e-7, 1 - 1e-7)
        return (pp * (torch.log(pp) - torch.log(qq))
                + (1 - pp) * (torch.log1p(-pp) - torch.log1p(-qq)))
    if isinstance(p, Uniform) and isinstance(q, Uniform):
        inside = (q.low <= p.low) & (p.high <= q.high)
        kl = torch.log((q.high - q.low) / (p.high - p.low))
        return torch.where(inside, kl, math.inf)
    raise NotImplementedError(
        f"kl_divergence({type(p).__name__}, {type(q).__name__}) "
        "not registered")
