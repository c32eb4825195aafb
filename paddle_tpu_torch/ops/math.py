"""Elementwise and scalar math ops (the port of ``paddle_tpu/ops/math.py``;
parity: python/paddle/tensor/math.py).  ``sigmoid``, ``tanh`` and
``softplus`` are ``activation.py``'s, here under the JAX module's path
too.  Operands may be tensors or Python scalars, as in the JAX
package."""
from __future__ import annotations

import torch

from ..core.dispatch import register_op
from .activation import sigmoid, softplus, tanh  # noqa: F401

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "maximum", "minimum", "fmax", "fmin", "atan2", "hypot",
    "scale", "abs", "neg", "sign", "exp", "expm1", "log", "log2", "log10",
    "log1p", "sqrt", "rsqrt", "square", "reciprocal", "sin", "cos", "tan",
    "asin", "acos", "atan", "sinh", "cosh", "asinh", "acosh", "atanh",
    "ceil", "floor", "round", "trunc", "frac", "erf", "erfinv", "lgamma",
    "digamma", "logit", "clip", "isnan", "isinf", "isfinite", "nan_to_num",
    "multiply_add", "stanh", "logsumexp", "lerp", "cumsum", "cumprod",
    "cummax", "cummin", "diff", "gcd", "lcm", "equal", "not_equal",
    "less_than", "less_equal", "greater_than", "greater_equal",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "allclose",
    "isclose", "equal_all", "where", "heaviside", "sigmoid", "tanh",
    "softplus"]


def _pair(x, y):
    """Both operands as tensors on one device (a Python scalar follows
    the tensor)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=y.device)
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(y, device=x.device)
    return x, y


def _dims(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(axis)
    return (axis,)


# ----------------------------------------------------------------- binary


@register_op("add")
def add(x, y):
    return torch.add(*_pair(x, y))


@register_op("subtract")
def subtract(x, y):
    return torch.subtract(*_pair(x, y))


@register_op("multiply")
def multiply(x, y):
    return torch.multiply(*_pair(x, y))


@register_op("divide")
def divide(x, y):
    return torch.true_divide(*_pair(x, y))


@register_op("floor_divide")
def floor_divide(x, y):
    return torch.div(*_pair(x, y), rounding_mode="floor")


@register_op("remainder")
def remainder(x, y):
    return torch.remainder(*_pair(x, y))


mod = remainder


@register_op("pow")
def pow(x, y):  # noqa: A001
    return torch.pow(x, y)


@register_op("maximum")
def maximum(x, y):
    return torch.maximum(*_pair(x, y))


@register_op("minimum")
def minimum(x, y):
    return torch.minimum(*_pair(x, y))


@register_op("fmax")
def fmax(x, y):
    return torch.fmax(*_pair(x, y))


@register_op("fmin")
def fmin(x, y):
    return torch.fmin(*_pair(x, y))


@register_op("atan2")
def atan2(x, y):
    return torch.atan2(*_pair(x, y))


@register_op("hypot")
def hypot(x, y):
    return torch.hypot(*_pair(x, y))


# ------------------------------------------------------------------ unary


@register_op("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def _unary(name, fn):
    def op(x):
        return fn(x)

    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"``{fn.__module__}.{fn.__name__}`` elementwise."
    return register_op(name)(op)


abs = _unary("abs", torch.abs)  # noqa: A001
neg = _unary("neg", torch.neg)
sign = _unary("sign", torch.sign)
exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
square = _unary("square", torch.square)
reciprocal = _unary("reciprocal", torch.reciprocal)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
ceil = _unary("ceil", torch.ceil)
floor = _unary("floor", torch.floor)
round = _unary("round", torch.round)  # noqa: A001  (half to even)
trunc = _unary("trunc", torch.trunc)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
lgamma = _unary("lgamma", torch.lgamma)
digamma = _unary("digamma", torch.digamma)


@register_op("frac")
def frac(x):
    return x - torch.trunc(x)


@register_op("logit")
def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@register_op("clip")
def clip(x, min=None, max=None):  # noqa: A002
    return torch.clamp(x, min, max)


@register_op("isnan", differentiable=False)
def isnan(x):
    return torch.isnan(x)


@register_op("isinf", differentiable=False)
def isinf(x):
    return torch.isinf(x)


@register_op("isfinite", differentiable=False)
def isfinite(x):
    return torch.isfinite(x)


@register_op("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


# -------------------------------------------------------------- compound


@register_op("multiply_add")
def multiply_add(x, y, z):
    """x * y + z."""
    return x * y + z


@register_op("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@register_op("logsumexp")
def logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(x, dim=_dims(axis, x.dim()), keepdim=keepdim)


@register_op("lerp")
def lerp(x, y, weight):
    return x + weight * (y - x)


@register_op("cumsum")
def cumsum(x, axis=None):
    if axis is None:
        return torch.cumsum(x.reshape(-1), dim=0)
    return torch.cumsum(x, dim=axis)


@register_op("cumprod")
def cumprod(x, dim=None):
    if dim is None:
        return torch.cumprod(x.reshape(-1), dim=0)
    return torch.cumprod(x, dim=dim)


@register_op("cummax", differentiable=False)
def cummax(x, axis=-1):
    return torch.cummax(x, dim=axis).values


@register_op("cummin", differentiable=False)
def cummin(x, axis=-1):
    return torch.cummin(x, dim=axis).values


@register_op("diff")
def diff(x, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


@register_op("gcd", differentiable=False)
def gcd(x, y):
    return torch.gcd(*_pair(x, y))


@register_op("lcm", differentiable=False)
def lcm(x, y):
    return torch.lcm(*_pair(x, y))


# ----------------------------------------------------------------- logic


def _compare(name, fn):
    def op(x, y):
        return fn(*_pair(x, y))

    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"``{fn.__name__}`` elementwise, with broadcasting."
    return register_op(name, differentiable=False)(op)


equal = _compare("equal", torch.eq)
not_equal = _compare("not_equal", torch.ne)
less_than = _compare("less_than", torch.lt)
less_equal = _compare("less_equal", torch.le)
greater_than = _compare("greater_than", torch.gt)
greater_equal = _compare("greater_equal", torch.ge)
logical_and = _compare("logical_and", torch.logical_and)
logical_or = _compare("logical_or", torch.logical_or)
logical_xor = _compare("logical_xor", torch.logical_xor)
bitwise_and = _compare("bitwise_and", torch.bitwise_and)
bitwise_or = _compare("bitwise_or", torch.bitwise_or)
bitwise_xor = _compare("bitwise_xor", torch.bitwise_xor)


@register_op("logical_not", differentiable=False)
def logical_not(x):
    return torch.logical_not(x)


@register_op("bitwise_not", differentiable=False)
def bitwise_not(x):
    return torch.bitwise_not(x)


@register_op("allclose", differentiable=False)
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = _pair(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


@register_op("isclose", differentiable=False)
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(*_pair(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


@register_op("equal_all", differentiable=False)
def equal_all(x, y):
    x, y = _pair(x, y)
    return torch.tensor(x.shape == y.shape and bool(torch.equal(x, y)),
                        device=x.device)


@register_op("where")
def where(condition, x, y):
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        x = torch.as_tensor(x, device=condition.device)
    return torch.where(condition, *_pair(x, y))


@register_op("heaviside")
def heaviside(x, y):
    """0 where x < 0, 1 where x > 0, y where x == 0 (``jnp.heaviside``,
    with its gradient: 1 for y where x == 0)."""
    x, y = _pair(x, y)
    return torch.where(x > 0, torch.ones_like(x),
                       torch.where(x < 0, torch.zeros_like(x), y.to(x.dtype)))
