"""Neural-net functional ops (the port of ``paddle_tpu/ops/nn_ops.py``):
convolution, pooling, normalisation and dropout with the JAX package's
signatures and arithmetic.

The JAX package computes these with XLA ops, outside any Pallas kernel,
so they stay PyTorch ops here.  What differs from ``torch.nn.functional``
is kept on purpose:

- padding takes every JAX form: an int, one value per dimension, a flat
  low/high value per side (which may be asymmetric), or ``"SAME"``/``"VALID"`` with XLA's
  SAME at any stride; the asymmetric forms are padded explicitly first;
- an fp32 convolution is true fp32 on the card, forward and backward,
  whatever ``torch.backends.cudnn.allow_tf32`` says outside the call (the
  JAX package asks for ``Precision.HIGHEST`` on fp32 operands);
- max pooling pads with −inf, ``ceil_mode`` adds trailing padding, and an
  ``exclusive`` average divides by the count of in-bounds elements;
- batch norm normalises in fp32 with the biased batch variance, casts to
  the input's dtype and only then applies the weight and bias, and
  returns the batch mean and variance for the caller's running stats;
- ``interpolate`` is ``jax.image.resize``: half-pixel sample points,
  nearest at ``floor((i + 0.5) · in / out)``, linear and cubic (Keys,
  a = −0.5) kernels widened by in/out when shrinking (antialiasing), and
  ``align_corners`` ignored, as there; ``area`` is its linear.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..core.dispatch import register_op
from ..core.random import generator

__all__ = ["conv1d", "conv2d", "conv3d", "conv2d_transpose", "max_pool2d",
           "avg_pool2d", "adaptive_avg_pool2d", "adaptive_max_pool2d",
           "global_avg_pool2d", "layer_norm", "rms_norm", "batch_norm_infer",
           "batch_norm_train", "instance_norm", "group_norm",
           "local_response_norm", "embedding", "dropout", "dropout2d",
           "interpolate", "pixel_shuffle", "unfold"]


def _at_least_fp32(x):
    """The JAX package's ``astype(float32)`` for the dtypes it has: half
    precision goes up to fp32; fp64 (which JAX does not enable) stays,
    so a float64 evaluation of the port is one end to end."""
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def _tuple(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


def _same_pads(sizes, k, stride, dilation):
    """XLA's SAME: output ceil(size / stride), padding split low-first."""
    pads = []
    for size, kk, s, d in zip(sizes, k, stride, dilation):
        out = -(-size // s)
        total = max((out - 1) * s + (kk - 1) * d + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _conv_padding(padding, sizes, k, stride, dilation):
    """Any JAX padding form → one (low, high) pair per spatial dim."""
    nd = len(sizes)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * nd
        if padding.upper() == "SAME":
            return _same_pads(sizes, k, stride, dilation)
        raise ValueError(f"bad padding: {padding}")
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd:
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    raise ValueError(f"bad padding: {padding}")


def _pad_arg(pads):
    """(low, high) pairs, first spatial dim first → ``F.pad``'s order."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


@contextlib.contextmanager
def _cudnn_exact(fp32):
    """cuDNN's deterministic algorithms for the call (the same bits from
    run to run, as the TPU gives), and its TF32 off for an fp32 one."""
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    if fp32:
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.allow_tf32) = prev


class _ExactConv(torch.autograd.Function):
    """``aten.convolution`` with cuDNN deterministic for the forward and
    the backward, and its TF32 off when the input is fp32, so a
    convolution gives the same bits on every run and an fp32 one is fp32
    whatever the flags say outside (the backward runs later, in
    autograd's thread, so a switch around the forward call alone would not
    cover it).  cuDNN's default weight-gradient algorithms sum in an order
    that varies from run to run."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, transposed,
                output_padding, groups):
        ctx.fp32 = x.dtype == torch.float32
        with _cudnn_exact(ctx.fp32):
            out = torch.ops.aten.convolution(
                x, w, b, stride, padding, dilation, transposed,
                output_padding, groups)
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, transposed, output_padding,
                    groups)
        ctx.bias_sizes = None if b is None else list(b.shape)
        return out

    @staticmethod
    def backward(ctx, gout):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        mask = [need[0], need[1], ctx.bias_sizes is not None and need[2]]
        with _cudnn_exact(ctx.fp32):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gout, x, w, ctx.bias_sizes, *ctx.conf, mask)
        return gx, gw, gb, None, None, None, None, None, None


def _convolution(x, w, b, stride, pads, dilation, groups, transposed=False):
    """One convolution with (low, high) pads; asymmetric ones are applied
    to ``x`` first (non-transposed only)."""
    nd = len(pads)
    if any(lo != hi for lo, hi in pads):
        x = F.pad(x, _pad_arg(pads))
        pads = [(0, 0)] * nd
    return _ExactConv.apply(x, w, b, list(stride), [lo for lo, _ in pads],
                            list(dilation), transposed, [0] * nd, groups)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nd):
    stride, dilation = _tuple(stride, nd), _tuple(dilation, nd)
    pads = _conv_padding(padding, x.shape[2:], weight.shape[2:], stride,
                         dilation)
    return _convolution(x, weight, bias, stride, pads, dilation, groups)


@register_op("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """``data_format="NHWC"`` takes an HWIO ``weight``, as in JAX."""
    if data_format == "NHWC":
        out = _conv_nd(x.permute(0, 3, 1, 2), weight.permute(3, 2, 0, 1),
                       bias, stride, padding, dilation, groups, 2)
        return out.permute(0, 2, 3, 1)
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2)


@register_op("conv1d")
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1)


@register_op("conv3d")
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3)


@register_op("conv2d_transpose")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    """``weight`` is Paddle's (in, out/groups, kh, kw), torch's layout for
    a transposed convolution.  The full transposed convolution is cropped
    by the (possibly asymmetric) padding and extended by
    ``output_padding`` (which, as in JAX, may reach past the stride)."""
    if isinstance(padding, str):
        raise NotImplementedError("string padding for conv_transpose")
    stride, dilation = _tuple(stride), _tuple(dilation)
    opad = _tuple(output_padding)
    pads = _conv_padding(padding, x.shape[2:], weight.shape[2:], stride,
                         dilation)
    out = _convolution(x, weight, None, stride, [(0, 0)] * 2, dilation,
                       groups, transposed=True)
    out = F.pad(out, _pad_arg([(-lo, o - hi)
                               for (lo, hi), o in zip(pads, opad)]))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# ----------------------------------------------------------------- pooling


def _ceil_extra_pad(size, k, s, pad_lo, pad_hi):
    """Extra trailing pad so the window count is the ceil-mode one."""
    out_ceil = math.ceil((size + pad_lo + pad_hi - k) / s) + 1
    needed = (out_ceil - 1) * s + k - (size + pad_lo + pad_hi)
    return max(needed, 0)


def _pool_pads(x, k, s, padding, ceil_mode):
    pads = _conv_padding(padding, x.shape[2:4], k, s, (1, 1))
    if ceil_mode and not isinstance(padding, str):
        pads = [(lo, hi + _ceil_extra_pad(size, kk, ss, lo, hi))
                for (lo, hi), size, kk, ss in zip(pads, x.shape[2:4], k, s)]
    return pads


@register_op("max_pool2d")
def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    k = _tuple(kernel_size)
    s = _tuple(stride) if stride is not None else k
    pads = _pool_pads(x, k, s, padding, ceil_mode)
    fill = (-math.inf if x.is_floating_point()
            else torch.iinfo(x.dtype).min)
    return F.max_pool2d(F.pad(x, _pad_arg(pads), value=fill), k, s)


@register_op("avg_pool2d")
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCHW"):
    """Windows summed over the zero-padded input, divided by the count of
    in-bounds elements (``exclusive``, numeric padding) or by the window
    size (otherwise, and for string padding, as in JAX)."""
    k = _tuple(kernel_size)
    s = _tuple(stride) if stride is not None else k
    pads = _pool_pads(x, k, s, padding, ceil_mode)
    summed = F.avg_pool2d(F.pad(x, _pad_arg(pads)), k, s,
                          divisor_override=1)
    if exclusive and not isinstance(padding, str):
        ones = torch.ones((1, 1) + tuple(x.shape[2:4]), dtype=x.dtype,
                          device=x.device)
        counts = F.avg_pool2d(F.pad(ones, _pad_arg(pads)), k, s,
                              divisor_override=1)
        return summed / torch.clamp(counts, min=1.0)
    return summed / (k[0] * k[1])


@register_op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    # torch's bins (floor(i·h/oh) to ceil((i+1)·h/oh)) are JAX's
    return F.adaptive_avg_pool2d(x, _tuple(output_size))


@register_op("adaptive_max_pool2d")
def adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    oh, ow = _tuple(output_size)
    n, c, h, w = x.shape
    if h % oh or w % ow:
        raise NotImplementedError("non-divisible adaptive_max_pool2d")
    # amax splits the gradient among tied maxima, as jnp.max does
    return x.reshape(n, c, oh, h // oh, ow, w // ow).amax(dim=(3, 5))


@register_op("global_avg_pool2d")
def global_avg_pool2d(x, data_format="NCHW"):
    dims = (2, 3) if data_format == "NCHW" else (1, 2)
    return x.mean(dim=dims, keepdim=True)


# ------------------------------------------------------------------- norms


@register_op("layer_norm")
def layer_norm(x, weight=None, bias=None, epsilon=1e-5, normalized_ndim=1):
    shape = tuple(x.shape[x.dim() - normalized_ndim:])
    out = F.layer_norm(_at_least_fp32(x), shape, eps=epsilon).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def _bn_layout(x, data_format):
    if data_format.startswith("NC"):
        return (0,) + tuple(range(2, x.dim())), [1, -1] + [1] * (x.dim() - 2)
    return tuple(range(x.dim() - 1)), [1] * (x.dim() - 1) + [-1]


def _fp32(*ts):
    return all(t is None or t.dtype == torch.float32 for t in ts)


@register_op("batch_norm_infer")
def batch_norm_infer(x, running_mean, running_var, weight=None, bias=None,
                     epsilon=1e-5, data_format="NCHW"):
    if data_format.startswith("NC") and x.dim() > 1 and _fp32(
            x, running_mean, running_var, weight, bias) and not (
            running_mean.requires_grad or running_var.requires_grad):
        return F.batch_norm(x, running_mean, running_var, weight, bias,
                            False, 0.0, epsilon)
    _, shape = _bn_layout(x, data_format)
    out = (x - running_mean.reshape(shape)) * torch.rsqrt(
        running_var.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@register_op("batch_norm_train")
def batch_norm_train(x, weight=None, bias=None, epsilon=1e-5,
                     data_format="NCHW"):
    """Returns ``(out, batch_mean, batch_var)``; the variance is the
    biased one, which the caller's running stats take (JAX ``jnp.var``).
    The mean and variance carry their gradients, as JAX's do."""
    dims, shape = _bn_layout(x, data_format)
    xf = _at_least_fp32(x)
    var, mean = torch.var_mean(xf, dim=dims, correction=0)
    if data_format.startswith("NC") and _fp32(x, weight, bias):
        # the same function: (x - mean)·rsqrt(var + eps)·w + b in fp32
        out = F.batch_norm(xf, None, None, weight, bias, True, 0.0, epsilon)
        return out, mean, var
    bvar, bmean = torch.var_mean(xf, dim=dims, correction=0, keepdim=True)
    out = ((xf - bmean) * torch.rsqrt(bvar + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out, mean, var


@register_op("group_norm")
def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    return F.group_norm(x, num_groups, weight, bias, epsilon)


# ----------------------------------------------------------------- dropout


@register_op("dropout")
def dropout(x, p=0.5, training=True, mode="upscale_in_train"):
    """The keep mask is drawn from the port's generator of ``x``'s device
    (``core.random``): uniform draws below 1 − p are kept."""
    if not training:
        # downscale_in_infer: train keeps the raw mask, infer scales
        return x if mode == "upscale_in_train" else x * (1.0 - p)
    if p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator(x.device),
                      device=x.device) < keep
    if mode == "upscale_in_train":
        return torch.where(mask, x / keep, 0).to(x.dtype)
    return torch.where(mask, x, 0).to(x.dtype)


@register_op("dropout2d")
def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    """Drops whole channels: one keep draw per (sample, channel) from the
    port's generator of ``x``'s device."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    shape = ((x.shape[0], x.shape[1], 1, 1) if data_format == "NCHW"
             else (x.shape[0], 1, 1, x.shape[3]))
    mask = torch.rand(shape, generator=generator(x.device),
                      device=x.device) < keep
    return torch.where(mask, x / keep, 0).to(x.dtype)


# ------------------------------------------------------------ norms (more)


@register_op("rms_norm")
def rms_norm(x, weight=None, epsilon=1e-6):
    xf = _at_least_fp32(x)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


@register_op("instance_norm")
def instance_norm(x, weight=None, bias=None, epsilon=1e-5):
    dims = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    shape = [1, -1] + [1] * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@register_op("local_response_norm")
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0):
    sq = torch.square(x)
    half = size // 2
    c = x.shape[1]
    pad = [0, 0] * (x.dim() - 2) + [half, size - 1 - half]
    padded = F.pad(sq, pad)
    acc = sum(padded[:, i:i + c] for i in range(size))
    return x / torch.pow(k + alpha * acc / size, beta)


@register_op("embedding")
def embedding(ids, weight, padding_idx=None, sparse=False):
    # F.embedding's CUDA backward sums a repeated id's rows in a fixed
    # order, as the JAX gather's scatter-add does (index_select's adds
    # with atomics, and two runs on the card differ in the last bits)
    out = F.embedding(ids, weight)
    if padding_idx is not None:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


# ------------------------------------------------------------- interpolate


def _cubic(x):
    """Keys' cubic kernel, a = -0.5 (``jax.image``'s)."""
    a = -0.5
    x = x.abs()
    return torch.where(
        x <= 1, ((a + 2) * x - (a + 3)) * x * x + 1,
        torch.where(x < 2, ((a * x - 5 * a) * x + 8 * a) * x - 4 * a, 0.0))


def _resize_weights(n_in, n_out, kind, device):
    """[n_out, n_in] weights of ``jax.image.resize`` along one axis
    (``compute_weight_mat`` with antialiasing)."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64, device=device)
              + 0.5) * inv - 0.5
    x = (sample[:, None] - torch.arange(
        n_in, dtype=torch.float64, device=device)[None, :]).abs() / kscale
    w = torch.clamp(1.0 - x, min=0.0) if kind == "linear" else _cubic(x)
    total = w.sum(1, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    valid = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(valid[:, None], w, 0.0)


@register_op("interpolate")
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    n, c, h, w = x.shape
    if size is None:
        sf = _tuple(scale_factor)
        size = (int(h * sf[0]), int(w * sf[1]))
    oh, ow = _tuple(size)
    if mode == "nearest":
        ih = torch.clamp(((torch.arange(oh, device=x.device) + 0.5)
                          * (h / oh)).floor().long(), max=h - 1)
        iw = torch.clamp(((torch.arange(ow, device=x.device) + 0.5)
                          * (w / ow)).floor().long(), max=w - 1)
        return x[:, :, ih][:, :, :, iw]
    kind = {"bilinear": "linear", "linear": "linear", "area": "linear",
            "bicubic": "cubic"}[mode]
    wh = _resize_weights(h, oh, kind, x.device)
    ww = _resize_weights(w, ow, kind, x.device)
    ct = torch.float32 if x.dtype != torch.float64 else torch.float64
    out = torch.einsum("oh,nchw,pw->ncop", wh.to(ct), x.to(ct), ww.to(ct))
    return out.to(x.dtype)


@register_op("pixel_shuffle")
def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = upscale_factor
    n, c, h, w = x.shape
    out = x.reshape(n, c // (r * r), r, r, h, w)
    out = out.permute(0, 1, 4, 2, 5, 3)
    return out.reshape(n, c // (r * r), h * r, w * r)


@register_op("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    return F.unfold(x, _tuple(kernel_sizes), dilation=_tuple(dilations),
                    padding=_tuple(paddings), stride=_tuple(strides))
