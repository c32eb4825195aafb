"""Quantization (the port of ``paddle_tpu/contrib/quant.py``; parity:
python/paddle/fluid/contrib/slim/quantization — QAT fake-quant insertion
and PTQ scale collection).

``fake_quant`` is a straight-through ``torch.autograd.Function`` (the JAX
package's ``custom_vjp``); QAT swaps every Linear for a
``QuantizedLinear`` sharing its parameters; PTQ observes each Linear's
input abs-max through forward post hooks.  int8 inference itself is the
``inference`` predictor's (``Config.enable_int8``)."""
from __future__ import annotations

import torch

from .. import ops
from ..core.dispatch import register_op
from ..nn.layer.common import Linear
from ..nn.layer.layers import Layer

__all__ = ["fake_quant", "QuantizedLinear", "QAT", "PTQ", "quant_scales"]


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bits):
        qmax = 2.0 ** (bits - 1) - 1
        s = torch.clamp_min(scale, 1e-8)
        ctx.save_for_backward(x, s)
        q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
        return q * s / qmax

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        inside = (x.abs() <= s).to(g.dtype)    # STE inside the range
        return g * inside, torch.zeros_like(s), None


@register_op("fake_quant")
def fake_quant(x, scale, bits=8):
    """Symmetric fake quantization with a straight-through gradient
    (reference: fake_quantize_dequantize_moving_average_abs_max)."""
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor(scale, dtype=torch.float32, device=x.device)
    return _FakeQuant.apply(x, scale, bits)


def _absmax(x):
    return float(x.detach().abs().max())


class _AbsMax:
    """Running abs-max over ALL observed batches (PTQ calibration —
    outliers in any batch must widen the range)."""

    def __init__(self):
        self.scale = None

    def update(self, x):
        cur = _absmax(x)
        self.scale = cur if self.scale is None else max(self.scale, cur)
        return self.scale


class _MovingAbsMax:
    """abs-max scale tracker (moving_average_abs_max semantics)."""

    def __init__(self, momentum=0.9):
        self.momentum = momentum
        self.scale = None

    def update(self, x):
        cur = _absmax(x)
        if self.scale is None:
            self.scale = cur
        else:
            self.scale = self.momentum * self.scale \
                + (1 - self.momentum) * cur
        return self.scale


class QuantizedLinear(Layer):
    """Linear with fake-quantized weights and activations (QAT module),
    sharing the wrapped Linear's parameters.  The weight scale starts
    from the wrapped weight; the activation scale needs one batch run
    eagerly (a trace cannot observe values): running traced before that
    raises instead of quantizing with a wrong range."""

    def __init__(self, linear, weight_bits=8, activation_bits=8,
                 momentum=0.9):
        super().__init__()
        self.inner = linear
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self._w_scale = _MovingAbsMax(momentum)
        self._a_scale = _MovingAbsMax(momentum)
        self._w_scale.update(linear.weight)
        self.freeze_scales = False   # set by PTQ.convert

    def forward(self, x):
        w = self.inner.weight
        if not self.freeze_scales and not torch.compiler.is_compiling():
            self._a_scale.update(x)
            self._w_scale.update(w)
        if self._a_scale.scale is None:
            raise RuntimeError(
                "QuantizedLinear has no activation scale yet: run at "
                "least one batch eagerly to calibrate, or set "
                "._a_scale.scale explicitly — a trace cannot observe "
                "values")
        xq = fake_quant(x, self._a_scale.scale, self.activation_bits)
        wq = fake_quant(w, self._w_scale.scale, self.weight_bits)
        out = ops.matmul(xq, wq)
        if self.inner.bias is not None:
            out = out + self.inner.bias
        return out

    def scales(self):
        return {"weight": self._w_scale.scale,
                "activation": self._a_scale.scale}


class QAT:
    """Quantization-aware training transform (reference:
    paddle.quantization QAT / ImperativeQuantAware.quantize): swaps every
    Linear in a model for a QuantizedLinear sharing its params."""

    def __init__(self, weight_bits=8, activation_bits=8):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits

    def quantize(self, model):
        def swap(layer):
            for name, sub in list(layer.named_children()):
                if isinstance(sub, Linear):
                    setattr(layer, name, QuantizedLinear(
                        sub, self.weight_bits, self.activation_bits))
                else:
                    swap(sub)

        swap(model)
        return model


class PTQ:
    """Post-training quantization: run calibration batches, collect
    abs-max activation scales per observed Linear (reference PTQ
    calibrate + convert).  The hooks stay on the model: calibrate a copy
    of the model that serves."""

    def __init__(self, bits=8):
        self.bits = bits
        self._observers = {}

    def quantize(self, model):
        def hook_for(name):
            def hook(layer, inputs, output):
                self._observers.setdefault(name, _AbsMax()).update(
                    inputs[0])

            return hook

        # include_self: a bare-Linear model observes under the empty
        # prefix, matching the int8 predictor's root key
        for name, sub in model.named_sublayers(include_self=True):
            if isinstance(sub, Linear):
                sub.register_forward_post_hook(hook_for(name))
        return model

    def scales(self):
        return {k: o.scale for k, o in self._observers.items()}

    def convert(self, model):
        """Swap calibrated Linears for QuantizedLinears with the
        collected scales frozen in."""
        def swap(layer, prefix=""):
            for name, sub in list(layer.named_children()):
                full = f"{prefix}.{name}" if prefix else name
                if isinstance(sub, Linear):
                    q = QuantizedLinear(sub, self.bits, self.bits)
                    if full in self._observers:
                        q._a_scale.scale = self._observers[full].scale
                        q.freeze_scales = True   # calibrated: no drift
                    # a Linear never exercised during calibration keeps a
                    # live (unfrozen) observer so its first eager batch
                    # can still set a scale
                    setattr(layer, name, q)
                else:
                    swap(sub, full)

        swap(model)
        return model


def quant_scales(model):
    """Collect scales from every QuantizedLinear in a model."""
    return {name: sub.scales() for name, sub in model.named_sublayers()
            if isinstance(sub, QuantizedLinear)}
