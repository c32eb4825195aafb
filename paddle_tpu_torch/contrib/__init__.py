"""contrib — quantization (the port of ``paddle_tpu/contrib``; parity:
python/paddle/fluid/contrib/slim).  Structured sparsity
(``contrib/sparsity.py``, ASP) is not ported yet (see ROADMAP.md)."""
from . import quant
from .quant import PTQ, QAT, QuantizedLinear, fake_quant, quant_scales

__all__ = ["quant", "QAT", "PTQ", "QuantizedLinear", "fake_quant",
           "quant_scales"]
