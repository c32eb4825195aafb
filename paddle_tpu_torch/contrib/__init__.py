"""contrib — quantization (slim) and structured sparsity (ASP) (the port
of ``paddle_tpu/contrib``; parity: python/paddle/fluid/contrib/{slim,
sparsity})."""
from . import quant, sparsity
from .quant import PTQ, QAT, QuantizedLinear, fake_quant, quant_scales
from .sparsity import (ASPHelper, check_mask, create_mask, decorate,
                       prune_model)

__all__ = ["quant", "sparsity", "QAT", "PTQ", "QuantizedLinear",
           "fake_quant", "quant_scales", "ASPHelper", "create_mask",
           "check_mask", "prune_model", "decorate"]
