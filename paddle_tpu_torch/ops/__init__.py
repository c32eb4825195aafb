"""Functional ops of the port (the counterparts of the JAX package's
``ops/``): ``nn_ops.py`` (convolution, pooling, normalisation, dropout),
``loss.py``, ``activation.py``, ``linalg.py`` (``matmul``) and
``attention.py`` (``scaled_dot_product_attention`` over the flash kernels,
and the naive route).  Each op applies the port's autocast on entry
(``amp.auto_cast.amp_op``)."""
from .activation import *  # noqa: F401,F403
from .attention import scaled_dot_product_attention  # noqa: F401
from .linalg import matmul  # noqa: F401
from .loss import *  # noqa: F401,F403
from .nn_ops import *  # noqa: F401,F403
