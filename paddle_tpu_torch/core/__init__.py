"""Dtypes, device placement and random state of the eager API (the
port of ``paddle_tpu/core``).  torch's tensor and autograd take the
roles of the JAX package's ``Tensor``, tape and op registry."""
from .dtype import (convert_dtype, get_default_dtype,  # noqa: F401
                    set_default_dtype)
from .place import current_device, get_device, set_device  # noqa: F401
from .random import get_rng_state, seed, set_rng_state  # noqa: F401
