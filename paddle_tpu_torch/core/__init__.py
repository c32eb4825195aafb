"""The core of the eager API (the port of ``paddle_tpu/core``): dtypes,
places, random state, flags, the error taxonomy (``enforce``), the op
registry (``dispatch``) and the tensor (``tensor``: ``Tensor`` is
``torch.Tensor``).  torch's autograd takes the role of the JAX package's
tape (``core/autograd.py``), and shard_map's varying axes
(``core/vma.py``) have no torch counterpart."""
from . import dtype, enforce, flags, place, random  # noqa: F401
from .dtype import (convert_dtype, get_default_dtype,  # noqa: F401
                    set_default_dtype)
from .flags import get_flags, set_flags  # noqa: F401
from .place import (CPUPlace, CUDAPlace, CustomPlace, Place,  # noqa: F401
                    TPUPlace, current_device, device_count, get_device,
                    is_compiled_with_tpu,
                    set_device)
from .random import get_rng_state, seed, set_rng_state  # noqa: F401
from . import dispatch, tensor  # noqa: F401,E402
from .dispatch import OP_REGISTRY, get_op, list_ops, register_op  # noqa
from .tensor import Parameter, Tensor, is_tensor, to_tensor  # noqa: F401
