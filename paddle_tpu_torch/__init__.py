"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``models/gpt.py``, ``kernels/``, ``ops/``, ``distributed/`` for
one-GPU training, ``serving/`` with the fleet, ``observability/``,
``resilience/``, ``profiler/``, and the eager API: ``core/``, ``nn/``,
``amp/``, ``optimizer/``, ``io/``, ``metric/``, ``hapi/``, ``vision/``, and
the deployment path: ``autograd/``, ``jit/``, ``static/``, ``contrib/``
(quantization) and ``inference/``) so each module has an obvious
counterpart.  The top level exports what the JAX package's does for
every module the port has — ``Tensor`` (which is ``torch.Tensor``),
``Parameter``, ``to_tensor``/``tensor``, the places, the dtypes, the
flags and the whole op corpus (``from .ops import *``) — so ``import
paddle_tpu_torch as paddle`` runs Paddle-style code.  Paddle's Tensor
methods that torch lacks are added to ``torch.Tensor`` (never over a
name torch has: ``core/tensor.py``).  It imports ``torch`` and numpy
only — never ``jax`` and nothing of ``paddle_tpu`` (importing any
``paddle_tpu`` submodule runs that package's ``__init__``, which
imports jax).

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (or calls ``set_device("cpu")``); they never fall back
to the CPU on their own.  On the CPU every hand-written kernel is
replaced by its plain PyTorch version, chosen only because the tensors
it is given lie on the CPU.
"""
__version__ = "0.1.0"

from . import core  # noqa: F401  (first: the op registry loads autocast)
from .core import (CPUPlace, CUDAPlace, CustomPlace, Parameter,  # noqa
                   Place, TPUPlace, Tensor, get_device,
                   is_compiled_with_tpu, is_tensor, set_device, to_tensor)
from .core.dtype import (bfloat16, complex64, complex128,  # noqa: F401
                         convert_dtype, float16, float32, float64,
                         get_default_dtype, int8,
                         int16, int32, int64, set_default_dtype, uint8)
from .core.dtype import bool_ as bool8  # noqa: F401
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.random import get_rng_state, seed, set_rng_state  # noqa: F401
from .core.tensor import tensor_ctor as tensor  # noqa: F401

from . import ops  # noqa: F401,E402
from .ops import *  # noqa: F401,F403,E402

from . import (amp, autograd, contrib, inference, io, jit,  # noqa: E402
               metric, nn, optimizer, profiler, static, vision)
from ._device import resolve_device  # noqa: E402
from .autograd import enable_grad, grad, is_grad_enabled, no_grad  # noqa
from .hapi import Model  # noqa: E402
from .profiler.timer import Benchmark  # noqa: E402
from . import (distributed, hapi, observability, resilience,  # noqa: E402
               serving)

import torch as _torch  # noqa: E402

dtype = _torch.dtype
trace = ops.linalg.trace
core.tensor.patch_tensor_methods(ops)
