"""nn.functional — the port's functional ops under Paddle's namespace
(the counterpart of ``paddle_tpu/nn/functional``)."""
from ...ops.activation import *  # noqa: F401,F403
from ...ops.attention import scaled_dot_product_attention  # noqa: F401
from ...ops.linalg import matmul  # noqa: F401
from ...ops.loss import *  # noqa: F401,F403
from ...ops.nn_ops import *  # noqa: F401,F403
