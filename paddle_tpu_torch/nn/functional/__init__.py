"""nn.functional — the port's op corpus under Paddle's functional
namespace (the counterpart of ``paddle_tpu/nn/functional``)."""
from ...ops.activation import *  # noqa: F401,F403
from ...ops.loss import *  # noqa: F401,F403
from ...ops.nn_ops import *  # noqa: F401,F403
from ...ops.attention import *  # noqa: F401,F403
from ...ops.manipulation import one_hot, pad  # noqa: F401
from ...ops.linalg import matmul  # noqa: F401
from ...ops.activation import sigmoid  # noqa: F401

from ...ops.nn_ops import embedding as embedding  # noqa: F401
