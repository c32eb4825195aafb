"""The op corpus of the port (the counterpart of the JAX package's
``ops/``): ``creation``, ``math``, ``manipulation``, ``reduction``,
``linalg``, ``activation``, ``search`` (with beam search), ``random_ops``,
``nn_ops`` (convolution, pooling, normalisation, dropout, embedding,
resizing), ``loss``, ``attention`` (``scaled_dot_product_attention`` over
the flash kernels, and the naive route) and ``sequence``.  Every op is an
eager torch function registered through ``core.dispatch.register_op``,
which applies the port's autocast and the debug flags; ``list_ops()``
lists them all."""
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .activation import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .random_ops import *  # noqa: F401,F403
from .nn_ops import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .attention import scaled_dot_product_attention  # noqa: F401
from .sequence import *  # noqa: F401,F403
from . import linalg  # noqa: F401,E402

from ..core.dispatch import OP_REGISTRY, get_op, list_ops  # noqa: F401
