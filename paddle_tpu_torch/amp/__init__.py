"""AMP (the port of ``paddle_tpu/amp``): ``auto_cast`` with the JAX
package's O1 lists, ``decorate`` (O2) and ``GradScaler``."""
from .auto_cast import amp_guard, auto_cast, decorate, white_list  # noqa: F401
from .grad_scaler import GradScaler  # noqa: F401
