"""Optimizers, LR schedulers and gradient clips (the port of
``paddle_tpu/optimizer``)."""
from . import lr  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .optimizer import Optimizer  # noqa: F401
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                         AdamW, Lamb, Momentum, RMSProp)
