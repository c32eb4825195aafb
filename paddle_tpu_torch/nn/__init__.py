"""The port's ``nn`` (the counterpart of ``paddle_tpu/nn``): ``Layer`` and
the layers ResNet and the Transformer use, ``functional`` and
``initializer``."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer import *  # noqa: F401,F403
from .layer.layers import Layer, Parameter  # noqa: F401


class ParamAttr:
    """Parameter attribute bundle (parity: paddle.ParamAttr)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip
