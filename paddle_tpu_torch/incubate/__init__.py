"""incubate — extension surfaces (the port of ``paddle_tpu/incubate``;
parity: python/paddle/incubate/): the custom-op API (``custom_op``) and
the fused transformer layers (``incubate.nn``)."""
from . import custom_op
from .custom_op import CustomOpBuilder, custom_op as build_op

__all__ = ["custom_op", "CustomOpBuilder", "build_op"]

from . import nn  # noqa: F401,E402
