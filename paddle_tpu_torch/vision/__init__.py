"""Vision (the port of ``paddle_tpu/vision``): the model zoo of
``models.py``, the numpy ``transforms`` and synthetic ``datasets`` a
DataLoader's workers run, and the box and detection ops of ``ops`` and
``detection_ops``, which compute on the device of their inputs."""
from . import datasets, detection_ops, models, ops, transforms  # noqa: F401
from .models import *  # noqa: F401,F403
