"""Vision (the port of ``paddle_tpu/vision``): the model zoo of
``models.py``."""
from . import models  # noqa: F401
from .models import *  # noqa: F401,F403
