"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA.

    There is no silent CPU fallback: without a usable CUDA device a
    ``None`` or CUDA request raises, and the caller who wants the CPU
    (the CPU tests, a laptop) says so with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device=\"cpu\" to run the port "
            "on the CPU (its kernels then use their plain PyTorch "
            "versions)")
    return dev
