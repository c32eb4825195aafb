"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch

# set in a forked worker process, which must never touch CUDA
IN_FORKED_WORKER = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA.

    There is no silent CPU fallback: without a usable CUDA device a
    ``None`` or CUDA request raises, and the caller who wants the CPU
    (the CPU tests, a laptop) says so with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and IN_FORKED_WORKER:
        raise RuntimeError(
            "CUDA use inside a forked worker process: it inherits a copy "
            "of the parent's CUDA context that it cannot use. Build "
            "samples with numpy or CPU tensors; the parent moves them to "
            "the device")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device=\"cpu\" to run the port "
            "on the CPU (its kernels then use their plain PyTorch "
            "versions)")
    return dev
