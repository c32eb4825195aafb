"""Device placement (the port of ``paddle_tpu/core/place.py``).

``set_device("gpu" | "gpu:N" | "cpu")`` picks the device that layers
create their parameters on and that ``hapi.Model`` and ``io.DataLoader``
move batches to.  Until a thread calls it, the place is ``cuda:0``, which
raises without CUDA (``resolve_device``): nothing falls back to the CPU
on its own.  The place is thread-local, as in the JAX package."""
from __future__ import annotations

import threading

import torch

from .._device import resolve_device

__all__ = ["set_device", "get_device", "current_device"]


class _DeviceState(threading.local):
    # thread-local by design (set_device scopes per thread)
    def __init__(self):
        self.device = None


_state = _DeviceState()


def set_device(device) -> torch.device:
    """``"gpu"``, ``"gpu:1"``, ``"cuda:0"``, ``"cpu"`` or a
    ``torch.device``; checked now, so a missing CUDA raises here."""
    if isinstance(device, str):
        kind, _, idx = device.lower().strip().partition(":")
        kind = "cuda" if kind in ("gpu", "cuda") else kind
        device = f"{kind}:{idx or 0}" if kind == "cuda" else kind
    _state.device = resolve_device(device)
    return _state.device


def current_device() -> torch.device:
    """The device of this thread: the one ``set_device`` chose, else
    ``cuda:0`` (raising without CUDA)."""
    if _state.device is None:
        return resolve_device("cuda:0")
    return _state.device


def get_device() -> str:
    dev = current_device()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"
