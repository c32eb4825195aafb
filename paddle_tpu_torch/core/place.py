"""Device placement (the port of ``paddle_tpu/core/place.py``).

``set_device("gpu" | "gpu:N" | "cpu")`` picks the device that layers
create their parameters on and that ``hapi.Model`` and ``io.DataLoader``
move batches to.  Until a thread calls it, the place is ``cuda:0``, which
raises without CUDA (``resolve_device``): nothing falls back to the CPU
on its own.  The place is thread-local, as in the JAX package.

``Place`` and its constructors (``CPUPlace``, ``CUDAPlace``,
``TPUPlace``, ``CustomPlace``) are the JAX package's value type; a place
names a torch device (``torch_device()``).  There is no TPU here:
``is_compiled_with_tpu()`` is False and a ``TPUPlace`` raises when it is
used."""
from __future__ import annotations

import threading

import torch

from .._device import resolve_device

__all__ = ["set_device", "get_device", "current_device", "Place",
           "CPUPlace", "CUDAPlace", "TPUPlace", "CustomPlace",
           "device_count", "is_compiled_with_tpu", "get_all_devices",
           "AllocationType"]


class AllocationType:
    """Paddle's allocation kinds (the JAX package's numbering)."""
    UNDEFINED = 0
    CPU = 1
    GPU = 2
    TPU = 9
    CUSTOM = 10


class Place:
    """A named device slot: ``Place("gpu", 0)``."""

    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type: str = "cpu", device_id: int = 0):
        self.device_type = device_type
        self.device_id = int(device_id)

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def is_cpu_place(self):
        return self.device_type == "cpu"

    def is_tpu_place(self):
        return self.device_type == "tpu"

    def is_gpu_place(self):
        return self.device_type in ("gpu", "cuda")

    def torch_device(self) -> torch.device:
        """The torch device of this place (checked: a missing CUDA or a
        TPU raises)."""
        if self.is_cpu_place():
            return torch.device("cpu")
        if self.is_gpu_place():
            return resolve_device(f"cuda:{self.device_id}")
        raise RuntimeError(f"no {self.device_type} device in the port "
                           f"(places: cpu, gpu)")


def CPUPlace(device_id: int = 0) -> Place:
    return Place("cpu", device_id)


def CUDAPlace(device_id: int = 0) -> Place:
    return Place("gpu", device_id)


def TPUPlace(device_id: int = 0) -> Place:
    return Place("tpu", device_id)


def CustomPlace(device_type: str, device_id: int = 0) -> Place:
    return Place(device_type, device_id)


def device_count(device_type: str = "gpu") -> int:
    if device_type in ("gpu", "cuda"):
        return torch.cuda.device_count()
    return 1 if device_type == "cpu" else 0


def is_compiled_with_tpu() -> bool:
    return False


def get_all_devices():
    """``"gpu:i"`` for each CUDA device, else ``["cpu:0"]`` (the JAX
    package lists its default backend's devices the same way)."""
    n = torch.cuda.device_count()
    return [f"gpu:{i}" for i in range(n)] if n else ["cpu:0"]



class _DeviceState(threading.local):
    # thread-local by design (set_device scopes per thread)
    def __init__(self):
        self.device = None


_state = _DeviceState()


def set_device(device) -> torch.device:
    """``"gpu"``, ``"gpu:1"``, ``"cuda:0"``, ``"cpu"`` or a
    ``torch.device`` or a ``Place``; checked now, so a missing CUDA raises
    here."""
    if isinstance(device, Place):
        device = device.torch_device()
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
