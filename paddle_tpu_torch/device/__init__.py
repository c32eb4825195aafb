"""Device management (the port of ``paddle_tpu/device/__init__.py``;
parity: python/paddle/device/ set_device/get_device + the
pluggable-device C API, phi/backends/device_ext.h:48
``C_DeviceInterface`` / device_manager.h:114 ``DeviceManager``).

Pluggable devices: the reference loads vendor runtime plugins
implementing C_DeviceInterface, the JAX package a PJRT plugin.  torch's
counterpart is its one PrivateUse1 backend: a library that registers
kernels for it, loaded with ``torch.ops.load_library``, and the backend
renamed to the device's name (``torch.utils.rename_privateuse1_backend``),
after which places and ``set_device`` address it by name.  A process
has one such backend, so one custom device.
"""
from __future__ import annotations

import os

import torch

from ..core.place import (CPUPlace, CUDAPlace, CustomPlace, Place,
                          TPUPlace, device_count, get_device, set_device)

__all__ = ["set_device", "get_device", "get_all_devices", "device_count",
           "Place", "CPUPlace", "CUDAPlace", "TPUPlace", "CustomPlace",
           "register_custom_device", "get_all_custom_device_type",
           "is_custom_device_available"]

_registered: dict[str, str] = {}


def get_all_devices():
    """The devices of the default backend: every card (``gpu:N``), or
    ``cpu:0`` without one."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [f"gpu:{i}" for i in range(n)] or ["cpu:0"]


def register_custom_device(device_type: str, library_path: str):
    """Load a library implementing torch's PrivateUse1 backend and name
    that backend ``device_type``.  Once per process: torch has one
    PrivateUse1 backend, and its name cannot change after it is set."""
    if _registered and device_type not in _registered:
        raise RuntimeError(
            f"register_custom_device({device_type!r}) must come before "
            f"any other custom device: this process already named torch's "
            f"one PrivateUse1 backend {next(iter(_registered))!r}")
    if not os.path.exists(library_path):
        raise FileNotFoundError(
            f"device library for {device_type!r} not found: {library_path}")
    try:
        torch.ops.load_library(library_path)
        torch.utils.rename_privateuse1_backend(device_type)
    except Exception as e:  # the library's own failure, named
        raise RuntimeError(
            f"failed to load device library {library_path!r} for "
            f"{device_type!r}: {e}") from e
    _registered[device_type] = library_path
    return CustomPlace(device_type, 0)


def get_all_custom_device_type():
    """Registered custom device names (reference:
    device/__init__.py get_all_custom_device_type)."""
    return sorted(_registered)


def is_custom_device_available(device_type: str) -> bool:
    if device_type not in _registered:
        return False
    try:
        return torch.device(device_type).type == device_type
    except RuntimeError:
        return False
