"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` has a plain C interface (no PyTorch headers),
so ``nvcc`` builds it in seconds into a shared library that ``ctypes``
loads; the wrappers pass device pointers, sizes and the current stream
as Python ints.  Libraries are built at first use into ``build/`` next
to this file (listed in ``.gitignore``), named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  ``build_all`` starts one ``nvcc`` per source at once.

Nothing here runs at import time: the CPU tests import every module of
the port on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["SOURCES", "BUILD_DIR", "load", "build_all", "build_logs"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "build")

#: kernel name -> source path relative to this package directory
SOURCES = {
    "ragged_paged_attention": os.path.join("csrc",
                                           "ragged_paged_attention.cu"),
    "flash_attention": os.path.join("csrc", "flash_attention.cu"),
    "flash_fwd_sm90": os.path.join("csrc", "flash_fwd_sm90.cu"),
}

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}          # name -> ctypes.CDLL; guarded-by: _lock
_logs = {}          # name -> nvcc's stderr (ptxas register/smem report)


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)"
                       " — the port's CUDA kernels are built at first use")


def _target(name):
    src = os.path.join(_HERE, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, tmp path, final path)."""
    src, so = _target(name)
    if os.path.exists(so):
        return None, None, so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, so


def _finish(name, proc, tmp, so):
    if proc is not None:
        out, err = proc.communicate()
        _logs[name] = (out or "") + (err or "")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                               f"(exit {proc.returncode}):\n{_logs[name]}")
        os.replace(tmp, so)
    _libs[name] = ctypes.CDLL(so)
    return _libs[name]


def load(name):
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _finish(name, *_start(name))
        return lib


def build_all():
    """Build every kernel of the port in parallel (one nvcc per source,
    all started together) and load them.  Returns {name: CDLL}."""
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        started = [(n, _start(n)) for n in todo]
        errors = []
        for n, job in started:        # reap every nvcc, even after a failure
            try:
                _finish(n, *job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return dict(_libs)


def build_logs():
    """{name: nvcc output} for the kernels this process compiled — the
    ptxas report of registers, shared memory and spills."""
    return dict(_logs)
