"""Atomic file writes (the port of the part of
``paddle_tpu/resilience/atomic.py`` that ``hapi.Model.save`` uses): the
bytes land in a ``<name>.tmp.<pid>`` sibling and ``os.replace`` publishes
them, so a crash leaves the old complete file or none, never a torn one.
The JAX helper's running CRC and fault site are not ported."""
from __future__ import annotations

import contextlib
import os

__all__ = ["atomic_write"]


@contextlib.contextmanager
def atomic_write(path, mode="wb"):
    """Yield a file for ``path`` that commits by tmp + ``os.replace``; on
    an exception the target is untouched and the tmp file removed."""
    if mode not in ("w", "wb"):
        raise ValueError(f"atomic_write only writes ({mode!r})")
    path = os.fspath(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    f = open(tmp, mode)
    try:
        yield f
        f.close()
        os.replace(tmp, path)
    except BaseException:
        f.close()
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
