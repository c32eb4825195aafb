"""Atomic file writes — the port's tmp + rename commit primitive (a copy of
``paddle_tpu/resilience/atomic.py``).

Every durable artifact (checkpoint shards and manifests, ``hapi``
``Model.save`` blobs, ``jit.save`` bundles) goes through
:func:`atomic_write`: the bytes land in a ``<name>.tmp.<pid>`` sibling
and ``os.replace`` publishes them, so a crash at any byte offset leaves
the old complete file or none, never a torn one.

The writer keeps a running CRC32 of what it writes (``.crc32``), so a
checkpoint shard gets the checksum of the exact bytes on disk with no
second read pass.  Each write passes through a named fault site
(default ``io.write``) before the rename: the injection point for torn
writes, transient I/O errors and a kill during the write.
"""
from __future__ import annotations

import contextlib
import os
import zlib

from .faults import fault_point

__all__ = ["atomic_write", "CRC32Writer"]


class CRC32Writer:
    """File-object proxy keeping a running CRC32 of everything written."""

    def __init__(self, f):
        self._f = f
        self.crc32 = 0

    def write(self, data):
        b = data.encode() if isinstance(data, str) else data
        self.crc32 = zlib.crc32(b, self.crc32)
        return self._f.write(data)

    def __getattr__(self, name):
        return getattr(self._f, name)


@contextlib.contextmanager
def atomic_write(path, mode="wb", site="io.write", fsync=False):
    """Yield a :class:`CRC32Writer` for ``path`` that commits by tmp +
    ``os.replace``.  On any exception the target is untouched; the tmp
    file is left behind only for a simulated crash (a real one cannot
    clean up either) and removed for ordinary errors, so a retry starts
    clean."""
    if mode not in ("w", "wb"):
        raise ValueError(f"atomic_write only writes ({mode!r}); append "
                         "can't be made atomic by rename")
    path = os.fspath(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    f = open(tmp, mode)
    writer = CRC32Writer(f)
    try:
        yield writer
        f.flush()
        if fsync:
            os.fsync(f.fileno())
        f.close()
        # a torn write truncates tmp (then crashes); an io_error fires
        # before the rename, so the target stays intact
        fault_point(site, path=tmp)
        os.replace(tmp, path)
    except BaseException as e:
        if not f.closed:
            f.close()
        if isinstance(e, Exception):
            with contextlib.suppress(OSError):
                os.remove(tmp)
        raise
