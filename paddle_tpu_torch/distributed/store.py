"""TCPStore — the rendezvous key-value store (the port of
``paddle_tpu/distributed/store.py``).

The JAX package's class is a ctypes client of its own C++ server; the
port keeps the class, its methods and their semantics and puts them on
``torch.distributed.TCPStore``:

- ``set``, ``get(blocking=, timeout=)``, ``add``, ``wait``,
  ``delete_key``, ``set_if_absent`` and the counter ``barrier``;
- ``fadd`` (an atomic fp32-vector add into an existing row), ``mget``,
  ``mfadd`` and ``msetnx``, on ``compare_set`` and ``multi_get`` where
  torch has no single call (``fadd`` is a compare-and-set loop).

A blocking ``get`` polls with backoff on the client, as the JAX client
does, so one slow key never holds the connection for other users of the
same object.  Connecting retries with jittered backoff inside the
timeout (``retry_attempts_total{name="TCPStore.connect"}``): a worker
may dial before the master has bound its port.  ``CommitBarrier``
(``distributed.checkpoint``) and the integrity sentinel's cross-rank
compare run over it.
"""
from __future__ import annotations

import datetime

import numpy as np

from ..resilience.retry import Deadline, backoff_delays

__all__ = ["TCPStore"]


def _bytes(value):
    return value.encode() if isinstance(value, str) else bytes(value)


class TCPStore:
    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=30.0):
        import torch.distributed as dist

        self.world_size = world_size
        self.timeout = timeout
        self._master = None
        if is_master:
            try:
                self._master = dist.TCPStore(
                    host, int(port), None, True,
                    timeout=datetime.timedelta(seconds=float(timeout)),
                    wait_for_workers=False)
            except (RuntimeError, OSError) as e:
                raise RuntimeError(
                    f"TCPStore master failed to bind :{port}: {e}") from e
            port = self._master.port
        self.host, self.port = host, int(port)
        self._client = self._master or self._connect(host, self.port,
                                                     float(timeout))
        if self._client is None:
            raise TimeoutError(f"TCPStore could not reach {host}:{self.port} "
                               f"within {timeout}s")

    def _connect(self, host, port, timeout):
        """Retry connect with jittered backoff until ``timeout`` expires:
        a refused connection is the expected first outcome when workers
        dial before the master binds."""
        import torch.distributed as dist

        from ..observability.metrics import default_registry

        dl = Deadline(timeout)
        delays = backoff_delays(base=0.02, cap=1.0)
        while True:
            attempt = min(2.0, max(0.05, dl.remaining()))
            try:
                return dist.TCPStore(
                    host, port, None, False,
                    timeout=datetime.timedelta(seconds=attempt))
            except (RuntimeError, OSError):
                default_registry().counter(
                    "retry_attempts_total",
                    help="failed attempts retried with backoff",
                    labelnames=("name",)).labels(
                        name="TCPStore.connect").inc()
            if dl.expired():
                return None
            dl.sleep(next(delays))

    # ------------------------------------------------------------------ kv
    def set(self, key: str, value):
        self._client.set(key, _bytes(value))

    def _exists(self, key):
        return self._client.check([key])

    def get(self, key: str, blocking=True, timeout=None) -> bytes:
        """The value of ``key``.  Blocking polls (1 ms → 100 ms backoff,
        jittered) under ``timeout`` (None: the store's budget; <= 0: one
        attempt), then raises ``TimeoutError``; non-blocking raises
        ``KeyError`` for a missing key."""
        budget = self.timeout if timeout is None else float(timeout)
        dl = Deadline(max(0.0, budget))
        delays = backoff_delays(base=0.001, cap=0.1)
        while True:
            if self._exists(key):
                return bytes(self._client.get(key))
            if not blocking:
                raise KeyError(key)
            if dl.expired():
                raise TimeoutError(
                    f"TCPStore.get({key!r}) timed out after {budget}s")
            dl.sleep(next(delays))

    def add(self, key: str, delta: int = 1) -> int:
        """Atomic integer add; ``TypeError`` if the key holds a value that
        is not a counter (torch's server would drop the connection)."""
        if self._exists(key):
            try:
                int(bytes(self._client.get(key)))
            except ValueError:
                raise TypeError(f"TCPStore.add({key!r}): key holds a "
                                f"non-counter value") from None
        return int(self._client.add(key, int(delta)))

    def wait(self, keys, timeout=None):
        """Block until every key exists, under ONE shared budget."""
        dl = Deadline(self.timeout if timeout is None else float(timeout))
        for k in (keys if isinstance(keys, (list, tuple)) else [keys]):
            self.get(k, blocking=True, timeout=dl.remaining())

    def delete_key(self, key: str):
        self._client.delete_key(key)

    def set_if_absent(self, key: str, value) -> bool:
        """Create ``key=value`` unless the key exists; True if this call
        wrote it (racing creators write the same bytes by contract)."""
        value = _bytes(value)
        if self._exists(key):
            return False
        return bytes(self._client.compare_set(key, b"", value)) == value

    def fadd(self, key: str, delta):
        """Atomic fp32-vector accumulate into an EXISTING row; returns the
        row after the add.  ``KeyError`` if the row was never created
        (creation is ``set_if_absent``)."""
        arr = np.ascontiguousarray(delta, dtype=np.float32).ravel()
        while True:
            if not self._exists(key):
                raise KeyError(key)
            old = bytes(self._client.get(key))
            if len(old) != arr.nbytes:
                raise RuntimeError(f"TCPStore.fadd({key!r}) failed: row "
                                   f"dimension mismatch")
            new = (np.frombuffer(old, np.float32) + arr).astype(np.float32)
            got = bytes(self._client.compare_set(key, old, new.tobytes()))
            if got == new.tobytes():
                return new

    def mget(self, keys, value_size_hint=64):
        """Batched get: bytes or None (missing) for each key."""
        if not keys:
            return []
        present = [k for k in keys if self._exists(k)]
        got = dict(zip(present, self._client.multi_get(present))) \
            if present else {}
        return [bytes(got[k]) if k in got else None for k in keys]

    def mfadd(self, keys, rows):
        """Batched fp32 accumulate into EXISTING rows; per row 0 ok, 1
        missing, 3 dimension mismatch."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        out = []
        for k, r in zip(keys, rows.reshape(len(keys), -1) if keys else []):
            try:
                self.fadd(k, r)
                out.append(0)
            except KeyError:
                out.append(1)
            except RuntimeError:
                out.append(3)
        return out

    def msetnx(self, keys, rows):
        """Batched create-if-absent of fp32 rows; per row 0 created, 1
        already existed."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        return [0 if self.set_if_absent(k, r.tobytes()) else 1
                for k, r in zip(keys, rows.reshape(len(keys), -1)
                                if keys else [])]

    # -------------------------------------------------------------- barrier
    def barrier(self, name="_barrier", timeout=None):
        """Counter barrier over ``world_size`` participants, reusable in
        generations; the ack poll is Deadline-bounded."""
        budget = self.timeout if timeout is None else float(timeout)
        n = self.add(f"{name}/count", 1)
        target = ((n - 1) // self.world_size + 1) * self.world_size
        dl = Deadline(max(0.0, budget))
        delays = backoff_delays(base=0.001, cap=0.05)
        cur = n
        while True:
            cur = self.add(f"{name}/count", 0)
            if cur >= target:
                return
            if dl.expired():
                raise TimeoutError(f"barrier {name!r} timed out "
                                   f"({cur}/{target})")
            dl.sleep(next(delays))

