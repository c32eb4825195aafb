"""TCPStore — the rendezvous key-value store (the port of
``paddle_tpu/distributed/store.py``).

The JAX package's class is a ctypes client of its own C++ server; the
port keeps the class, its methods and their semantics and puts them on
``torch.distributed.TCPStore``:

- ``set``, ``get(blocking=, timeout=)``, ``add``, ``wait``,
  ``delete_key``, ``set_if_absent`` and the counter ``barrier``;
- ``fadd`` (an atomic fp32-vector add into an existing row), ``mget``,
  ``mfadd`` and ``msetnx``, on ``compare_set``, ``multi_get`` and
  ``multi_set`` where torch has no single call (``fadd`` and ``mfadd``
  read and write their rows under the store's row lock, taken by
  ``compare_set``, as the JAX server adds under its mutex; refused
  attempts count in ``cas_retries``).  The lock is a lease: its value
  holds the time it was taken, and a waiter takes over a lock older
  than ``lock_lease_s`` (its holder died holding it: a client killed
  by a signal runs no ``finally``).  A waiter gives up with
  ``TimeoutError`` after the store's ``timeout``.  ``mget_or_create``
  reads rows creating the missing ones in one ``compare_set`` each.

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
import time

import numpy as np

from ..resilience.retry import Deadline, backoff_delays

__all__ = ["TCPStore"]


#: the key whose holder may read and write fp32 rows (``fadd``/``mfadd``)
_ROW_LOCK = "#row_lock"


def _bytes(value):
    return value.encode() if isinstance(value, str) else bytes(value)


class TCPStore:
    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=30.0, lock_lease_s=10.0):
        import torch.distributed as dist

        self.world_size = world_size
        self.timeout = timeout
        self.lock_lease_s = float(lock_lease_s)
        self.cas_retries = 0     # refused row-lock attempts
        self.lock_takeovers = 0  # row locks taken from a dead holder
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
        status, rows = self._locked_adds([key], arr[None])
        if status[0] == 1:
            raise KeyError(key)
        if status[0] == 3:
            raise RuntimeError(f"TCPStore.fadd({key!r}) failed: row "
                               f"dimension mismatch")
        return rows[key]

    def _locked_adds(self, keys, rows):
        """Add ``rows[i]`` into ``keys[i]`` (a key may repeat: its rows
        land in order) under the store's row lock — a ``compare_set`` of
        one lock key from empty to this call's unique token, as the JAX
        server adds under its store mutex — then one batched read and
        one batched write.  A compare-and-set of the row itself cannot
        tell its own write from a racing writer's identical bytes (two
        equal deltas onto one row).  Each refused lock attempt counts in
        ``cas_retries``.  Returns (per key 0 ok, 1 missing, 3 dimension
        mismatch; ``{key: row after}``)."""
        uniq = list(dict.fromkeys(keys))
        token = self._take_row_lock()
        try:
            old = dict(zip(uniq, self.mget(uniq)))
            cur, bad = {}, set()
            for k, r in zip(keys, rows):
                if old[k] is None:
                    continue
                base = cur.get(k)
                if base is None:
                    base = np.frombuffer(old[k], np.float32)
                if base.nbytes != r.nbytes:
                    bad.add(k)
                    continue
                cur[k] = (base + r).astype(np.float32)
            upd = [k for k in uniq if k in cur and k not in bad]
            if upd:
                self._client.multi_set(upd, [cur[k].tobytes() for k in upd])
        finally:
            # released only if still ours (a takeover moved it on)
            self._client.compare_set(_ROW_LOCK, token, b"")
        status = [1 if old[k] is None else 3 if k in bad else 0
                  for k in keys]
        return status, cur

    def _take_row_lock(self):
        """Take the row lock: its value becomes this call's token, the
        wall time it was taken and a unique id.  A lock held longer than
        ``lock_lease_s`` is taken over by ``compare_set`` against its
        holder's token; ``TimeoutError`` after the store's ``timeout``."""
        import uuid

        dl = Deadline(self.timeout)
        delays = backoff_delays(base=0.0002, cap=0.01)
        held = b""
        while True:
            token = b"%.6f:%s" % (time.time(), uuid.uuid4().hex.encode())
            got = bytes(self._client.compare_set(_ROW_LOCK, held, token))
            if got == token:
                if held:
                    self.lock_takeovers += 1
                return token
            self.cas_retries += 1
            # ``got`` is the holder's token (or b"": released), or our
            # ``held`` back when the key is gone
            prev, held = held, b""
            if got and got != prev:
                try:
                    stamp = float(got.split(b":", 1)[0])
                except ValueError:
                    stamp = None
                if stamp is not None and \
                        time.time() - stamp > self.lock_lease_s:
                    held = got
            if dl.expired():
                raise TimeoutError(
                    f"TCPStore: row lock not taken within "
                    f"{self.timeout}s (held by {got!r})")
            dl.sleep(next(delays))

    def mget_or_create(self, keys, rows):
        """Every key's value, creating the missing ones from ``rows``
        (fp32, one a key) first: one batched read when every key exists,
        else one ``compare_set`` a key (create-if-absent returns the
        value that won, existing or new)."""
        if not keys:
            return []
        keys = list(keys)
        if self._client.check(keys):
            return [bytes(v) for v in self._client.multi_get(keys)]
        rows = np.ascontiguousarray(rows, dtype=np.float32).reshape(
            len(keys), -1)
        return [bytes(self._client.compare_set(k, b"", r.tobytes()))
                for k, r in zip(keys, rows)]

    def mget(self, keys, value_size_hint=64):
        """Batched get: bytes or None (missing) for each key — one
        existence check and one ``multi_get`` when every key exists."""
        if not keys:
            return []
        if self._client.check(list(keys)):
            return [bytes(v) for v in self._client.multi_get(list(keys))]
        present = [k for k in keys if self._exists(k)]
        got = dict(zip(present, self._client.multi_get(present))) \
            if present else {}
        return [bytes(got[k]) if k in got else None for k in keys]

    def mfadd(self, keys, rows):
        """Batched fp32 accumulate into EXISTING rows; per row 0 ok, 1
        missing, 3 dimension mismatch (rows locked, read in one batch and
        written in one batch)."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if not keys:
            return []
        return self._locked_adds(list(keys), rows.reshape(len(keys), -1))[0]

    def msetnx(self, keys, rows):
        """Batched create-if-absent of fp32 rows; per row 0 created, 1
        already existed (one compare-and-set a row: racing creators
        write the same bytes by contract)."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if not keys:
            return []
        out = []
        for k, r in zip(keys, rows.reshape(len(keys), -1)):
            v = r.tobytes()
            out.append(0 if bytes(self._client.compare_set(k, b"", v)) == v
                       else 1)
        return out

    def close(self):
        """Drop this client (and, on the master, stop serving)."""
        self._client = self._master = None

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

