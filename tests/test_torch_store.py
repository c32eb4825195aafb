"""The port's ``TCPStore`` (on ``torch.distributed.TCPStore``) against the
JAX package's native one.

The same sequence of operations runs on each package's store and gives
the same results: values, counters, create-if-absent, the fp32 row adds
(``fadd``/``mfadd``/``msetnx``), batched gets and the error kinds.  Then
``tests/test_resilience.py``'s ``TestStoreBackoff`` (connect retries
until the master appears, the connect timeout, a blocking get's backoff)
and ``tests/test_commit_barrier.py``'s bounded waits (one deadline over
``wait``'s keys, a zero-timeout get, the barrier's timeout) on the port.
"""
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.store import TCPStore as JaxStore
from paddle_tpu_torch.distributed.store import TCPStore


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ops(store):
    """One sequence of store operations; every result, in order."""
    out = []

    def rec(fn, *a, **k):
        try:
            v = fn(*a, **k)
            out.append(("ok", v.tolist() if isinstance(v, np.ndarray)
                        else v))
        except (KeyError, TypeError, TimeoutError, RuntimeError) as e:
            out.append((type(e).__name__, None))

    rec(store.set, "a", b"xyz")
    rec(store.set, "s", "text")
    rec(store.get, "a")
    rec(store.get, "s")
    rec(store.get, "missing", blocking=False)
    rec(store.get, "missing", timeout=0)
    rec(store.add, "c", 1)
    rec(store.add, "c", 41)
    rec(store.add, "c", -2)
    rec(store.add, "a", 1)                     # not a counter
    rec(store.set_if_absent, "n", b"v1")
    rec(store.set_if_absent, "n", b"v2")
    rec(store.get, "n")
    rec(store.fadd, "row", np.ones(3))         # never created
    rec(store.set_if_absent, "row", np.arange(3, dtype=np.float32)
        .tobytes())
    rec(store.fadd, "row", np.full(3, 0.5))
    rec(store.fadd, "row", np.ones(4))         # dimension mismatch
    rec(store.mget, ["a", "nope", "n"])
    rec(store.mget, [])
    rec(store.msetnx, ["r1", "row"], np.ones((2, 2), np.float32))
    rec(store.mfadd, ["r1", "gone", "row"],
        np.full((3, 2), 2.0, np.float32))
    rec(store.mget, ["r1"])
    rec(store.delete_key, "a")
    rec(store.get, "a", blocking=False)
    rec(store.wait, ["n", "r1"], timeout=1)
    rec(store.barrier, "solo")
    return out


def test_operations_match_the_jax_store():
    jax_out = _ops(JaxStore(is_master=True, world_size=1))
    port_out = _ops(TCPStore(is_master=True, world_size=1))
    assert port_out == jax_out


def test_client_sees_the_master_and_counters_are_shared():
    master = TCPStore(is_master=True, world_size=2)
    client = TCPStore(port=master.port, world_size=2)
    client.set("k", b"v")
    assert master.get("k") == b"v"
    assert master.add("n", 2) == 2 and client.add("n", 3) == 5


def test_barrier_across_threads_in_generations():
    master = TCPStore(is_master=True, world_size=3)
    stores = [master] + [TCPStore(port=master.port, world_size=3)
                         for _ in range(2)]
    passed = []

    def rank(r):
        for gen in range(2):
            stores[r].barrier("b", timeout=10)
            passed.append((gen, r))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert sorted(passed) == [(g, r) for g in range(2) for r in range(3)]


class TestStoreBackoff:
    def test_connect_retries_until_master_appears(self):
        """The client dials before the master binds."""
        probe = TCPStore(is_master=True, world_size=1)
        port = probe.port
        del probe
        holder = {}

        def late_master():
            time.sleep(0.4)
            holder["master"] = TCPStore(port=port, is_master=True,
                                        world_size=2)

        t = threading.Thread(target=late_master, daemon=True)
        t.start()
        client = TCPStore(port=port, is_master=False, world_size=2,
                          timeout=15.0)
        t.join()
        holder["master"].set("k", b"v")
        assert client.get("k", timeout=5) == b"v"

    def test_connect_timeout_still_raises(self):
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError):
            TCPStore(host="127.0.0.1", port=1, is_master=False,
                     timeout=0.5)
        assert time.perf_counter() - t0 < 10.0

    def test_blocking_get_backs_off_but_stays_responsive(self):
        master = TCPStore(is_master=True, world_size=1)

        def late_set():
            time.sleep(0.3)
            master.set("late", b"x")

        threading.Thread(target=late_set, daemon=True).start()
        t0 = time.perf_counter()
        assert master.get("late", blocking=True, timeout=10) == b"x"
        assert time.perf_counter() - t0 < 2.0


class TestBoundedWaits:
    def test_store_wait_shares_one_deadline_across_keys(self):
        client = TCPStore(is_master=True, world_size=2)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            client.wait(["never/a", "never/b", "never/c", "never/d"],
                        timeout=0.4)
        assert time.monotonic() - t0 < 1.2    # one budget, not four

    def test_store_get_zero_timeout_fails_fast(self):
        client = TCPStore(is_master=True, world_size=2)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            client.get("never/zero", timeout=0)
        assert time.monotonic() - t0 < 1.0

    def test_barrier_timeout_bounded(self):
        client = TCPStore(is_master=True, world_size=2)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            client.barrier(name="lonely", timeout=0.4)
        assert time.monotonic() - t0 < 1.5
