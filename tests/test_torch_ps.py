"""The port's parameter server (``distributed/ps``) against the JAX
package's, mirroring ``tests/test_ps.py``: pulled rows bitwise equal to
the JAX ``PSClient``'s for the same ids and seed (the deterministic
splitmix64 + Box-Muller init, on two servers), push accumulation,
sharding across servers, a loud dimension mismatch, a first-touch push,
concurrent pushes landing atomically through the compare-and-set loop
(retries counted), and an async-SGD round trip through
``SparseEmbedding`` equal to the JAX one (1e-6), with the embedding's
gradient taken by torch's autograd.  Servers are in-process
``TCPStore`` masters and trainers threads: the wire and the atomicity
are real."""
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.ps import PSClient as JPSClient
from paddle_tpu.distributed.ps import PSServer as JPSServer
from paddle_tpu.distributed.ps import SparseEmbedding as JSparseEmbedding
from paddle_tpu.distributed.ps import SparseTable as JSparseTable
from paddle_tpu_torch.distributed.ps import (PSClient, PSServer,
                                             SparseEmbedding, SparseTable)


@pytest.fixture()
def cluster():
    servers = [PSServer(), PSServer()]
    client = PSClient([s.endpoint for s in servers])
    yield servers, client
    for s in servers:
        s.stop()


@pytest.fixture()
def jcluster():
    servers = [JPSServer(), JPSServer()]
    client = JPSClient([s.endpoint for s in servers])
    yield servers, client
    for s in servers:
        s.stop()


def _ids(n=300, seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randint(-2**40, 2**40, n // 2),
                           rng.randint(0, 1000, n - n // 2)]).tolist()


def test_pulled_rows_bitwise_equal_jax(cluster, jcluster):
    _, client = cluster
    _, jclient = jcluster
    ids = _ids()
    for dim, std, seed in ((8, 0.1, 3), (64, 0.01, 0)):
        a = SparseTable(client, f"emb{dim}", dim, std, seed).pull(ids)
        b = JSparseTable(jclient, f"emb{dim}", dim, std, seed).pull(ids)
        assert a.dtype == np.float32 and a.shape == (len(ids), dim)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        PSClient._init_rows(ids, 16, 0.05, 7),
        JPSClient._init_rows(ids, 16, 0.05, 7))
    assert [client._shard_index(i) for i in ids] == \
        [jclient._shard_index(i) for i in ids]


def test_pull_initializes_deterministically(cluster):
    servers, client = cluster
    t = SparseTable(client, "emb", dim=8, init_std=0.1, seed=3)
    a = t.pull([1, 2, 3])
    np.testing.assert_array_equal(a, t.pull([1, 2, 3]))
    c2 = PSClient([s.endpoint for s in servers])
    np.testing.assert_array_equal(
        a, SparseTable(c2, "emb", dim=8, init_std=0.1, seed=3).pull([1, 2,
                                                                     3]))


def test_push_accumulates(cluster):
    _, client = cluster
    t = SparseTable(client, "t2", dim=4, init_std=0.0)
    base = t.pull([7])
    t.push([7], np.ones((1, 4), np.float32))
    t.push([7], 2 * np.ones((1, 4), np.float32))
    np.testing.assert_allclose(t.pull([7]), base + 3.0, rtol=1e-6)


def test_rows_shard_across_servers(cluster):
    servers, client = cluster
    SparseTable(client, "t3", dim=2, init_std=0.0).pull(list(range(40)))
    counts = []
    for s in servers:
        local = PSClient([s.endpoint])._stores[0]
        counts.append(sum(v is not None for v in local.mget(
            [f"ps/t3/{rid}" for rid in range(40)])))
    assert sum(counts) == 40 and all(c > 0 for c in counts)


def test_dim_mismatch_is_loud(cluster):
    _, client = cluster
    SparseTable(client, "mix", dim=16, init_std=0.0).pull([0])
    t8 = SparseTable(client, "mix", dim=8, init_std=0.0)
    with pytest.raises(ValueError, match="dim"):
        t8.pull([0])
    with pytest.raises(ValueError, match="dim|match"):
        t8.push([0], np.ones((1, 8), np.float32))


def test_push_first_touch_initializes(cluster):
    _, client = cluster
    t = SparseTable(client, "pf", dim=4, init_std=0.05, seed=9)
    t.push([11], np.zeros((1, 4), np.float32))
    np.testing.assert_array_equal(t.pull([11])[0],
                                  JPSClient._init_row(11, 4, 0.05, 9))


def test_concurrent_push_is_atomic(cluster):
    _, client = cluster
    t = SparseTable(client, "t4", dim=16, init_std=0.0)
    base = t.pull([0]).copy()
    endpoints = [f"{st.host}:{st.port}" for st in client._stores]
    clients = [PSClient(endpoints) for _ in range(4)]

    def worker(c):
        tt = SparseTable(c, "t4", dim=16, init_std=0.0)
        for _ in range(25):
            tt.push([0], np.ones((1, 16), np.float32))

    threads = [threading.Thread(target=worker, args=(c,)) for c in clients]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    np.testing.assert_allclose(t.pull([0]), base + 100, rtol=1e-5)
    assert sum(c.cas_retries for c in clients) >= 0


def test_async_sgd_round_trip_equals_jax(cluster, jcluster):
    """Two steps of a dense tower over the embedding: the port takes the
    embedding's gradient by autograd and pushes -lr·grad; the JAX side
    pushes the same gradient computed in numpy.  Rows after each step
    agree to 1e-6."""
    _, client = cluster
    _, jclient = jcluster
    emb = SparseEmbedding(SparseTable(client, "e", dim=4, init_std=0.1,
                                      seed=5), lr=0.5, device="cpu")
    jemb = JSparseEmbedding(JSparseTable(jclient, "e", dim=4, init_std=0.1,
                                         seed=5), lr=0.5)
    w = np.random.RandomState(0).randn(4, 1).astype(np.float32)
    ids = [5, 9, 5, 1000003]
    for _ in range(2):
        rows = emb.forward(ids)
        assert rows.requires_grad and rows.device.type == "cpu"
        (rows @ torch.from_numpy(w)).square().sum().backward()
        emb.apply_grads()
        jrows = np.asarray(jemb.forward(ids))
        jemb.apply_grads(2 * (jrows @ w) @ w.T)
    np.testing.assert_allclose(emb.forward(ids).detach().numpy(),
                               np.asarray(jemb.forward(ids)), rtol=1e-6,
                               atol=1e-6)


def test_sparse_embedding_needs_a_forward_or_grad(cluster):
    _, client = cluster
    emb = SparseEmbedding(SparseTable(client, "g", dim=2), device="cpu")
    with pytest.raises(RuntimeError, match="forward"):
        emb.apply_grads(np.ones((1, 2), np.float32))
    emb.forward([1])
    with pytest.raises(RuntimeError, match="gradient"):
        emb.apply_grads()


def test_sparse_embedding_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception):
        SparseEmbedding(SparseTable(None, "x", dim=2))


_HOLDER = """
import sys, time
sys.path.insert(0, {repo!r})
from paddle_tpu_torch.distributed.store import TCPStore
store = TCPStore(port={port}, world_size=2)
store._take_row_lock()
print("HOLDING", flush=True)
time.sleep(600)
"""


def test_row_lock_of_a_killed_client_is_taken_over(tmp_path):
    """A client killed by SIGKILL while it holds the row lock (it runs
    no ``finally``): a push waits out the lease, takes the lock over and
    lands; a push that cannot take a live lock within the store's
    ``timeout`` raises ``TimeoutError`` instead of spinning forever."""
    import os
    import signal
    import subprocess
    import sys
    import time

    from paddle_tpu_torch.distributed.store import TCPStore

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    master = TCPStore(is_master=True, world_size=2)
    master.set_if_absent("row", np.zeros(4, np.float32).tobytes())
    script = tmp_path / "holder.py"
    script.write_text(_HOLDER.format(repo=repo, port=master.port))
    holder = subprocess.Popen([sys.executable, str(script)],
                              stdout=subprocess.PIPE, text=True)
    try:
        assert holder.stdout.readline().strip() == "HOLDING"
        live = TCPStore(port=master.port, world_size=2, timeout=0.3,
                        lock_lease_s=60.0)
        with pytest.raises(TimeoutError, match="row lock"):
            live.fadd("row", np.ones(4, np.float32))
        assert live.cas_retries > 0
        os.kill(holder.pid, signal.SIGKILL)
        holder.wait(timeout=30)
        waiter = TCPStore(port=master.port, world_size=2, timeout=30.0,
                          lock_lease_s=0.5)
        t0 = time.monotonic()
        out = waiter.fadd("row", np.full(4, 2.0, np.float32))
        assert time.monotonic() - t0 < 10.0
        np.testing.assert_array_equal(out, np.full(4, 2.0, np.float32))
        assert waiter.lock_takeovers == 1
        np.testing.assert_array_equal(
            waiter.mfadd(["row"], np.ones((1, 4), np.float32)), [0])
        np.testing.assert_array_equal(
            np.frombuffer(master.get("row"), np.float32),
            np.full(4, 3.0, np.float32))
    finally:
        holder.kill()
        holder.wait()
