"""Parameter-server (sparse/CTR) stack (the port of
``paddle_tpu/distributed/ps/__init__.py``).

Reference parity: paddle/fluid/distributed/ps/ — PSClient, PSServer and
a sharded Table, used for CTR models whose sparse embedding tables do not
fit a card.  The dense side of such a model trains on the card; what
this module holds is the *sparse* half — embedding tables on host
servers, trainers pulling rows by id and pushing gradients
asynchronously (hogwild) — over the port's ``TCPStore``
(``distributed/store.py``, on ``torch.distributed.TCPStore``):

* row storage    : one store key per (table, row-id), f32[dim]
* row creation   : exactly ONE path — create-if-absent of the
                   deterministic (hash-seeded) init row; concurrent
                   first-touchers all write identical bytes and the
                   store keeps the first
* pull_sparse    : a batched get, or, when a row is missing, one
                   create-if-absent a row that returns the row that won
* push_sparse    : FADD — on torch's store a push's rows are read and
                   written under the store's row lock, taken by
                   compare-and-set (the JAX package's store adds on the
                   server, under its mutex); every refused lock attempt
                   is counted in ``PSClient.cas_retries``.  FADD never
                   creates rows, so a push cannot race an initializing
                   pull into a lost update
* async SGD      : push(-lr * grad) IS the optimizer
* sharding       : N servers; rows map to a server by hash(id) % N

The card never holds the table: pulled rows are gathered on the host
into a dense [batch, dim] array and copied to the card once per step —
the lookup stays on the host, the dense tower on the card.  The rows
are the JAX package's bit for bit for the same ids and seed.
"""
from __future__ import annotations

import numpy as np

from ..store import TCPStore

__all__ = ["PSServer", "PSClient", "SparseTable", "SparseEmbedding"]


class PSServer:
    """One table-shard server == one ``TCPStore`` master.

    Reference: BrpcPsServer (ps/service/brpc_ps_server.cc) — ours is the
    store server; the "service handlers" are the store's operations.
    """

    def __init__(self, host="127.0.0.1", port=0):
        self._store = TCPStore(host=host, port=port, is_master=True)
        self.host = host
        self.port = self._store.port

    @property
    def endpoint(self):
        return f"{self.host}:{self.port}"

    def stop(self):
        self._store.close()


class PSClient:
    """Connects to every server shard; routes rows by hash.

    Reference: PSClient (ps/service/ps_client.h:62) — pull_sparse /
    push_sparse are the two RPCs that matter.
    """

    def __init__(self, endpoints, timeout=30.0):
        if isinstance(endpoints, str):
            endpoints = endpoints.split(",")
        self._stores = []
        for ep in endpoints:
            h, p = ep.rsplit(":", 1)
            self._stores.append(TCPStore(host=h, port=int(p),
                                         timeout=timeout))

    @property
    def cas_retries(self):
        """Row-lock attempts refused to this client's pushes (each one a
        compare-and-set that found the lock held by another writer)."""
        return sum(s.cas_retries for s in self._stores)

    def _shard_index(self, row_id) -> int:
        return hash(int(row_id)) % len(self._stores)

    @staticmethod
    def _key(table, row_id):
        return f"ps/{table}/{int(row_id)}"

    @staticmethod
    def _init_rows(rids, dim, init_std, seed):
        """Deterministic N(0, init_std) init for a BATCH of rows, fully
        vectorized: splitmix64 of (seed, row, column) -> Box-Muller.
        Per-row np.random.RandomState construction costs ~0.15 ms; at a
        4096-row cold pull that was ~0.6 s of pure host time."""
        C1 = np.uint64(0x9E3779B97F4A7C15)
        C2 = np.uint64(0xBF58476D1CE4E5B9)
        C3 = np.uint64(0x94D049BB133111EB)
        # stream tweaks: XOR (not +C1) so the two uniforms can never
        # alias a neighboring row's stream (base is linear in rid with
        # stride C1, so mix(base + C1) IS the next row's first stream),
        # and a nonzero tweak keeps mix's 0 -> 0 fixed point off the
        # (rid=0, col=0, seed=0) padding row
        A1 = np.uint64(0xD6E8FEB86659FD93)
        A2 = np.uint64(0xA5A3564E4B2C1D07)

        def mix(x):
            x = (x ^ (x >> np.uint64(30))) * C2
            x = (x ^ (x >> np.uint64(27))) * C3
            return x ^ (x >> np.uint64(31))

        with np.errstate(over="ignore"):
            # int64 first: negative feature hashes wrap (two's
            # complement) instead of raising under numpy 2
            rid = np.asarray(rids, np.int64).astype(np.uint64)[:, None]
            col = np.arange(dim, dtype=np.uint64)[None, :]
            base = (rid * C1 + col * C2
                    + np.uint64(np.int64(seed) & 0x7FFFFFFF) * C3)
            h1 = mix(base ^ A1)
            h2 = mix(base ^ A2)
        # (h >> 11) + 0.5 in [0.5, 2^53): u strictly inside (0, 1) — no
        # clamp, so no 7-sigma outlier at the h == 0 corner
        u1 = ((h1 >> np.uint64(11)).astype(np.float64) + 0.5) \
            * (1.0 / (1 << 53))
        u2 = ((h2 >> np.uint64(11)).astype(np.float64) + 0.5) \
            * (1.0 / (1 << 53))
        z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
        return (z * init_std).astype(np.float32)

    @classmethod
    def _init_row(cls, rid, dim, init_std, seed):
        return cls._init_rows([rid], dim, init_std, seed)[0]

    def _ensure_rows(self, store, keys, rids, dim, init_std, seed):
        """Batched create-if-absent of the rows' deterministic init: the
        first writer wins, so the stored row afterwards is init + any
        concurrently-pushed deltas."""
        store.msetnx(keys, self._init_rows(rids, dim, init_std, seed))

    def _by_shard(self, ids):
        """Group positions by owning server: [(store, [positions])]."""
        groups = {}
        for pos, rid in enumerate(ids):
            groups.setdefault(self._shard_index(rid), []).append(pos)
        return [(self._stores[s], p) for s, p in groups.items()]

    @staticmethod
    def _check_dim(raw, dim, table, rid):
        if len(raw) != dim * 4:
            raise ValueError(
                f"SparseTable {table!r} row {rid}: stored dim "
                f"{len(raw) // 4} != requested dim {dim} — the table "
                f"was created with a different embedding size")
        return np.frombuffer(raw, dtype=np.float32)

    def pull_sparse(self, table, ids, dim, init_std=0.01, seed=0):
        """Fetch rows [len(ids), dim] — one batched read per server shard
        when every row exists; deterministic init-on-first-touch (the
        missing rows created from their init in the same pass)."""
        out = np.empty((len(ids), dim), dtype=np.float32)
        for store, positions in self._by_shard(ids):
            keys = [self._key(table, ids[p]) for p in positions]
            rids = [ids[p] for p in positions]
            values = store.mget_or_create(
                keys, _LazyRows(self, rids, dim, init_std, seed))
            for p, v in zip(positions, values):
                out[p] = self._check_dim(v, dim, table, ids[p])
        return out

    def push_sparse(self, table, ids, deltas, init_std=0.01, seed=0):
        """Atomically accumulate deltas into rows — ONE batched round
        trip per server shard.  Async SGD = caller passes -lr * grad.
        Duplicate ids within one push are applied per-occurrence
        (accumulate is associative)."""
        if not len(ids):
            return
        deltas = np.asarray(deltas, dtype=np.float32)
        deltas = deltas.reshape(len(ids), -1)
        for store, positions in self._by_shard(ids):
            keys = [self._key(table, ids[p]) for p in positions]
            rows = deltas[positions]
            status = store.mfadd(keys, rows)
            fresh = [i for i, st in enumerate(status) if st == 1]
            bad = [i for i, st in enumerate(status) if st not in (0, 1)]
            if bad:
                raise ValueError(
                    f"SparseTable {table!r} row {ids[positions[bad[0]]]}: "
                    f"push dim {rows.shape[1]} does not match the "
                    f"stored row")
            if fresh:   # first touch by a push: batch-init, then retry
                self._ensure_rows(store, [keys[i] for i in fresh],
                                  [ids[positions[i]] for i in fresh],
                                  rows.shape[1], init_std, seed)
                retry = store.mfadd([keys[i] for i in fresh],
                                    rows[fresh])
                if any(st != 0 for st in retry):
                    raise ValueError(
                        f"SparseTable {table!r}: post-init push retry "
                        f"failed (status {list(retry)})")

    def barrier(self, name="ps_barrier", world_size=1, timeout=None):
        s = self._stores[0]
        prev = s.world_size
        s.world_size = world_size
        try:
            # resolve the default HERE so the forwarded budget is a
            # real number, not a None that each layer re-defaults
            s.barrier(name=name,
                      timeout=s.timeout if timeout is None else timeout)
        finally:
            s.world_size = prev


class _LazyRows:
    """The init rows of ``rids``, computed only when a store asks for
    them (a warm pull reads existing rows and never needs them)."""

    def __init__(self, client, rids, dim, init_std, seed):
        self.args = (client, rids, dim, init_std, seed)

    def __array__(self, dtype=None, copy=None):
        client, rids, dim, init_std, seed = self.args
        rows = client._init_rows(rids, dim, init_std, seed)
        return rows if dtype is None else rows.astype(dtype)


class SparseTable:
    """A named table bound to a client — the Table (table.h:65) facade."""

    def __init__(self, client: PSClient, name: str, dim: int,
                 init_std=0.01, seed=0):
        self.client = client
        self.name = name
        self.dim = dim
        self.init_std = init_std
        self.seed = seed

    def pull(self, ids):
        return self.client.pull_sparse(self.name, ids, self.dim,
                                       self.init_std, self.seed)

    def push(self, ids, deltas):
        self.client.push_sparse(self.name, ids, deltas,
                                self.init_std, self.seed)


class SparseEmbedding:
    """Host-side embedding over a SparseTable for CTR-style models.

    ``forward(ids)`` pulls rows (host) and returns a tensor on
    ``device`` (the card unless the caller passes ``device="cpu"``) that
    requires grad; after the dense backward, ``apply_grads()`` pushes
    the async-SGD update ``-lr · grad`` of the last forward's rows (or
    of an explicit ``grad`` / ``ids``).  This is the
    `operators/pscore/send_op`-style boundary: sparse traffic goes to
    host servers, dense compute stays on the card.
    """

    def __init__(self, table: SparseTable, lr=0.01, device=None):
        from ..._device import resolve_device

        self.table = table
        self.lr = lr
        self.device = resolve_device(device)
        self._last_ids = None
        self._last_rows = None

    def forward(self, ids):
        import torch

        ids = np.asarray(ids).reshape(-1)
        self._last_ids = ids
        rows = torch.from_numpy(self.table.pull(ids))
        if self.device.type == "cuda":
            rows = rows.pin_memory().to(self.device, non_blocking=True)
        self._last_rows = rows.requires_grad_()
        return self._last_rows

    __call__ = forward

    def apply_grads(self, grad=None, ids=None, lr=None):
        ids = self._last_ids if ids is None else np.asarray(ids).reshape(-1)
        if ids is None:
            raise RuntimeError("SparseEmbedding.apply_grads: no ids "
                               "recorded — run forward() first or pass ids=")
        if grad is None:
            grad = self._last_rows.grad if self._last_rows is not None \
                else None
            if grad is None:
                raise RuntimeError("SparseEmbedding.apply_grads: the last "
                                   "forward's rows have no gradient — run "
                                   "the backward first or pass grad=")
        if hasattr(grad, "detach"):
            grad = grad.detach().float().cpu().numpy()
        g = np.asarray(grad, dtype=np.float32).reshape(len(ids), -1)
        self.table.push(ids, -(self.lr if lr is None else lr) * g)
