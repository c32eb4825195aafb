"""Elastic training manager (the port of
``paddle_tpu/distributed/fleet/elastic.py``; reference parity:
python/paddle/distributed/fleet/elastic/manager.py — ElasticManager
registers nodes, watches membership and triggers relaunch; the trainer
requests relaunch by exiting with ELASTIC_EXIT_CODE=101).

Membership rides the port's ``TCPStore`` (``distributed/store.py``, over
``torch.distributed.TCPStore``) instead of etcd — the same
watch/heartbeat contract, no external service.  The launcher's
``--max_restarts`` and ``resilience.TrainingSupervisor(elastic=)``
implement the relaunch policy.
"""
from __future__ import annotations

import os
import socket
import threading
import time

from ..store import TCPStore

__all__ = ["ElasticManager", "ELASTIC_EXIT_CODE", "enable_elastic"]

ELASTIC_EXIT_CODE = 101


def enable_elastic():
    """Reference: fleet/elastic/__init__.py:28 — elastic is on when the
    PADDLE_ELASTIC_* env contract is present."""
    return bool(os.environ.get("PADDLE_ELASTIC_NP"))


class ElasticManager:
    """Node membership with heartbeats over a shared KV store.

    * register() announces this node and starts a heartbeat thread
    * alive_nodes() lists nodes with fresh heartbeats
    * match() — membership equals the expected np
    * watch(timeout) — blocks until membership changes from matching to
      broken (node lost / joined), returns the event

    Liveness is clock-skew-free: heartbeats are a monotonically
    increasing per-node counter (store.add), and a peer counts as alive
    while its counter keeps ADVANCING within node_timeout of the
    *reader's* monotonic clock — wall-clock timestamps never cross
    hosts (the reference gets the same property from etcd server-side
    TTL leases).
    """

    def __init__(self, store: TCPStore = None, job_id="default", np=1,
                 host=None, heartbeat_interval=0.5, node_timeout=2.0):
        if store is None:
            endpoint = os.environ.get("PADDLE_ELASTIC_SERVER")
            if endpoint is None:
                raise ValueError(
                    "ElasticManager needs a shared store: pass store= or "
                    "set PADDLE_ELASTIC_SERVER=host:port (a private "
                    "local store would split-brain multi-node jobs)")
            h, p = endpoint.rsplit(":", 1)
            store = TCPStore(host=h, port=int(p), is_master=(int(p) == 0),
                             world_size=np)
        self.store = store
        self.job = job_id
        self.np = int(os.environ.get("PADDLE_ELASTIC_NP", np))
        self.host = host or f"{socket.gethostname()}-{os.getpid()}"
        self.heartbeat_interval = heartbeat_interval
        self.node_timeout = node_timeout
        self._stop = threading.Event()
        self._thread = None
        # host -> (last counter value, reader-side monotonic time it advanced).
        # Not lock-guarded by design: only the prober thread (the
        # supervisor's watch loop) reads/writes it — the heartbeat
        # thread touches the store, never this dict.
        self._seen = {}

    # ---------------------------------------------------------- membership
    def _key(self):
        return f"elastic/{self.job}/{self.host}"

    def register(self):
        self.store.add(self._key(), 1)

        def beat():
            while not self._stop.wait(self.heartbeat_interval):
                try:
                    self.store.add(self._key(), 1)
                except Exception:
                    # silent-ok: transient store error — keep beating, a
                    # single blip must not silence a healthy node for
                    # good (peer-side timeout handles truly-dead stores)
                    continue

        self._thread = threading.Thread(target=beat, daemon=True)
        self._thread.start()
        return self

    def deregister(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self.store.delete_key(self._key())

    # host lists are explicit (PADDLE_TRAINERS in the reference); the KV
    # store is scanless by design, so peers are probed by name
    def probe(self, host):
        try:
            counter = self.store.add(f"elastic/{self.job}/{host}", 0)
        except TypeError:
            return False        # key holds junk — not a registered node
        # store I/O errors (RuntimeError) propagate: a network blip must
        # not read as "every node died" and trigger a spurious relaunch
        if counter <= 0:        # never registered (add(0) creates at 0)
            return False
        now = time.monotonic()
        prev = self._seen.get(host)
        if prev is None or counter != prev[0]:
            self._seen[host] = (counter, now)
            return True
        return (now - prev[1]) < self.node_timeout

    def match(self, hosts):
        """True when every expected host is alive and none extra expected."""
        alive = [h for h in hosts if self.probe(h)]
        return len(alive) == self.np

    def wait_for_np(self, hosts, timeout=30.0):
        """Blocks until membership matches np — and HOLDS for a full
        node_timeout.  The hold defeats the first-sighting grace window:
        a freshly-constructed manager (post-relaunch) seeing a crashed
        peer's stale counter counts it alive only until the window
        expires, so a match built on corpses breaks before we return.
        The deadline is therefore extended to fit at least one full hold
        window (timeout < node_timeout could otherwise never succeed).

        Deadlines ride the monotonic clock, same as liveness: an NTP
        wall-clock step must not spuriously expire (or extend) a
        rendezvous that a peer's heartbeat window would survive."""
        deadline = time.monotonic() + max(
            timeout, self.node_timeout + 2 * self.heartbeat_interval)
        held_since = None
        while time.monotonic() < deadline:
            if self.match(hosts):
                now = time.monotonic()
                if held_since is None:
                    held_since = now
                if now - held_since >= self.node_timeout:
                    return True
            else:
                held_since = None
            time.sleep(min(self.heartbeat_interval, 0.1))
        return False

    def watch(self, hosts, timeout=60.0):
        """Block until membership breaks (a host dies) or timeout.
        Returns ('lost', [hosts]) / ('ok', []) on timeout.  The
        deadline is monotonic — wall-clock steps can't cut a watch
        short or pin it open."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            dead = [h for h in hosts if not self.probe(h)]
            if dead:
                return ("lost", dead)
            time.sleep(self.heartbeat_interval)
        return ("ok", [])
