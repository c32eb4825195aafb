"""A world of port ranks for the CPU tests: ``World(n)`` starts ``n``
processes, one a rank, each with the launcher's env contract (gloo on the
CPU, one torch thread) and ``init_parallel_env()`` done, and runs case
functions on every rank: ``world.run("module", "fn", *args)`` calls
``module.fn(*args)`` in each rank and returns the ranks' results in rank
order.  A case that raises in any rank raises here with that rank's
traceback, and the world is started anew for the next case (the others
may be waiting in a collective).  Messages are pickles over the ranks'
stdin/stdout; the ranks' prints go to their stderr.

This module imports neither jax nor the JAX package: the ranks run the
port alone.  ``python tests/torch_world.py --worker`` is a rank's main
loop."""
from __future__ import annotations

import os
import pickle
import select
import signal
import socket
import struct
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)


def _send(f, obj):
    data = pickle.dumps(obj)
    f.write(struct.pack("<Q", len(data)) + data)
    f.flush()


def _read_exact(f, n):
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            raise EOFError("rank closed its pipe")
        buf += chunk
    return buf


def _recv(f):
    (n,) = struct.unpack("<Q", _read_exact(f, 8))
    return pickle.loads(_read_exact(f, n))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    def __init__(self, n, timeout_s=float(os.environ.get(
            "TORCH_WORLD_TIMEOUT_S", 240))):
        self.n, self.timeout_s = n, timeout_s
        self.procs = None

    def _start(self):
        port = _free_port()
        self.procs = []
        for r in range(self.n):
            env = dict(os.environ)
            env.update({
                "PADDLE_TRAINER_ID": str(r), "PADDLE_TRAINERS_NUM":
                str(self.n), "PADDLE_LOCAL_RANK": str(r),
                "PADDLE_NPROC_PER_NODE": str(self.n),
                "PADDLE_MASTER": f"127.0.0.1:{port}",
                "PADDLE_DIST_BACKEND": "gloo", "PADDLE_DIST_DEVICE": "cpu",
                "PYTHONPATH": os.pathsep.join(
                    [_ROOT, _HERE, env.get("PYTHONPATH", "")]),
                "OMP_NUM_THREADS": "1"})
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
                cwd=_ROOT))

    def run(self, module, fn, *args):
        if self.procs is None:
            self._start()
        for p in self.procs:
            _send(p.stdin, (module, fn, args))
        results = [None] * self.n
        pending = {p.stdout.fileno(): i for i, p in enumerate(self.procs)}
        deadline = time.monotonic() + self.timeout_s
        try:
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    for i in pending.values():   # their stacks to stderr
                        self.procs[i].send_signal(signal.SIGUSR1)
                    time.sleep(1.0)
                    raise TimeoutError(
                        f"{fn}: ranks {sorted(pending.values())} did not "
                        f"answer in {self.timeout_s} s")
                ready, _, _ = select.select(list(pending), [], [], left)
                for fd in ready:
                    i = pending.pop(fd)
                    results[i] = _recv(self.procs[i].stdout)
        except BaseException:
            self.close()
            raise
        errors = [(i, r[1]) for i, r in enumerate(results) if r[0] != "ok"]
        if errors:
            self.close()
            raise RuntimeError("\n".join(f"rank {i}:\n{tb}"
                                         for i, tb in errors))
        return [r[1] for r in results]

    def close(self):
        if self.procs is None:
            return
        for p in self.procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.procs = None


def _worker():
    import faulthandler
    import importlib
    import traceback

    faulthandler.register(signal.SIGUSR1)

    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)                       # prints go to stderr
    import torch

    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import init_parallel_env

    init_parallel_env(timeout_s=120)
    inp = sys.stdin.buffer
    while True:
        try:
            module, fn, args = _recv(inp)
        except EOFError:
            break
        try:
            res = ("ok", getattr(importlib.import_module(module), fn)(*args))
        except BaseException:       # noqa: BLE001 - sent to the parent
            res = ("err", traceback.format_exc())
        _send(out, res)


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        _worker()
