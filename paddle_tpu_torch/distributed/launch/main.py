"""The launcher (see the package docstring for the contract)."""
from __future__ import annotations

import argparse
import datetime
import os
import signal
import socket
import subprocess
import sys
import time

from ..fleet.elastic import ELASTIC_EXIT_CODE

__all__ = ["launch", "main", "ELASTIC_EXIT_CODE"]

#: how long a rank that has begun to leave is let finish on its own
LEAVING_GRACE_S = 10.0
#: seconds between two polls of the ranks
POLL_S = 0.05


def _host_store(host, world, timeout_s=600):
    """The world's rendezvous store, bound on port 0 in this process
    before any rank starts; its ``port`` is what the ranks are told."""
    import torch.distributed as dist

    return dist.TCPStore(host, 0, world, True,
                         timeout=datetime.timedelta(seconds=timeout_s),
                         wait_for_workers=False)


def _held_ports(host, n):
    """``n`` sockets bound on port 0 and kept open: the endpoint names
    stay this job's until the launcher exits."""
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind((host, 0))
        socks.append(s)
    return socks


def _left_at(store, attempt, rank):
    """When ``rank`` of this attempt began to leave, by the time its exit
    hook wrote into the hosted store (``env._end_world``), or None."""
    key = f"attempt_{attempt}//exit/{rank}"
    if store is None or not store.check([key]):
        return None
    # rank-ok: read only once check() found the key, so get returns at once
    # lint-ok: collective-discipline the same: the key is there, no wait
    return float(store.get(key))


def _world_code(procs, ranks, store, attempt, seen):
    """The exit code of a failed world: that of the failed rank that
    began to leave first.

    A rank that exits (a 101, an error) destroys its process groups in
    its exit hook, and a peer inside a collective with it then exits 1 of
    the lost connection, often before the first rank's process has
    ended.  So the ranks whose hook has run are let finish (up to
    ``LEAVING_GRACE_S``), and the failed ranks are ordered by when they
    began to leave: the time their hook wrote, or, for a rank that died
    without it (a signal, a hard crash), the poll before it was seen
    dead (``seen``: rank -> that time).  Ranks still running are left to
    the caller's teardown."""
    deadline = time.monotonic() + LEAVING_GRACE_S
    last = time.time()
    while time.monotonic() < deadline:
        running = [i for i, p in enumerate(procs) if p.poll() is None]
        if not any(_left_at(store, attempt, ranks[i]) is not None
                   for i in running):
            break
        last = time.time()
        time.sleep(POLL_S)
    codes = [p.poll() for p in procs]
    for i, c in enumerate(codes):
        if c is not None:
            seen.setdefault(i, last)
    when = {}
    for i, c in enumerate(codes):
        if c not in (None, 0):
            t = _left_at(store, attempt, ranks[i])
            when[i] = seen[i] if t is None else t
    return codes[min(when, key=when.get)]


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="Launch a training script, one process a rank")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="rank processes to start on this node")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--master", default=None,
                   help="rendezvous host:port (default: a free local port)")
    p.add_argument("--log_dir", default="log",
                   help="directory of the per-rank workerlog.N files")
    p.add_argument("--backend", default=None, choices=[None, "nccl", "gloo"],
                   help="the world's transport (default: nccl when each "
                        "rank has a card of its own, else gloo)")
    p.add_argument("--device", default=None, choices=[None, "cuda", "cpu"],
                   help="where the ranks compute (default: cuda)")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="relaunch the world when a rank exits with "
                        f"{ELASTIC_EXIT_CODE} or crashes, at most this many "
                        "times")
    p.add_argument("training_script", help="script to run")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def launch(argv=None):
    """Start the ranks, watch them, and return the exit code: 0, or the
    code of the failed rank that began to leave first (after terminating
    the others and using up ``--max_restarts``; see
    :func:`_world_code`)."""
    args = _parse(argv if argv is not None else sys.argv[1:])
    nproc = args.nproc_per_node
    world = nproc * args.nnodes
    if args.nnodes > 1 and not args.master:
        raise SystemExit(
            "--master host:port is required when nnodes > 1 (every node "
            "must rendezvous at the same address)")
    store = None
    if args.master:
        master = args.master
    else:
        store = _host_store("127.0.0.1", world)
        master = f"127.0.0.1:{store.port}"
    os.makedirs(args.log_dir, exist_ok=True)
    held = [] if args.nnodes > 1 else _held_ports(master.split(":")[0],
                                                  nproc)
    endpoints = ",".join(f"{master.split(':')[0]}:{s.getsockname()[1]}"
                         for s in held)

    def spawn_world(attempt):
        procs, logs = [], []
        for local_rank in range(nproc):
            rank = args.node_rank * nproc + local_rank
            env = dict(os.environ)
            env.update({
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS_NUM": str(world),
                "PADDLE_LOCAL_RANK": str(local_rank),
                "PADDLE_NPROC_PER_NODE": str(nproc),
                "PADDLE_MASTER": master,
                "PADDLE_MASTER_HOSTED": "1" if store is not None else "0",
                "PADDLE_TRAINER_ENDPOINTS": endpoints,
                "PADDLE_RESTART_ATTEMPT": str(attempt),
            })
            if args.backend:
                env["PADDLE_DIST_BACKEND"] = args.backend
            if args.device:
                env["PADDLE_DIST_DEVICE"] = args.device
            logf = open(os.path.join(args.log_dir, f"workerlog.{rank}"),
                        "a" if attempt else "w")
            if attempt:
                logf.write(f"\n----- restart attempt {attempt} -----\n")
                logf.flush()
            procs.append(subprocess.Popen(
                [sys.executable, "-u", args.training_script,
                 *args.training_script_args],
                env=env, stdout=logf, stderr=subprocess.STDOUT))
            logs.append(logf)
        return procs, logs

    def teardown(procs):
        for pr in procs:
            if pr.poll() is None:
                pr.terminate()
        for pr in procs:
            try:
                pr.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait()

    def on_term(signum, frame):
        # a supervisor ends the launcher with SIGTERM: take the ranks
        # down with it instead of leaving them orphaned in a collective
        raise KeyboardInterrupt

    prev_term = signal.signal(signal.SIGTERM, on_term)
    ranks = [args.node_rank * nproc + i for i in range(nproc)]
    attempt = 0
    procs, logs = spawn_world(attempt)
    rc = 0
    try:
        seen, polled = {}, time.time()
        while procs:
            codes = [p.poll() for p in procs]
            for i, c in enumerate(codes):
                if c is not None:
                    seen.setdefault(i, polled)
            polled = time.time()
            if any(c not in (None, 0) for c in codes):
                failed = _world_code(procs, ranks, store, attempt, seen)
                seen = {}
                teardown(procs)
                for f in logs:
                    f.close()
                if attempt < args.max_restarts:
                    attempt += 1
                    procs, logs = spawn_world(attempt)
                    continue
                rc = failed
                break
            if all(c == 0 for c in codes):
                break
            time.sleep(POLL_S)
    except KeyboardInterrupt:
        for pr in procs:
            if pr.poll() is None:
                pr.send_signal(signal.SIGINT)
        teardown(procs)
        rc = 130
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        for f in logs:
            f.close()
        for s in held:
            s.close()
    return rc


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
