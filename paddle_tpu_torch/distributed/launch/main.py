"""The launcher (see the package docstring for the contract)."""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["launch", "main", "ELASTIC_EXIT_CODE"]

#: a rank asks for its world to be relaunched by exiting with this code
ELASTIC_EXIT_CODE = 101


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
    first failing rank's code (after terminating the others and using up
    ``--max_restarts``)."""
    args = _parse(argv if argv is not None else sys.argv[1:])
    nproc = args.nproc_per_node
    world = nproc * args.nnodes
    if args.nnodes > 1 and not args.master:
        raise SystemExit(
            "--master host:port is required when nnodes > 1 (every node "
            "must rendezvous at the same address)")
    master = args.master or f"127.0.0.1:{_free_port()}"
    os.makedirs(args.log_dir, exist_ok=True)
    endpoints = "" if args.nnodes > 1 else ",".join(
        f"{master.split(':')[0]}:{_free_port()}" for _ in range(nproc))

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

    attempt = 0
    procs, logs = spawn_world(attempt)
    rc = 0
    try:
        while procs:
            failed = next((c for c in (p.poll() for p in procs)
                           if c not in (None, 0)), None)
            if failed is not None:
                teardown(procs)
                for f in logs:
                    f.close()
                if attempt < args.max_restarts:
                    attempt += 1
                    procs, logs = spawn_world(attempt)
                    continue
                rc = failed
                break
            if all(p.poll() == 0 for p in procs):
                break
            time.sleep(0.1)
    except KeyboardInterrupt:
        for pr in procs:
            if pr.poll() is None:
                pr.send_signal(signal.SIGINT)
        teardown(procs)
        rc = 130
    finally:
        for f in logs:
            f.close()
    return rc


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
