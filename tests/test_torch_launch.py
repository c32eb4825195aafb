"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``)
on 2-rank CPU worlds, mirroring ``tests/test_launch.py``: the env
contract and a gloo all-reduce across the ranks, a ``workerlog.<rank>``
per rank, the first failure ending the world with its exit code, and
``--max_restarts`` relaunching a world whose rank asked for it with exit
code 101."""
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os, sys, time
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from paddle_tpu_torch.distributed import (all_reduce, get_rank,
                                          init_parallel_env)

env = init_parallel_env()
assert env.world_size == 2 and env.nranks == 2
assert env.rank == int(os.environ["PADDLE_TRAINER_ID"]) == get_rank()
assert env.local_rank == int(os.environ["PADDLE_LOCAL_RANK"])
assert len(env.trainer_endpoints) == 2 and str(env.device) == "cpu"
attempt = int(os.environ["PADDLE_RESTART_ATTEMPT"])
mode = {mode!r}
if mode == "fail" and env.rank == 1:
    time.sleep(1.0)
    sys.exit(3)
if mode == "fail":
    time.sleep(60)
if mode == "restart" and attempt == 0 and env.rank == 0:
    sys.exit(101)
x = torch.full((3,), float(env.rank + 1))
all_reduce(x)
print(f"WORKER_OK rank={{env.rank}} attempt={{attempt}} sum={{x.tolist()}}")
"""


def _launch(tmp_path, mode, *extra):
    script = tmp_path / f"worker_{mode}.py"
    script.write_text(WORKER.format(repo=REPO, mode=mode))
    logs = tmp_path / f"log_{mode}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    rc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--backend", "gloo", "--device", "cpu",
         "--log_dir", str(logs), *extra, str(script)],
        env=env, cwd=REPO, timeout=240).returncode
    return rc, logs, time.monotonic() - t0


def test_two_rank_all_reduce_and_worker_logs(tmp_path):
    rc, logs, _ = _launch(tmp_path, "ok")
    assert rc == 0
    for r in range(2):
        text = (logs / f"workerlog.{r}").read_text()
        assert f"WORKER_OK rank={r} attempt=0 sum=[3.0, 3.0, 3.0]" in text


def test_first_failure_ends_the_world_with_its_code(tmp_path):
    """Rank 1 exits 3 after a second; rank 0 (asleep for a minute) is
    terminated and the launcher returns 3 long before the minute."""
    rc, logs, took = _launch(tmp_path, "fail")
    assert rc == 3
    assert took < 45
    assert "WORKER_OK" not in (logs / "workerlog.0").read_text()


def test_max_restarts_relaunches_on_exit_101(tmp_path):
    rc, logs, _ = _launch(tmp_path, "restart", "--max_restarts", "1")
    assert rc == 0
    for r in range(2):
        text = (logs / f"workerlog.{r}").read_text()
        assert "----- restart attempt 1 -----" in text
        assert f"WORKER_OK rank={r} attempt=1" in text
    rc, _, _ = _launch(tmp_path, "restart")
    assert rc == 101


def test_the_launcher_parses_the_jax_contract_flags():
    from paddle_tpu_torch.distributed.launch.main import _parse

    a = _parse(["--nproc_per_node", "4", "--backend", "nccl",
                "--max_restarts", "2", "train.py", "--lr", "0.1"])
    assert (a.nproc_per_node, a.backend, a.max_restarts) == (4, "nccl", 2)
    assert a.training_script_args == ["--lr", "0.1"]
    with pytest.raises(SystemExit):
        _parse(["--backend", "tpu", "x.py"])
