"""The port's elastic manager (``distributed/fleet/elastic.py``) over the
port's ``TCPStore``, mirroring ``tests/test_elastic.py``: register and
probe, a lost node seen by ``watch``, a stale heartbeat counting as dead
on the reader's clock, a relaunch not fooled by a crashed peer's stale
counter, a never-registered host, and the launcher's relaunch
(``python -m paddle_tpu_torch.distributed.launch --max_restarts``) on
``ELASTIC_EXIT_CODE``, the one constant the JAX package also uses."""
import importlib
import os
import subprocess
import sys
import time

from paddle_tpu.distributed.fleet.elastic import \
    ELASTIC_EXIT_CODE as JAX_ELASTIC_EXIT_CODE
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.elastic import (ELASTIC_EXIT_CODE,
                                                        ElasticManager,
                                                        enable_elastic)
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.resilience import supervisor

launch_main = importlib.import_module(
    "paddle_tpu_torch.distributed.launch.main")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_one_exit_code_everywhere():
    assert ELASTIC_EXIT_CODE == JAX_ELASTIC_EXIT_CODE == 101
    assert launch_main.ELASTIC_EXIT_CODE is ELASTIC_EXIT_CODE
    assert supervisor.ELASTIC_EXIT_CODE is ELASTIC_EXIT_CODE
    assert fleet.ElasticManager is ElasticManager


def test_enable_elastic_reads_the_env(monkeypatch):
    monkeypatch.delenv("PADDLE_ELASTIC_NP", raising=False)
    assert not enable_elastic()
    monkeypatch.setenv("PADDLE_ELASTIC_NP", "2")
    assert enable_elastic()


def test_register_and_probe():
    store = TCPStore(is_master=True, world_size=2)
    a = ElasticManager(store, job_id="j1", np=2, host="nodeA",
                       heartbeat_interval=0.1, node_timeout=0.5)
    b = ElasticManager(store, job_id="j1", np=2, host="nodeB",
                       heartbeat_interval=0.1, node_timeout=0.5)
    a.register()
    b.register()
    assert a.probe("nodeA") and a.probe("nodeB")
    assert a.match(["nodeA", "nodeB"])
    a.deregister()
    b.deregister()


def test_watch_detects_lost_node():
    store = TCPStore(is_master=True, world_size=2)
    a = ElasticManager(store, job_id="j2", np=2, host="nodeA",
                       heartbeat_interval=0.1, node_timeout=0.4)
    b = ElasticManager(store, job_id="j2", np=2, host="nodeB",
                       heartbeat_interval=0.1, node_timeout=0.4)
    a.register()
    b.register()
    assert a.wait_for_np(["nodeA", "nodeB"], timeout=5)
    b.deregister()
    assert a.watch(["nodeA", "nodeB"], timeout=5) == ("lost", ["nodeB"])
    a.deregister()


def test_stale_heartbeat_counts_as_dead():
    store = TCPStore(is_master=True, world_size=1)
    a = ElasticManager(store, job_id="j3", np=1, host="nodeA",
                       heartbeat_interval=10.0, node_timeout=0.3)
    store.add("elastic/j3/nodeA", 1)
    assert a.probe("nodeA")
    time.sleep(0.4)
    assert not a.probe("nodeA")


def test_relaunch_not_fooled_by_stale_counter():
    store = TCPStore(is_master=True, world_size=2)
    store.add("elastic/j5/deadB", 1)
    live = ElasticManager(store, job_id="j5", np=2, host="nodeA",
                          heartbeat_interval=0.1, node_timeout=0.3)
    live.register()
    fresh = ElasticManager(store, job_id="j5", np=2, host="nodeA",
                           heartbeat_interval=0.1, node_timeout=0.3)
    assert not fresh.wait_for_np(["nodeA", "deadB"], timeout=1.5)
    live.deregister()


def test_never_registered_is_dead():
    store = TCPStore(is_master=True, world_size=1)
    a = ElasticManager(store, job_id="j4", np=1, host="nodeA",
                       heartbeat_interval=0.1, node_timeout=0.5)
    assert not a.probe("ghost")
    store.set("elastic/j4/junk", b"not a counter")
    assert not a.probe("junk")


WORKER = """
import os, sys
attempt = int(os.environ["PADDLE_RESTART_ATTEMPT"])
rank = int(os.environ["PADDLE_TRAINER_ID"])
print(f"run rank={{rank}} attempt={{attempt}}")
if attempt == 0 and rank == 1:
    sys.exit({code})
print(f"DONE rank={{rank}} attempt={{attempt}}")
"""


def _launch(tmp_path, max_restarts, code):
    script = tmp_path / "w.py"
    script.write_text(WORKER.format(code=code))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "XLA_", "JAX_"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--max_restarts", str(max_restarts),
         "--log_dir", str(tmp_path / "logs"), str(script)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    logs = {f.name: f.read_text()
            for f in sorted((tmp_path / "logs").iterdir())}
    return proc, logs


def test_launcher_relaunches_after_elastic_exit(tmp_path):
    proc, logs = _launch(tmp_path, 1, ELASTIC_EXIT_CODE)
    assert proc.returncode == 0, (proc.stdout, proc.stderr, logs)
    assert "restart attempt 1" in logs["workerlog.1"]
    assert "DONE rank=1 attempt=1" in logs["workerlog.1"]
    assert "DONE rank=0 attempt=1" in logs["workerlog.0"]


def test_launcher_without_budget_fails_with_the_code(tmp_path):
    proc, _ = _launch(tmp_path, 0, ELASTIC_EXIT_CODE)
    assert proc.returncode == ELASTIC_EXIT_CODE
