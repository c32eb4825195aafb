"""The port's ``TrainingSupervisor`` (``resilience.supervisor``):
``tests/test_supervisor.py``'s ``TestSupervisorRelaunch`` (clean exit,
a relaunch on ``ELASTIC_EXIT_CODE`` with the resume contract, the restart
budget, a relaunch that itself dies at ``supervisor.spawn``),
``TestSupervisorElastic`` (a store outage during rendezvous retried, a
lost node terminating the trainer and relaunching once the replacement
rendezvouses, over the port's ``ElasticManager`` and ``TCPStore``),
``TestSupervisorEndToEnd`` (a hapi trainer on the port, killed mid-epoch
and killed again during its recovery run, relaunched with no operator
action: the assembled loss curve equals the uninterrupted run's bit for
bit), and ``tests/test_distributed_flight.py``'s hang escalation (a
wedged child bundled and relaunched, ``on_hang="restart"``, an unknown
policy refused), on the CPU.
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed.fleet.elastic import \
    ELASTIC_EXIT_CODE as JAX_ELASTIC_EXIT_CODE
from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.observability import default_registry
from paddle_tpu_torch.resilience import (FaultSpec, TrainingSupervisor,
                                         injected_faults)
from paddle_tpu_torch.resilience.supervisor import ELASTIC_EXIT_CODE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _restarts(reason):
    fam = default_registry().get("supervisor_restarts_total")
    return fam.labels(reason=reason).value if fam else 0


def _script(tmp_path, body):
    p = tmp_path / "child.py"
    p.write_text("import os, sys\n"
                 "attempt = int(os.environ.get("
                 "'PADDLE_RESTART_ATTEMPT', '0'))\n" + body)
    return [sys.executable, str(p)]


class TestSupervisorRelaunch:
    def test_elastic_exit_code_is_the_jax_packages(self):
        assert ELASTIC_EXIT_CODE == JAX_ELASTIC_EXIT_CODE

    def test_clean_exit_passthrough(self, tmp_path):
        sup = TrainingSupervisor(_script(tmp_path, "sys.exit(0)\n"),
                                 max_restarts=3, backoff_base=0.01)
        assert sup.run() == 0
        assert sup.restarts == []

    def test_elastic_exit_relaunches_and_resumes(self, tmp_path):
        before = _restarts("elastic_exit")
        body = (
            "assert os.environ['PADDLE_ELASTIC_RESUME_DIR'] == "
            f"{str(tmp_path / 'ck')!r}\n"
            "with open(os.path.join("
            f"{str(tmp_path)!r}, 'runs.log'), 'a') as f:\n"
            "    f.write(f'attempt={attempt}\\n')\n"
            f"sys.exit({ELASTIC_EXIT_CODE} if attempt == 0 else 0)\n")
        sup = TrainingSupervisor(_script(tmp_path, body),
                                 checkpoint_dir=str(tmp_path / "ck"),
                                 max_restarts=2, backoff_base=0.01,
                                 backoff_cap=0.02)
        assert sup.run() == 0
        assert sup.restarts == [("elastic_exit", 1)]
        assert _restarts("elastic_exit") == before + 1
        assert (tmp_path / "runs.log").read_text().splitlines() == \
            ["attempt=0", "attempt=1"]

    def test_restart_budget_exhaustion_propagates_code(self, tmp_path):
        sup = TrainingSupervisor(_script(tmp_path, "sys.exit(3)\n"),
                                 max_restarts=2, backoff_base=0.01,
                                 backoff_cap=0.02)
        assert sup.run() == 3
        assert [r for r, _ in sup.restarts] == ["crash", "crash"]

    @pytest.mark.faultinject
    def test_kill_during_relaunch_survived(self, tmp_path):
        before = _restarts("spawn_failed")
        body = ("with open(os.path.join("
                f"{str(tmp_path)!r}, 'runs.log'), 'a') as f:\n"
                "    f.write(f'attempt={attempt}\\n')\n"
                "sys.exit(7 if attempt == 0 else 0)\n")
        sup = TrainingSupervisor(_script(tmp_path, body), max_restarts=3,
                                 backoff_base=0.01, backoff_cap=0.02)
        with injected_faults(FaultSpec("supervisor.spawn", "io_error",
                                       occurrence=2)):
            assert sup.run() == 0
        assert [r for r, _ in sup.restarts] == ["crash", "spawn_failed"]
        assert _restarts("spawn_failed") == before + 1
        assert (tmp_path / "runs.log").read_text().splitlines() == \
            ["attempt=0", "attempt=2"]

    def test_unported_options_raise(self):
        # elastic= and hang_watchdog= are taken now (TestSupervisorElastic,
        # TestSupervisorHangEscalation); what still raises is an unknown
        # on_hang policy, as in the JAX package
        sup = TrainingSupervisor(["true"], elastic=object(), hosts=["a"],
                                 hang_watchdog=object())
        assert sup.hosts == ["a"] and sup.on_hang == "bundle+restart"
        with pytest.raises(ValueError, match="on_hang"):
            TrainingSupervisor(["true"], on_hang="page-someone")


def _mgr(store, host, np_=1, **kw):
    kw.setdefault("heartbeat_interval", 0.1)
    kw.setdefault("node_timeout", 0.4)
    return ElasticManager(store, job_id="sup", np=np_, host=host, **kw)


class TestSupervisorElastic:
    @pytest.mark.faultinject
    def test_store_outage_during_rendezvous_retried(self, tmp_path):
        store = TCPStore(is_master=True, world_size=1)
        sup = TrainingSupervisor(
            _script(tmp_path, "sys.exit(0)\n"),
            elastic=_mgr(store, "me"), hosts=["me"], max_restarts=1,
            backoff_base=0.01, backoff_cap=0.02, rendezvous_timeout=20.0)
        with injected_faults(FaultSpec("supervisor.rendezvous", "io_error",
                                       occurrence=1)):
            assert sup.run() == 0

    def test_lost_node_terminates_and_relaunches(self, tmp_path):
        store = TCPStore(is_master=True, world_size=2)
        peer = _mgr(store, "peer", np_=2)
        peer.register()
        before = _restarts("lost_node")
        body = ("import time\n"
                "time.sleep(60 if attempt == 0 else 0)\n"
                "sys.exit(0)\n")
        sup = TrainingSupervisor(
            _script(tmp_path, body), elastic=_mgr(store, "me", np_=2),
            hosts=["me", "peer"], max_restarts=1, backoff_base=0.01,
            backoff_cap=0.02, membership_interval=0.1,
            rendezvous_timeout=30.0, term_grace_s=5.0)
        holder = {}

        def chaos():
            time.sleep(1.8)
            peer.deregister()
            time.sleep(1.0)
            holder["peer2"] = _mgr(store, "peer", np_=2).register()

        t = threading.Thread(target=chaos, daemon=True)
        t.start()
        try:
            assert sup.run() == 0
        finally:
            t.join()
            holder["peer2"].deregister()
        assert [r for r, _ in sup.restarts] == ["lost_node"]
        assert _restarts("lost_node") == before + 1


class _StubWatchdog:
    def __init__(self):
        self.hang_active = False
        self.bundle_reasons = []
        self.resets = 0

    def check(self):
        return self.hang_active

    def write_bundle(self, reason="hang"):
        self.bundle_reasons.append(reason)
        return "stub-bundle"

    def reset(self):
        self.resets += 1
        self.hang_active = False


class TestSupervisorHangEscalation:
    HUNG = ("import time\n"
            "time.sleep(60 if attempt == 0 else 0)\n"
            "sys.exit(0)\n")

    @pytest.mark.parametrize("policy", ["bundle+restart", "restart"])
    def test_hung_child_relaunched(self, tmp_path, policy):
        before = _restarts("hang")
        stub = _StubWatchdog()
        sup = TrainingSupervisor(
            _script(tmp_path, self.HUNG), max_restarts=1, backoff_base=0.01,
            backoff_cap=0.02, membership_interval=0.05, term_grace_s=5.0,
            hang_watchdog=stub, on_hang=policy)

        def trip():
            time.sleep(0.5)
            stub.hang_active = True

        t = threading.Thread(target=trip, daemon=True)
        t.start()
        assert sup.run() == 0
        t.join()
        assert [r for r, _ in sup.restarts] == ["hang"]
        assert stub.bundle_reasons == (
            ["supervisor_hang"] if policy == "bundle+restart" else [])
        assert stub.resets == 1
        assert _restarts("hang") == before + 1

    def test_broken_watchdog_does_not_kill_a_healthy_child(self, tmp_path):
        class Broken(_StubWatchdog):
            def check(self):
                raise RuntimeError("store gone")

        sup = TrainingSupervisor(
            _script(tmp_path, "import time\ntime.sleep(0.5)\n"
                    "sys.exit(0)\n"), max_restarts=0,
            membership_interval=0.05, hang_watchdog=Broken())
        assert sup.run() == 0 and sup.restarts == []


# A hapi trainer on the port: 2 epochs x 4 steps of the toy problem, a
# CheckpointCallback every step, fit(resume_from=<the supervisor's
# contract>).  Attempts 0 and 1 install a kill fault (the second DURING
# the recovery run); attempt 2 runs clean.  Each completed step appends
# "global_step repr(loss)" to the loss log.
E2E_TRAINER = """
import os, sys
import numpy as np
import torch
import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.hapi import Callback, CheckpointCallback, Model
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.resilience import FaultInjector, FaultSpec, install

torch.set_num_threads(1)
paddle.set_device("cpu")
attempt = int(os.environ.get("PADDLE_RESTART_ATTEMPT", "0"))
resume = os.environ.get("PADDLE_ELASTIC_RESUME_DIR")
KILLS = {0: 6, 1: 1}    # attempt -> hapi.train_step kill occurrence
if attempt in KILLS:
    install(FaultInjector([FaultSpec("hapi.train_step", "kill",
                                     occurrence=KILLS[attempt])]))

class Toy(Dataset):
    def __init__(self, n=64, seed=0):
        rng = np.random.RandomState(seed)
        self.y = rng.randint(0, 2, (n,)).astype(np.int64)
        self.x = (rng.randn(n, 8) * 0.3 +
                  self.y[:, None].astype(np.float32) * 2.0
                  ).astype(np.float32)
    def __len__(self):
        return len(self.x)
    def __getitem__(self, i):
        return self.x[i], self.y[i]

class Rec(Callback):
    def __init__(self, path):
        super().__init__()
        self.path = path
        self.gstep = 0
    def on_train_begin(self, logs=None):
        info = getattr(self.model, "_resume_info", None) or {}
        self.gstep = int(info.get("global_step", 0))
    def on_train_batch_end(self, step, logs=None):
        self.gstep += 1
        with open(self.path, "a") as f:
            f.write(f"{self.gstep} {logs['loss']!r}\\n")
            f.flush()

paddle.seed(3 if attempt in (0, 99) else 1000 + attempt)
net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 2))
model = Model(net)
opt = paddle.optimizer.Momentum(learning_rate=0.1,
                                parameters=model.parameters())
model.prepare(opt, nn.CrossEntropyLoss())
cbs = [Rec(os.environ["E2E_LOSS_LOG"])]
if resume:
    cbs.append(CheckpointCallback(resume, every_n_steps=1))
model.fit(Toy(), batch_size=16, epochs=2, shuffle=False, verbose=0,
          callbacks=cbs, resume_from=resume)
"""


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "XLA_", "JAX_"))}
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def _read_losses(path):
    out = {}
    with open(path) as f:
        for line in f:
            gstep, loss = line.split(" ", 1)
            out[int(gstep)] = float(loss)
    return out


@pytest.mark.faultinject
class TestSupervisorEndToEnd:
    def test_killed_trainer_resumes_bitwise(self, tmp_path):
        """Relaunches re-seed from another value, so only the restore
        can make their steps match."""
        script = tmp_path / "trainer.py"
        script.write_text(E2E_TRAINER)
        ref_log = tmp_path / "ref.log"
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=REPO, timeout=300,
            env=_clean_env(E2E_LOSS_LOG=str(ref_log),
                           PADDLE_RESTART_ATTEMPT="99",
                           PADDLE_ELASTIC_RESUME_DIR=str(
                               tmp_path / "ck_ref")),
            capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-2000:]
        ref = _read_losses(ref_log)
        assert sorted(ref) == list(range(1, 9))

        loss_log = tmp_path / "sup.log"
        sup = TrainingSupervisor(
            [sys.executable, str(script)],
            checkpoint_dir=str(tmp_path / "ck"), max_restarts=3,
            backoff_base=0.01, backoff_cap=0.05,
            env=_clean_env(E2E_LOSS_LOG=str(loss_log)),
            log_path=str(tmp_path / "sup_child.log"))
        assert sup.run() == 0
        assert [r for r, _ in sup.restarts] == ["crash", "crash"]
        got = _read_losses(loss_log)
        assert sorted(got) == list(range(1, 9))
        np.testing.assert_array_equal(
            np.asarray([got[s] for s in range(1, 9)]),
            np.asarray([ref[s] for s in range(1, 9)]))
        assert sup._resume_step() == 8
