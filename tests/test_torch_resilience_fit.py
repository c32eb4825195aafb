"""The port's ``Model.fit(resume_from=)`` with ``CheckpointCallback``
against the JAX package's: ``tests/test_resilience.py``'s
``TestFitAutoResume`` on the port (a run killed at global step 6 and
relaunched from a different seed continues the uninterrupted loss curve;
an empty directory is a fresh start; the LR scheduler's and the
generators' states ride in the checkpoint), with the port's curves held
to the JAX package's at that file's 1e-5 / 1e-6 and the port's own
resume held bitwise.  A fit checkpoint written by either package resumes
in the other.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu.hapi import Callback as JCallback
from paddle_tpu.hapi import CheckpointCallback as JCheckpointCallback
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.io import Dataset as JDataset

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.hapi import Callback, CheckpointCallback, Model
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.resilience import (CheckpointManager, FaultSpec,
                                         SimulatedCrash, injected_faults)
from torch_eager_ref import carry

TOL = dict(rtol=1e-5, atol=1e-6)       # test_resilience.py's


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _toy_arrays(n=64, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, (n,)).astype(np.int64)
    x = (rng.randn(n, 8) * 0.3
         + y[:, None].astype(np.float32) * 2.0).astype(np.float32)
    return x, y


class _Toy(Dataset):
    def __init__(self):
        self.x, self.y = _toy_arrays()

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class _JToy(JDataset):
    def __init__(self):
        self.x, self.y = _toy_arrays()

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class _Losses(Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


class _JLosses(JCallback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


def _jax_net(seed=3):
    jpaddle.seed(seed)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 2))


def _jax_model(seed=3, lr=0.1):
    model = JModel(_jax_net(seed))
    opt = jpaddle.optimizer.Momentum(learning_rate=lr,
                                     parameters=model.parameters())
    model.prepare(opt, jnn.CrossEntropyLoss())
    return model


def _port_model(seed=3, lr=0.1, sched=None):
    """The port's model with the JAX model's weights of ``seed``."""
    paddle.set_device("cpu")
    paddle.seed(seed)
    net = carry(_jax_net(seed), nn.Sequential(nn.Linear(8, 16), nn.ReLU(),
                                              nn.Linear(16, 2)))
    model = Model(net)
    opt = paddle.optimizer.Momentum(learning_rate=sched or lr,
                                    parameters=model.parameters())
    model.prepare(opt, nn.CrossEntropyLoss())
    return model


def _fit(model, ckdir=None, resume=None, every=1, kill_at=None, **kw):
    rec = _Losses()
    cbs = [rec] + ([CheckpointCallback(ckdir, every_n_steps=every)]
                   if ckdir else [])
    args = dict(batch_size=16, epochs=2, shuffle=False, verbose=0,
                callbacks=cbs, resume_from=resume, **kw)
    if kill_at is None:
        model.fit(_Toy(), **args)
    else:
        with injected_faults(FaultSpec("hapi.train_step", "kill",
                                       occurrence=kill_at)):
            with pytest.raises(SimulatedCrash):
                model.fit(_Toy(), **args)
    return rec.losses


@pytest.fixture(scope="module")
def jax_ref():
    rec = _JLosses()
    _jax_model().fit(_JToy(), batch_size=16, epochs=2, shuffle=False,
                     verbose=0, callbacks=[rec])
    return rec.losses


@pytest.mark.faultinject
class TestFitAutoResume:
    def test_killed_run_resumes_with_matching_loss_curve(self, tmp_path,
                                                         jax_ref):
        ref = _fit(_port_model())
        assert len(ref) == 8
        np.testing.assert_allclose(ref, jax_ref, **TOL)
        ckdir = str(tmp_path / "ck")
        part_a = _fit(_port_model(), ckdir, kill_at=6)
        assert len(part_a) == 6
        # relaunch from another seed: the restore must overwrite it
        part_b = _fit(_port_model(seed=99), ckdir, resume=ckdir)
        assert len(part_b) == 2
        assert part_a + part_b == ref           # bitwise on the CPU

    def test_resume_from_empty_dir_is_fresh_start(self, tmp_path):
        hist = _port_model().fit(_Toy(), batch_size=16, epochs=1,
                                 shuffle=False, verbose=0,
                                 resume_from=str(tmp_path / "none"))
        assert len(hist) == 1

    def test_resume_restores_lr_scheduler_state(self, tmp_path):
        from paddle_tpu_torch.hapi.callbacks import LRScheduler as LRStepCB
        from paddle_tpu_torch.optimizer.lr import StepDecay

        class LRRecorder(Callback):
            def __init__(self):
                super().__init__()
                self.lrs = []

            def on_train_batch_end(self, step, logs=None):
                self.lrs.append(self.model._optimizer.get_lr())

        def run(seed, ckdir=None, resume=None, kill_at=None):
            sched = StepDecay(learning_rate=0.1, step_size=2, gamma=0.5)
            model = _port_model(seed, sched=sched)
            rec = LRRecorder()
            cbs = [rec, LRStepCB(by_step=True)]
            if ckdir:
                cbs.append(CheckpointCallback(ckdir, every_n_steps=1))
            args = dict(batch_size=16, epochs=2, shuffle=False, verbose=0,
                        callbacks=cbs, resume_from=resume)
            if kill_at:
                with injected_faults(FaultSpec("hapi.train_step", "kill",
                                               occurrence=kill_at)):
                    with pytest.raises(SimulatedCrash):
                        model.fit(_Toy(), **args)
            else:
                model.fit(_Toy(), **args)
            return rec.lrs, sched

        ref_lrs, _ = run(3)
        assert len(ref_lrs) == 8 and len(set(ref_lrs)) > 2
        ckdir = str(tmp_path / "ck")
        run(3, ckdir=ckdir, kill_at=6)
        lrs_b, sched_b = run(99, ckdir=ckdir, resume=ckdir)
        assert sched_b.last_epoch == 8
        assert lrs_b == ref_lrs[6:]

    def test_resume_restores_the_generators(self, tmp_path):
        """The checkpoint carries each device generator's state: draws
        after a restore continue the saved stream, not a fresh seed's."""
        from paddle_tpu_torch.core.random import generator
        from paddle_tpu_torch.hapi.callbacks import (_pack_fit_state,
                                                     restore_fit_state)

        mgr = CheckpointManager(str(tmp_path))
        model = _port_model()
        paddle.seed(7)
        gen = generator("cpu")
        torch.rand(3, generator=gen)
        tree, counters = _pack_fit_state(model)
        expected = torch.rand(4, generator=gen)
        mgr.save(tree, step=1, extra={"rng_counters": counters, "epoch": 0,
                                      "next_step": 0, "global_step": 1})
        paddle.seed(12345)
        torch.rand(9, generator=gen)
        info = restore_fit_state(model, mgr)
        assert info["global_step"] == 1
        assert torch.equal(torch.rand(4, generator=gen), expected)

    def test_restore_writes_in_place(self, tmp_path):
        """A restore copies into the live parameters and slots (what the
        captured step reads): their storage does not move."""
        ckdir = str(tmp_path / "ck")
        model = _port_model()
        _fit(model, ckdir, every=4)
        ptrs = [p.data_ptr() for p in model.parameters()]
        slots = [t.data_ptr() for s in model._opt_state["slots"].values()
                 for t in s.values()]
        from paddle_tpu_torch.hapi.callbacks import restore_fit_state

        assert restore_fit_state(model, ckdir)["global_step"] == 8
        assert ptrs == [p.data_ptr() for p in model.parameters()]
        assert slots == [t.data_ptr() for s in
                         model._opt_state["slots"].values()
                         for t in s.values()]


@pytest.mark.faultinject
class TestFitCheckpointsCrossPackages:
    def test_jax_checkpoint_resumes_in_port(self, tmp_path, jax_ref):
        ckdir = str(tmp_path / "ck")
        rec = _JLosses()
        with jpaddle.resilience.injected_faults(
                jpaddle.resilience.FaultSpec("hapi.train_step", "kill",
                                             occurrence=6)):
            with pytest.raises(jpaddle.resilience.SimulatedCrash):
                _jax_model().fit(
                    _JToy(), batch_size=16, epochs=2, shuffle=False,
                    verbose=0, callbacks=[
                        rec, JCheckpointCallback(ckdir, every_n_steps=1)])
        part_b = _fit(_port_model(seed=99), ckdir, resume=ckdir)
        assert len(part_b) == 2
        np.testing.assert_allclose(rec.losses + part_b, jax_ref, **TOL)

    def test_port_checkpoint_resumes_in_jax(self, tmp_path, jax_ref):
        ckdir = str(tmp_path / "ck")
        part_a = _fit(_port_model(), ckdir, kill_at=6)
        rec = _JLosses()
        _jax_model(seed=99).fit(
            _JToy(), batch_size=16, epochs=2, shuffle=False, verbose=0,
            callbacks=[rec, JCheckpointCallback(ckdir, every_n_steps=1)],
            resume_from=ckdir)
        assert len(rec.losses) == 2
        np.testing.assert_allclose(part_a + rec.losses, jax_ref, **TOL)
