"""The port's optimizers, clips and LR schedulers against the JAX
package's: each optimizer over 5 steps of ``apply_gradients`` (the path
of hapi's step) on the same named parameters and seeded gradients, the
eager ``step`` with its per-parameter learning rate and fp32 masters,
the state-dict keys, and each scheduler's values over 50 steps.  fp32
parameters and slots at 1e-5 (atol and rtol); learning rates exactly."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu.core.tensor import Parameter as JParameter

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn as tnn
from torch_eager_ref import rand

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = {"w": (4, 3), "b": (3,), "v": (5,)}

OPTS = [
    ("SGD", dict(learning_rate=0.1)),
    ("SGD", dict(learning_rate=0.1, weight_decay=0.01)),
    ("Momentum", dict(learning_rate=0.1, momentum=0.9)),
    ("Momentum", dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)),
    ("Momentum", dict(learning_rate=0.05, momentum=0.8, use_nesterov=True)),
    ("Adagrad", dict(learning_rate=0.1, initial_accumulator_value=0.1)),
    ("RMSProp", dict(learning_rate=0.01)),
    ("RMSProp", dict(learning_rate=0.01, momentum=0.9, centered=True)),
    ("Adam", dict(learning_rate=0.01)),
    ("Adam", dict(learning_rate=0.01, weight_decay=0.01)),
    ("AdamW", dict(learning_rate=0.01, weight_decay=0.1)),
    ("Lamb", dict(learning_rate=0.01)),
    ("Adadelta", dict(learning_rate=1.0)),
    ("Adamax", dict(learning_rate=0.01)),
    ("Momentum", dict(learning_rate=0.1, grad_clip="global")),
    ("Adam", dict(learning_rate=0.01, grad_clip="norm")),
    ("SGD", dict(learning_rate=0.1, grad_clip="value")),
]


def _clip(pkg, kind):
    return {"global": lambda: pkg.optimizer.ClipGradByGlobalNorm(0.5),
            "norm": lambda: pkg.optimizer.ClipGradByNorm(0.3),
            "value": lambda: pkg.optimizer.ClipGradByValue(0.2)}[kind]()


def _make(pkg, name, kw):
    kw = dict(kw)
    if "grad_clip" in kw:
        kw["grad_clip"] = _clip(pkg, kw["grad_clip"])
    return getattr(pkg.optimizer, name)(**kw)


@pytest.mark.parametrize("name,kw", OPTS, ids=lambda v: str(v))
def test_apply_gradients_five_steps(name, kw):
    jopt, topt = _make(jpaddle, name, kw), _make(tpaddle, name, kw)
    jp = {k: jnp.asarray(rand(s, i)) for i, (k, s) in enumerate(
        SHAPES.items())}
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    jstate, tstate = jopt.init_state(jp), topt.init_state(tp)
    for step in range(5):
        g = {k: rand(s, 10 * step + i) for i, (k, s) in enumerate(
            SHAPES.items())}
        jp, jstate = jopt.apply_gradients(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        tstate = topt.apply_gradients(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
    assert tstate["step"] == int(jstate["step"]) == 5
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   err_msg=k, **TOL)
        assert sorted(tstate["slots"][k]) == sorted(jstate["slots"][k])
        for sname, v in jstate["slots"][k].items():
            np.testing.assert_allclose(tstate["slots"][k][sname].numpy(),
                                       np.asarray(v), err_msg=sname, **TOL)


def _eager_pair(name, kw, lr_mult=1.0, dtype="float32"):
    vals = [rand(s, i) for i, s in enumerate(SHAPES.values())]
    jparams = [JParameter(jnp.asarray(v).astype(dtype)) for v in vals]
    tparams = [tnn.Parameter(torch.from_numpy(v).to(
        tpaddle.core.convert_dtype(dtype))) for v in vals]
    jparams[0].optimize_attr["learning_rate"] = lr_mult
    tparams[0].optimize_attr["learning_rate"] = lr_mult
    jopt = getattr(jpaddle.optimizer, name)(parameters=jparams, **kw)
    topt = getattr(tpaddle.optimizer, name)(parameters=tparams, **kw)
    for step in range(3):
        for i, (jp_, tp_) in enumerate(zip(jparams, tparams)):
            g = rand(tuple(jp_.shape), 100 + 10 * step + i)
            jp_.grad = jpaddle.Tensor(jnp.asarray(g).astype(dtype))
            tp_.grad = torch.from_numpy(g).to(tp_.dtype)
        jopt.step()
        topt.step()
    return jparams, tparams, jopt, topt


@pytest.mark.parametrize("name,kw", [
    ("Momentum", dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-3)),
    ("Adam", dict(learning_rate=0.01)),
    ("AdamW", dict(learning_rate=0.01, weight_decay=0.1))], ids=str)
def test_eager_step_honours_parameter_learning_rate(name, kw):
    jparams, tparams, jopt, topt = _eager_pair(name, kw, lr_mult=0.5)
    for jp_, tp_ in zip(jparams, tparams):
        np.testing.assert_allclose(tp_.detach().numpy(),
                                   np.asarray(jp_.data), **TOL)
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    assert sorted(tsd) == sorted(jsd) and tsd["step"] == jsd["step"] == 3
    for k, v in jsd.items():
        if k != "step":
            np.testing.assert_allclose(tsd[k].numpy(), np.asarray(v.data),
                                       err_msg=k, **TOL)


def test_eager_multi_precision_masters():
    """bf16 parameters with fp32 masters: the masters after three Adam
    steps equal JAX's at fp32 1e-5, the bf16 parameters are the masters
    rounded."""
    jparams, tparams, jopt, topt = _eager_pair(
        "Adam", dict(learning_rate=0.01, multi_precision=True),
        dtype="bfloat16")
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    masters = [k for k in jsd if k.endswith(".master")]
    assert len(masters) == 3 and sorted(tsd) == sorted(jsd)
    for k in masters:
        np.testing.assert_allclose(tsd[k].numpy(), np.asarray(jsd[k].data),
                                   err_msg=k, **TOL)
    for tp_, k in zip(tparams, sorted(masters)):
        assert tp_.dtype == torch.bfloat16
        assert torch.equal(tp_.detach(), tsd[k].bfloat16())


def test_optimizer_state_dict_round_trip_and_jax_keys():
    _, tparams, jopt, topt = _eager_pair("Momentum", dict(
        learning_rate=0.1, momentum=0.9))
    sd = topt.state_dict()
    assert sorted(sd) == sorted(jopt.state_dict())
    fresh = tpaddle.optimizer.Momentum(0.1, 0.9, parameters=tparams)
    fresh.set_state_dict({k: (np.asarray(v.data) if hasattr(v, "data") and
                              not isinstance(v, torch.Tensor) else v)
                          for k, v in jopt.state_dict().items()})
    for k, v in fresh.state_dict().items():
        if k != "step":
            np.testing.assert_allclose(v.numpy(), sd[k].numpy(), **TOL)
    assert fresh.state_dict()["step"] == 3


def test_minimize_and_clear_grad():
    w = tnn.Parameter(torch.ones(3))
    opt = tpaddle.optimizer.SGD(0.5, parameters=[w])
    opt.minimize((w * torch.tensor([1.0, 2.0, 3.0])).sum())
    assert torch.allclose(w.detach(), torch.tensor([0.5, 0.0, -0.5]))
    assert w.grad is None
    frozen = tnn.Parameter(torch.ones(2), requires_grad=False)
    opt = tpaddle.optimizer.SGD(0.5, parameters=[frozen])
    opt.step()
    assert torch.equal(frozen.detach(), torch.ones(2))


SCHEDULERS = [
    ("NoamDecay", dict(d_model=64, warmup_steps=10)),
    ("PiecewiseDecay", dict(boundaries=[5, 20], values=[0.1, 0.05, 0.01])),
    ("NaturalExpDecay", dict(learning_rate=0.1, gamma=0.05)),
    ("InverseTimeDecay", dict(learning_rate=0.1, gamma=0.1)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=20)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=15, cycle=True,
                             power=2.0)),
    ("LinearWarmup", dict(learning_rate=0.1, warmup_steps=10, start_lr=0.0,
                          end_lr=0.1)),
    ("LinearWarmup", dict(learning_rate="inner", warmup_steps=5,
                          start_lr=0.01, end_lr=0.1)),
    ("ExponentialDecay", dict(learning_rate=0.1, gamma=0.9)),
    ("MultiStepDecay", dict(learning_rate=0.1, milestones=[10, 30])),
    ("StepDecay", dict(learning_rate=0.1, step_size=7)),
    ("LambdaDecay", dict(learning_rate=0.1, lr_lambda="lambda")),
    ("MultiplicativeDecay", dict(learning_rate=0.1, lr_lambda="lambda")),
    ("CosineAnnealingDecay", dict(learning_rate=0.1, T_max=20)),
    ("OneCycleLR", dict(max_learning_rate=0.1, total_steps=40)),
    ("OneCycleLR", dict(max_learning_rate=0.1, total_steps=40,
                        anneal_strategy="linear")),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=6)),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=4, mode="triangular2")),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=4, mode="exp_range", gamma=0.95)),
    ("ReduceOnPlateau", dict(learning_rate=0.1, patience=2, cooldown=1)),
]


def _sched(pkg, name, kw):
    kw = dict(kw)
    if kw.get("lr_lambda") == "lambda":
        kw["lr_lambda"] = lambda e: 0.95 ** (e % 7)
    if kw.get("learning_rate") == "inner":
        kw["learning_rate"] = pkg.optimizer.lr.CosineAnnealingDecay(0.1, 30)
    return getattr(pkg.optimizer.lr, name)(**kw)


@pytest.mark.parametrize("name,kw", SCHEDULERS, ids=lambda v: str(v))
def test_scheduler_values_over_50_steps(name, kw):
    js, ts = _sched(jpaddle, name, kw), _sched(tpaddle, name, kw)
    jv, tv = [], []
    for step in range(50):
        metric = 1.0 / (1 + step % 9)
        jv.append(js())
        tv.append(ts())
        if name == "ReduceOnPlateau":
            js.step(metric)
            ts.step(metric)
        else:
            js.step()
            ts.step()
    assert tv == jv
    assert all(math.isfinite(v) for v in tv)
    assert ts.state_dict().keys() == js.state_dict().keys()


def test_optimizer_takes_a_scheduler():
    sched = tpaddle.optimizer.lr.StepDecay(0.1, step_size=2)
    w = tnn.Parameter(torch.ones(2))
    opt = tpaddle.optimizer.SGD(sched, parameters=[w])
    assert opt.get_lr() == 0.1
    sched.step()
    sched.step()
    assert opt.get_lr() == pytest.approx(0.01)
    assert "LR_Scheduler" in opt.state_dict()
    with pytest.raises(RuntimeError):
        opt.set_lr(0.3)


@pytest.mark.parametrize("kind", ["global", "norm", "value"])
def test_clips(kind):
    gs = [rand((4, 3), 0, 3.0), rand((5,), 1, 3.0)]
    jout = _clip(jpaddle, kind)([jnp.asarray(g) for g in gs])
    tout = _clip(tpaddle, kind)([torch.from_numpy(g) for g in gs])
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
