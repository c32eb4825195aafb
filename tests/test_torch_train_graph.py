"""The training steps' graph route, held on the CPU: what ``HybridEngine``
and hapi's ``train_batch``/``eval_batch`` capture on the card runs here
eagerly through the same watched call, and must

- match the JAX package with the learning rate and the step read from
  device scalars: the engine over 3 steps at a learning rate that
  changes every step (accumulation, a binding clip, bf16 slots, the
  sep = 2 ring and MoE), a state carried over from JAX at step 5, and
  all nine optimizers through ``train_batch`` under a scheduler that
  changes the learning rate every step, each slot updated in place;
- make no host sync in a step body (``item``, ``__float__``, ``__int__``,
  ``__bool__``, ``tolist``, ``nonzero`` and ``numpy`` raise while it
  runs): on the card such a sync would break the capture;
- fold dropout seeds on the device bit for bit as ``_fold`` does on the
  host, with masks that change from step to step, repeat under
  recompute and keep 1 − rate of the elements;
- show in the compile watchdog as ``hybrid_engine::step``,
  ``hapi::train_step`` and ``hapi::eval_step``, one build each, and a
  new batch shape as a rebuild naming the argument.

``tiny`` fp32 throughout; parameters cross with ``params_from_jax`` /
``opt_from_jax`` and the eager layers' weights with ``carry``; batches
come from numpy seeds.  Tolerances are stated at each comparison."""
import contextlib
import dataclasses
import logging
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu.distributed.engine import EngineConfig as JaxEngineConfig
from paddle_tpu.distributed.engine import HybridEngine as JaxEngine
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.models.gpt import GPT_CONFIGS as JAX_CONFIGS
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.distributed import EngineConfig, HybridEngine
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import (GPT_CONFIGS, GPTConfig, gpt_init,
                                     gpt_loss, opt_from_jax,
                                     params_from_jax, params_to_numpy)
from paddle_tpu_torch.models.gpt import _dropout, _fold
from paddle_tpu_torch.observability import watchdog_enabled
from torch_eager_ref import pair

torch.set_num_threads(1)

LOGGER = "paddle_tpu_torch.observability"
# the engine's lr, step by step.  (1e-3, 5e-4, ...) would leave the MoE
# case one token whose 2nd and 3rd gate probabilities lie 1e-7 apart at
# step 3, which summation order routes apart between JAX and the port
# (``test_torch_moe.py`` holds the routing itself)
LRS = (1e-3, 2e-3, 5e-4)
MOE = dict(moe_experts=4, moe_capacity_factor=1.0)
RING = dict(vocab_size=256, max_seq_len=512, hidden=64, num_layers=2,
            num_heads=2, ffn_hidden=128, dtype="float32",
            seq_parallel="ring")
# case -> (JAX config, port config, engine kwargs, sep, batch S)
ENGINE_CASES = {
    "accum2": ({}, dict(accum_steps=2), 1, 64),
    "clip_binds": ({}, dict(grad_clip=0.05), 1, 64),
    "bf16_slots": ({}, dict(opt_dtype="bfloat16"), 1, 64),
    "ring_sep2": (RING, {}, 2, 256),
    "moe": (MOE, {}, 1, 64),
}


def _configs(kw):
    if "seq_parallel" in kw:
        return JaxGPTConfig(**kw), GPTConfig(**kw)
    return (dataclasses.replace(JAX_CONFIGS["tiny"], dtype="float32", **kw),
            dataclasses.replace(GPT_CONFIGS["tiny"], dtype="float32", **kw))


def _batch(vocab, B=4, S=64, seed=5):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100)],
                            axis=1).astype(np.int32)
    labels[1, :5] = -100
    return tokens, labels


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np(tree):
    return _flat(jax.tree_util.tree_map(np.asarray, tree))


# ------------------------------------------------------- no host sync

_SYNCS = ("item", "__float__", "__int__", "__bool__", "tolist", "nonzero",
          "numpy")


@contextlib.contextmanager
def no_host_sync():
    """Every ``torch.Tensor`` method that reads a value back to the host
    raises while the block runs."""
    saved = {name: getattr(torch.Tensor, name) for name in _SYNCS}

    def refuse(name):
        def method(*args, **kwargs):
            raise AssertionError(f"host sync in a step body: "
                                 f"Tensor.{name}")
        return method

    for name in _SYNCS:
        setattr(torch.Tensor, name, refuse(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def test_no_host_sync_guard_refuses_each_read():
    t = torch.ones(3)
    with no_host_sync():
        for read in (lambda: t[0].item(), lambda: float(t[0]),
                     lambda: int(t[0]), lambda: bool(t[0]),
                     lambda: t.tolist(), lambda: t.nonzero(),
                     lambda: t.numpy()):
            with pytest.raises(AssertionError, match="host sync"):
                read()
    assert t.sum().item() == 3.0


# ------------------------------------------------- the engine against JAX


def _run_jax(jeng, jp, jo, tokens, labels, lrs):
    losses = []
    for lr in lrs:
        jp, jo, loss = jeng.step(jp, jo, tokens, labels, lr=lr)
        losses.append(float(loss))
    return jp, jo, losses


@pytest.fixture(scope="module", params=sorted(ENGINE_CASES))
def engine_runs(request):
    """3 steps of the JAX engine and the port's from the same params,
    Adam state and batch, at ``LRS``; the port's steps run with every
    host read refused."""
    model_kw, ec_kw, sep, S = ENGINE_CASES[request.param]
    jcfg, cfg = _configs(model_kw)
    tokens, labels = _batch(cfg.vocab_size, B=4 if sep == 1 else 2, S=S)
    jeng = JaxEngine(jcfg, sep=sep, devices=jax.devices()[:sep],
                     engine_cfg=JaxEngineConfig(**ec_kw))
    jp, jo = jeng.init(seed=0)
    params = params_from_jax(jp, device="cpu")
    canon0 = opt_from_jax(jeng.opt_canonical()(jo["slots"], jp),
                          device="cpu")
    jp, jo, jlosses = _run_jax(jeng, jp, jo, tokens, labels, LRS)
    jcanon = jeng.opt_canonical()(jo["slots"], jp)

    eng = HybridEngine(cfg, sep=sep, device="cpu",
                       engine_cfg=EngineConfig(**ec_kw))
    opt = eng.opt_from_canonical(canon0, step=0)
    p0 = {k: v.clone() for k, v in _flat(params).items()}
    ptrs = [t.data_ptr() for t in _flat(opt["slots"]).values()]
    losses = []
    for lr in LRS:
        with no_host_sync():
            params, opt, loss = eng.step(params, opt, tokens, labels, lr=lr)
        losses.append(float(loss))
    assert [t.data_ptr() for t in _flat(opt["slots"]).values()] == ptrs
    assert opt["step"] == len(LRS) == int(jo["step"])
    assert float(eng._step) == len(LRS)
    canon = eng.opt_canonical(opt, params)
    return dict(case=request.param, jlosses=jlosses, losses=losses,
                jparams=_np(jp), params=_flat(params_to_numpy(params)),
                p0=p0, jcanon={k: _np(v) for k, v in jcanon.items()},
                canon={k: _flat(params_to_numpy(v))
                       for k, v in canon.items()})


def test_engine_losses_match_jax(engine_runs):
    """Losses at 1e-4 (atol and rtol) with the learning rate changing
    every step; the loss falls."""
    np.testing.assert_allclose(engine_runs["losses"], engine_runs["jlosses"],
                               atol=1e-4, rtol=1e-4)
    assert engine_runs["losses"][-1] < engine_runs["losses"][0]


def test_engine_params_match_jax(engine_runs):
    """Each Adam step moves an element by about lr along m̂/(√v̂ + ε),
    which summation-order noise decides where |g| is near ε: every
    element within sum(LRS) of JAX's, and the updates (p − p0) within
    1e-4 (atol and rtol) on 99.9 % of every leaf's elements."""
    jp, p, p0 = (engine_runs[k] for k in ("jparams", "params", "p0"))
    assert jp.keys() == p.keys()
    for k in jp:
        np.testing.assert_allclose(p[k], jp[k], atol=sum(LRS), rtol=0,
                                   err_msg=k)
        d, dj = p[k] - p0[k].numpy(), jp[k] - p0[k].numpy()
        close = np.abs(d - dj) <= 1e-4 + 1e-4 * np.abs(dj)
        assert close.mean() >= 0.999, (k, close.mean())


def test_engine_adam_state_matches_jax(engine_runs):
    """m (atol 1e-6) and v (atol 1e-9) at rtol 1e-3, the JAX engine
    suite's fp32 slot tolerance (grads agree to ~1e-4 relative); bf16
    slots round the same fp32 values and can land one ulp apart (rtol
    2⁻⁶).  The master follows the params."""
    canon, jcanon = engine_runs["canon"], engine_runs["jcanon"]
    rtol = 2 ** -6 if engine_runs["case"] == "bf16_slots" else 1e-3
    for name, atol in (("m", 1e-6), ("v", 1e-9)):
        assert canon[name].keys() == jcanon[name].keys()
        for k in canon[name]:
            np.testing.assert_allclose(canon[name][k], jcanon[name][k],
                                       atol=atol, rtol=rtol,
                                       err_msg=f"{name}/{k}")
    for k in canon["master"]:
        np.testing.assert_allclose(canon["master"][k], jcanon["master"][k],
                                   atol=sum(LRS), rtol=0, err_msg=k)


def test_engine_resumes_a_jax_state_at_step_5():
    """JAX runs 5 steps; its params and canonical state at step 5 cross
    to the port (``opt_from_canonical(canon, step=5)``), and both take 2
    more steps: the bias corrections are those of steps 6 and 7 (the
    engine's step scalar is filled from the state's step), so losses
    agree at 1e-4 and the updates as above."""
    jcfg, cfg = _configs({})
    tokens, labels = _batch(cfg.vocab_size, seed=6)
    jeng = JaxEngine(jcfg, devices=jax.devices()[:1])
    jp, jo = jeng.init(seed=0)
    jp, jo, _ = _run_jax(jeng, jp, jo, tokens, labels, [1e-3] * 5)
    params = params_from_jax(jp, device="cpu")
    canon5 = opt_from_jax(jeng.opt_canonical()(jo["slots"], jp),
                          device="cpu")
    jp, jo, jlosses = _run_jax(jeng, jp, jo, tokens, labels, [1e-3] * 2)
    eng = HybridEngine(cfg, device="cpu")
    opt = eng.opt_from_canonical(canon5, step=5)
    assert opt["step"] == 5
    p0 = {k: v.clone() for k, v in _flat(params).items()}
    losses = [float(eng.step(params, opt, tokens, labels, lr=1e-3)[2])
              for _ in range(2)]
    np.testing.assert_allclose(losses, jlosses, atol=1e-4, rtol=1e-4)
    assert opt["step"] == 7 == int(jo["step"]) == float(eng._step)
    got, want = _flat(params_to_numpy(params)), _np(jp)
    for k in want:
        d, dj = got[k] - p0[k].numpy(), want[k] - p0[k].numpy()
        close = np.abs(d - dj) <= 1e-4 + 1e-4 * np.abs(dj)
        assert close.mean() >= 0.999, (k, close.mean())
    # a state resumed at step 0 instead applies step 1's bias correction:
    # the first update differs visibly
    other = HybridEngine(cfg, device="cpu")
    wrong = other.opt_from_canonical(canon5, step=0)
    ref = HybridEngine(cfg, device="cpu")
    right = ref.opt_from_canonical(canon5, step=5)
    qa = _unflat({k: v.clone() for k, v in p0.items()})
    qb = _unflat({k: v.clone() for k, v in p0.items()})
    other.step(qa, wrong, tokens, labels, lr=1e-3)
    ref.step(qb, right, tokens, labels, lr=1e-3)
    gap = max(float((a - b).abs().max()) for a, b in
              zip(_flat(qa).values(), _flat(qb).values()))
    assert gap > 1e-4


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def test_engine_body_dropout_makes_no_host_sync():
    """Dropout (the seed folded on the device), accumulation and a
    binding clip in one step body, with every host read refused; a
    second engine given the same seeds draws the same masks (equal
    losses), another seed other masks."""
    _, cfg = _configs({})
    cfg = dataclasses.replace(cfg, dropout=0.1)
    tokens, labels = _batch(cfg.vocab_size, seed=7)
    out = []
    for seed in (11, 11, 12):
        eng = HybridEngine(cfg, device="cpu", engine_cfg=EngineConfig(
            accum_steps=2, grad_clip=0.05))
        params, opt = eng.init(seed=0)
        losses = []
        for _ in range(2):
            with no_host_sync():
                params, opt, loss = eng.step(params, opt, tokens, labels,
                                             dropout_seed=seed)
            losses.append(float(loss))
        out.append(losses)
    assert out[0] == out[1] and out[0] != out[2]


# ---------------------------------------------------- the device seed fold


def test_device_fold_equals_host_fold():
    """``_fold`` on an int64 tensor gives the host's bits for 1,000 random
    64-bit seeds, folded with random layer indices and micro-batch
    indices (seed as a tensor, and indices as a tensor)."""
    rng = random.Random(0)
    seeds = [rng.getrandbits(64) for _ in range(1000)]
    layers = [rng.randrange(0, 1 << 20) for _ in range(1000)]
    micro = [rng.getrandbits(64) for _ in range(1000)]
    want = [_fold(s, l, m) for s, l, m in zip(seeds, layers, micro)]
    signed = torch.tensor([s - (1 << 64) if s >= 1 << 63 else s
                           for s in seeds], dtype=torch.int64)
    got = [_fold(signed[i], layers[i], micro[i]) for i in range(1000)]
    assert [int(g) for g in got] == want
    vec = _fold(signed, torch.tensor(layers), torch.tensor(
        [m - (1 << 64) if m >= 1 << 63 else m for m in micro]))
    assert vec.tolist() == want
    assert all(0 <= w < 1 << 63 for w in want)


def test_dropout_masks_from_a_device_seed():
    """At 2¹⁶ elements the kept share is within 1 % of 1 − rate; an int
    seed and the same seed in a device tensor give one mask; the step's
    fold (``_fold(seed, step)``) gives another mask each step; under
    remat ``full`` the backward's recompute redraws the forward's masks
    (the gradients equal those without remat)."""
    x = torch.ones(1 << 16)
    for rate in (0.1, 0.5):
        kept = float((_dropout(x, rate, 3) != 0).float().mean())
        assert abs(kept - (1 - rate)) <= 0.01, (rate, kept)
    key = torch.tensor(_fold(3, 0))
    assert torch.equal(_dropout(x, 0.1, _fold(3, 0)), _dropout(x, 0.1, key))
    masks = [_dropout(x, 0.1, torch.tensor(_fold(3, s))) != 0
             for s in range(3)]
    assert not torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[1], masks[2])

    _, cfg = _configs({})
    cfg = dataclasses.replace(cfg, dropout=0.2)
    params = gpt_init(cfg, device="cpu")
    tokens, labels = _batch(cfg.vocab_size, seed=8)
    grads = {}
    for remat in ("nothing", "full"):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in _flat(params).items()}
        loss = gpt_loss(dataclasses.replace(cfg, remat=remat),
                        _unflat(leaves), torch.from_numpy(tokens),
                        torch.from_numpy(labels),
                        dropout_seed=torch.tensor(_fold(9, 1)))
        grads[remat] = torch.autograd.grad(loss, list(leaves.values()))
    for a, b in zip(grads["nothing"], grads["full"]):
        assert torch.equal(a, b)


# ------------------------------------------ nine optimizers via train_batch

OPTIMIZERS = [
    ("SGD", dict(weight_decay=0.01)),
    ("Momentum", dict(momentum=0.9, weight_decay=1e-4)),
    ("Adagrad", dict(initial_accumulator_value=0.1)),
    ("RMSProp", dict(momentum=0.9, centered=True)),
    ("Adam", {}),
    ("AdamW", dict(weight_decay=0.1)),
    ("Lamb", {}),
    ("Adadelta", {}),
    ("Adamax", {}),
]


def _mlp(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))


def _hapi_pair(name, kw, clip=None):
    """The same MLP in both packages under ``name`` with an exponential
    schedule (the learning rate changes every step)."""
    jl, tl = pair(lambda: _mlp(jpaddle), lambda: _mlp(tpaddle))
    models = []
    for pkg, layer, cls in ((jpaddle, jl, JModel), (tpaddle, tl, Model)):
        sched = pkg.optimizer.lr.ExponentialDecay(learning_rate=0.05,
                                                  gamma=0.7)
        extra = dict(kw)
        if clip is not None:
            extra["grad_clip"] = clip(pkg)
        if name == "Adadelta":
            sched = pkg.optimizer.lr.ExponentialDecay(learning_rate=1.0,
                                                      gamma=0.7)
        opt = getattr(pkg.optimizer, name)(learning_rate=sched,
                                           parameters=layer.parameters(),
                                           **extra)
        model = cls(layer)
        model.prepare(opt, pkg.nn.CrossEntropyLoss())
        models.append((model, sched))
    return models


def _mlp_batch(step, n=6):
    rng = np.random.RandomState(30 + step)
    return (rng.randn(n, 8).astype(np.float32),
            rng.randint(0, 4, (n,)).astype(np.int64))


def _slot_ptrs(model):
    return {(k, n): t.data_ptr()
            for k, s in model._opt_state["slots"].items()
            for n, t in s.items()}


@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=[n for n, _ in
                                                      OPTIMIZERS])
def test_optimizers_through_train_batch_match_jax(name, kw):
    """Four ``train_batch`` steps in each package, the scheduler stepped
    after each (the learning rate read into a device scalar every call):
    losses at 1e-5 relative, parameters and every slot at 1e-5 (atol and
    rtol); every slot tensor keeps its storage (in-place updates); the
    port's step bodies make no host sync."""
    (jmodel, jsched), (tmodel, tsched) = _hapi_pair(name, kw)
    ptrs = None
    for step in range(4):
        x, y = _mlp_batch(step)
        jloss, _ = jmodel.train_batch([x], [y])
        with _guarded_bodies(tmodel):
            tloss, _ = tmodel.train_batch([x], [y])
        assert tloss == pytest.approx(jloss, rel=1e-5)
        if ptrs is None:
            ptrs = _slot_ptrs(tmodel)
        assert _slot_ptrs(tmodel) == ptrs
        jsched.step()
        tsched.step()
    assert tmodel._opt_state["step"] == int(jmodel._opt_state["step"]) == 4
    tparams = dict(tmodel.network.named_parameters())
    for k, p in jmodel.network.named_parameters():
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(p.data), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    for k, slots in jmodel._opt_state["slots"].items():
        for n, v in slots.items():
            np.testing.assert_allclose(
                tmodel._opt_state["slots"][k][n].numpy(), np.asarray(v),
                atol=1e-5, rtol=1e-5, err_msg=f"{k}.{n}")


@contextlib.contextmanager
def _guarded_bodies(model):
    """Run ``model``'s train and eval bodies with host reads refused."""
    train, ev = model._train_body, model._eval_body

    def guard(fn):
        def body(*args):
            with no_host_sync():
                return fn(*args)
        return body

    model._train_body, model._eval_body = guard(train), guard(ev)
    try:
        yield
    finally:
        del model._train_body, model._eval_body


CLIPS = {
    "value": lambda pkg: pkg.optimizer.ClipGradByValue(0.05),
    "norm": lambda pkg: pkg.optimizer.ClipGradByNorm(0.1),
    "global": lambda pkg: pkg.optimizer.ClipGradByGlobalNorm(0.1),
}


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_clips_in_train_batch_match_jax(clip):
    """Each of the three clips, binding, under Momentum with the grad
    norm logged: two steps at 1e-5 against JAX (loss, grad norm,
    parameters), with host reads refused in the bodies."""
    (jmodel, _), (tmodel, _) = _hapi_pair(
        "Momentum", dict(momentum=0.9), clip=CLIPS[clip])
    jmodel.enable_grad_norm_logging()
    tmodel.enable_grad_norm_logging()
    for step in range(2):
        x, y = _mlp_batch(step)
        jloss, jres = jmodel.train_batch([x], [y])
        with _guarded_bodies(tmodel):
            tloss, tres = tmodel.train_batch([x], [y])
        assert tloss == pytest.approx(jloss, rel=1e-5)
        assert tres["grad_norm"] == pytest.approx(jres["grad_norm"],
                                                  rel=1e-5)
    tparams = dict(tmodel.network.named_parameters())
    for k, p in jmodel.network.named_parameters():
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(p.data), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_eval_batch_keeps_buffers_and_matches_train_mode_forward():
    """``eval_batch`` on a net with batch norm left in train mode: the
    loss equals JAX's at 1e-5 and the running statistics are unchanged
    afterwards, with host reads refused in the body."""
    def net(pkg):
        nn = pkg.nn
        return nn.Sequential(nn.Linear(8, 16), nn.BatchNorm1D(16),
                             nn.ReLU(), nn.Linear(16, 4))

    jl, tl = pair(lambda: net(jpaddle), lambda: net(tpaddle))
    jm, tm = JModel(jl), Model(tl)
    jm.prepare(loss=jpaddle.nn.CrossEntropyLoss())
    tm.prepare(loss=tpaddle.nn.CrossEntropyLoss())
    before = {k: b.clone() for k, b in tl.named_buffers()}
    x, y = _mlp_batch(9)
    jloss, _ = jm.eval_batch([x], [y])
    with _guarded_bodies(tm):
        tloss, _ = tm.eval_batch([x], [y])
    assert tloss == pytest.approx(jloss, rel=1e-5)
    for k, b in tl.named_buffers():
        assert torch.equal(b, before[k]), k


def test_prepare_again_takes_the_new_loss_and_optimizer():
    """Two Adam steps under a mean cross entropy, then ``prepare`` with
    AdamW (decoupled decay, another learning rate) and a summed cross
    entropy, and two more steps: losses (1e-5 relative), parameters and
    slots (1e-5) equal JAX's, whose ``prepare`` drops its jitted steps.
    The port's ``prepare`` builds new watched steps (the watchdog counts
    a build of each and no rebuild), with host reads refused in the
    bodies."""
    with watchdog_enabled() as wd:
        wd.reset()
        (jmodel, _), (tmodel, _) = _hapi_pair("Adam", {})
        old = tmodel._train_fn
        for step in range(4):
            if step == 2:
                for m, pkg in ((jmodel, jpaddle), (tmodel, tpaddle)):
                    m.prepare(pkg.optimizer.AdamW(
                        learning_rate=0.02, weight_decay=0.1,
                        parameters=m.network.parameters()),
                        pkg.nn.CrossEntropyLoss(reduction="sum"))
                assert tmodel._train_fn is not old
            x, y = _mlp_batch(step)
            jloss, _ = jmodel.train_batch([x], [y])
            with _guarded_bodies(tmodel):
                tloss, _ = tmodel.train_batch([x], [y])
            assert tloss == pytest.approx(jloss, rel=1e-5), step
        rep = wd.report()["hapi::train_step"]
    assert rep["compiles"] == 2 and rep["recompiles"] == 0
    assert tmodel._opt_state["step"] == int(jmodel._opt_state["step"]) == 4
    tparams = dict(tmodel.network.named_parameters())
    for k, p in jmodel.network.named_parameters():
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(p.data), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    for k, slots in jmodel._opt_state["slots"].items():
        for n, v in slots.items():
            np.testing.assert_allclose(
                tmodel._opt_state["slots"][k][n].numpy(), np.asarray(v),
                atol=1e-5, rtol=1e-5, err_msg=f"{k}.{n}")


# --------------------------------------------------------------- watchdog


@pytest.fixture
def obs_caplog(caplog):
    logger = logging.getLogger(LOGGER)
    prev = logger.propagate
    logger.propagate = True
    yield caplog
    logger.propagate = prev


def test_watchdog_sees_the_engine_step(obs_caplog):
    """Three steps: one build of ``hybrid_engine::step``; a batch of
    another length is a rebuild whose warning names the tokens and
    labels arguments."""
    _, cfg = _configs({})
    with obs_caplog.at_level(logging.WARNING, logger=LOGGER), \
            watchdog_enabled() as wd:
        wd.reset()
        eng = HybridEngine(cfg, device="cpu")
        params, opt = eng.init(seed=0)
        tokens, labels = _batch(cfg.vocab_size, seed=1)
        for _ in range(3):
            eng.step(params, opt, tokens, labels)
        rep = dict(wd.report()["hybrid_engine::step"])
        short = _batch(cfg.vocab_size, S=32, seed=1)
        eng.step(params, opt, *short)
        again = wd.report()["hybrid_engine::step"]
    assert rep["compiles"] == 1 and rep["recompiles"] == 0
    assert rep["calls"] == 3
    assert again["compiles"] == 2 and again["recompiles"] == 1
    msg = [r.getMessage() for r in obs_caplog.records
           if r.levelno == logging.WARNING]
    assert len(msg) == 1 and "hybrid_engine::step" in msg[0]
    assert "[3]: i64[4,64] -> i64[4,32]" in msg[0]
    assert "[4]: i64[4,64] -> i64[4,32]" in msg[0]


def test_watchdog_sees_the_hapi_steps(obs_caplog):
    """Two ``train_batch`` and two ``eval_batch`` calls: one build each of
    ``hapi::train_step`` and ``hapi::eval_step``; a smaller batch (a
    ``fit`` tail) is a rebuild naming the input's shape."""
    with obs_caplog.at_level(logging.WARNING, logger=LOGGER), \
            watchdog_enabled() as wd:
        wd.reset()
        (_, _), (tmodel, _) = _hapi_pair("Adam", {})
        x, y = _mlp_batch(0)
        for _ in range(2):
            tmodel.train_batch([x], [y])
            tmodel.eval_batch([x], [y])
        rep = {k: dict(v) for k, v in wd.report().items()}
        tmodel.train_batch([x[:2]], [y[:2]])
        again = wd.report()["hapi::train_step"]
    for name in ("hapi::train_step", "hapi::eval_step"):
        assert rep[name]["compiles"] == 1 and rep[name]["recompiles"] == 0
        assert rep[name]["calls"] == 2
    assert again["compiles"] == 2 and again["recompiles"] == 1
    msg = [r.getMessage() for r in obs_caplog.records
           if r.levelno == logging.WARNING]
    assert len(msg) == 1 and "hapi::train_step" in msg[0]
    assert "[0]: f32[6,8] -> f32[2,8]" in msg[0]
    assert tmodel.captures == {"train": 0, "eval": 0}   # no graph here
