"""``recompute`` and ``key_stream`` inside a captured step
(``paddle_tpu_torch/core/random.py`` step scopes and generator pairs,
``distributed/recompute.py``, hapi's ``_train_body``) on the CPU.

hapi's ``train_batch`` runs its body inside ``core.random.step_scope()``
on the CPU too (``CapturedStep`` enters it around the body, as it does
around the eager run and the capture on the card), so these tests drive
the code a CUDA graph captures.  The model is the Paddle-style GPT
(``models/paddle_gpt.py``) at 2 layers, hidden 64, 4 heads, batch 2 x
64, AdamW, from one numpy seed.

1. With residual dropout 0.1 and every block under ``recompute`` (each
   of the four policies, fp32 and bf16 ``auto_cast``), three steps give
   the loss, every gradient and every updated parameter of the same
   model without recompute (its blocks under ``key_stream(split_key())``)
   bit for bit.
2. At lr 0 on one batch the losses of consecutive steps differ (fresh
   masks each step, not the JAX hapi step's frozen ones), and after the
   first step the bodies read nothing on the host (no seed drawn).
3. The eager route (the body called directly, as ``chip_smoke.py``'s
   ``eager_route`` does on the card) equals ``train_batch`` bit for bit;
   a train-mode ``eval_batch`` between steps (its dropout draws the
   first members only), nested segments, a step run inside a
   recomputed segment (a ``CapturedStep``, or the ``begin_step`` a
   replay starts with, also when the recompute runs on another thread,
   as autograd runs it on the card) keep property 1; in a scope
   consecutive ``split_key`` calls differ.
4. At dropout 0, hapi with recompute under each policy trains as the
   JAX hapi ``train_batch`` does (its jitted step traces the JAX
   ``recompute``): losses at 1e-5 over 3 steps.  Its masks are frozen
   at trace time (equal losses at lr 0), a quirk the port does not
   copy.
5. ``replay_train_batch`` replays a recompute step bitwise (from a
   snapshot with the pairs live, and from one taken before they were
   made, which has no pairs, as snapshots before them had none), and a
   killed ``fit`` resumes bitwise.

Outside a step scope ``key_stream`` and ``recompute`` keep their eager
meaning (``tests/test_torch_recompute.py``), also once pairs exist, and
leave the pairs alone."""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.distributed import recompute as jrecompute
from paddle_tpu.hapi import Model as JModel

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.distributed import recompute as trecompute
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import paddle_gpt as prog

V, D, H, FFN, L, S, B = 128, 64, 4, 256, 2, 64, 2
POLICIES = ("full", "dots", "dots_no_batch", "nothing")
DROPOUT = 0.1
_SYNCS = ("item", "__float__", "__int__", "__bool__", "tolist", "numpy")


@pytest.fixture(autouse=True)
def _isolated():
    """Each test starts with no stream (no pair) and one torch thread;
    the streams before it come back after it."""
    tpaddle.set_device("cpu")
    saved = dict(trandom._streams)
    trandom._streams.clear()
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    trandom._streams.clear()
    trandom._streams.update(saved)


def _params(seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, std=0.02):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return {
        "wte": n(V, D), "wpe": n(S, D, std=0.01),
        "lnf_g": 1 + n(D), "lnf_b": n(D),
        "blocks": {
            "ln1_g": 1 + n(L, D), "ln1_b": n(L, D),
            "qkv_w": n(L, D, 3 * D), "qkv_b": n(L, 3 * D),
            "proj_w": n(L, D, D), "proj_b": n(L, D),
            "ln2_g": 1 + n(L, D), "ln2_b": n(L, D),
            "up_w": n(L, D, FFN), "up_b": n(L, FFN),
            "down_w": n(L, FFN, D), "down_b": n(L, D)},
    }


def _batch(seed=1):
    tokens = np.random.default_rng(seed).integers(0, V, (B, S))
    tokens = tokens.astype(np.int64)
    return tokens, prog.next_token_labels(tokens)


def _loss(paddle):
    F = paddle.nn.functional

    def loss(out, y):
        return F.cross_entropy(paddle.reshape(out, [-1, V]),
                               paddle.reshape(y, [-1]), ignore_index=-100)

    return loss


class _Recording(Model):
    """hapi's ``Model`` that keeps each step's gradients (clones made
    inside the body) and, when ``guard`` is set, refuses every host read
    inside its bodies."""

    guard = False
    grads = None

    def _train_body(self, *args):
        with self._guarded():
            return super()._train_body(*args)

    def _eval_body(self, *args):
        with self._guarded():
            return super()._eval_body(*args)

    @contextlib.contextmanager
    def _guarded(self):
        if not self.guard:
            yield
            return
        saved = {name: getattr(torch.Tensor, name) for name in _SYNCS}

        def refuse(name):
            def method(*a, **k):
                raise AssertionError(f"host read in a step body: {name}")
            return method

        for name in _SYNCS:
            setattr(torch.Tensor, name, refuse(name))
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(torch.Tensor, name, fn)


def _model(policy=None, dropout=DROPOUT, lr=1e-3, cls=_Recording):
    """hapi over the Paddle-style GPT: every block under ``recompute``
    with ``policy``, or (None) under ``key_stream(split_key())``."""
    tpaddle.seed(0)
    net = prog.build_gpt(tpaddle, V, D, H, FFN, L, S, dropout=dropout,
                         recompute=policy is not None,
                         policy=policy or "full")
    missing, unexpected = net.set_state_dict(
        prog.gpt_state_from_params(_params(), L))
    assert not missing and not unexpected
    model = cls(net)
    opt = tpaddle.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                  parameters=net.parameters())
    model.prepare(opt, _loss(tpaddle))
    apply = opt.apply_gradients_

    def recording(params, grads, *rest):
        model.grads = {k: g.detach().clone() for k, g in grads.items()}
        return apply(params, grads, *rest)

    opt.apply_gradients_ = recording
    return model


def _steps(model, n=3, amp=False, seed=7, batch=None):
    """``n`` train_batch calls from ``paddle.seed(seed)``: per step the
    loss, the gradients and the parameters after it."""
    tokens, labels = batch or _batch()
    tpaddle.seed(seed)
    out = []
    for _ in range(n):
        ctx = (tpaddle.amp.auto_cast(dtype="bfloat16") if amp
               else contextlib.nullcontext())
        with ctx:
            loss, _ = model.train_batch(tokens, labels)
        out.append((loss, model.grads, {
            k: p.detach().clone()
            for k, p in model.network.named_parameters()}))
    return out


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for (gl, gg, gp), (wl, wg, wp) in zip(got, want):
        assert gl == wl
        assert set(gg) == set(wg) and set(gp) == set(wp)
        for k in wg:
            assert torch.equal(gg[k], wg[k]), k
        for k in wp:
            assert torch.equal(gp[k], wp[k]), k


# ------------------------------------------- 1, 2: same function, fresh


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_in_a_step_is_the_function_without(policy, amp):
    want = _steps(_model(None), amp=amp)
    got = _steps(_model(policy), amp=amp)
    _assert_bitwise(got, want)
    # the masks were drawn: dropout off gives another loss
    plain = _steps(_model(policy, dropout=0.0), n=1, amp=amp)
    assert plain[0][0] != want[0][0]
    # one pair a block, two members (forward, recompute) unless nothing
    # is recomputed
    pairs = trandom._streams["default"].pairs
    assert len(pairs) == L
    assert {len(p.members["cpu"]) for p in pairs} == {
        1 if policy == "nothing" else 2}


@pytest.mark.parametrize("policy", POLICIES + ("key_stream",))
def test_masks_are_fresh_each_step_with_no_host_draw(policy):
    model = _model(None if policy == "key_stream" else policy, lr=0.0)
    tokens, labels = _batch()
    tpaddle.seed(7)
    losses = [model.train_batch(tokens, labels)[0]]
    key = trandom.current_key()
    model.guard = True
    for _ in range(3):
        losses.append(model.train_batch(tokens, labels)[0])
    model.guard = False
    assert len(set(losses)) == len(losses), losses
    # no seed was drawn after the pairs were made
    assert torch.equal(trandom.current_key(), key)


def test_a_train_mode_eval_between_steps_keeps_the_pairs_in_step():
    """``eval_batch`` with the network in train mode draws its dropout
    from the pairs' first members only (no backward, no recompute): the
    next step's start sets the second members to the first ones' state,
    and a second member first made after an eval starts from it, so the
    recompute still draws the forward's masks."""
    runs = []
    for policy in (None, "full"):
        model = _model(policy)
        tokens, labels = _batch()
        tpaddle.seed(7)
        out = [model.eval_batch(tokens, labels)[0],
               model.train_batch(tokens, labels)[0],
               model.eval_batch(tokens, labels)[0]]
        out += [model.train_batch(tokens, labels)[0] for _ in range(2)]
        runs.append((out, model.grads))
    assert runs[0][0] == runs[1][0]
    for k, g in runs[0][1].items():
        assert torch.equal(runs[1][1][k], g), k


def test_the_eager_route_equals_train_batch():
    """The route ``chip_smoke.py`` compares the graph with on the card:
    the step body called directly."""

    class Eager(_Recording):
        def _run_train(self, args):
            with trandom.step_scope():
                return self._train_body(*args)

    want = _steps(_model("full"))
    _assert_bitwise(_steps(_model("full", cls=Eager)), want)


def test_nested_key_streams_and_recompute_replay_their_masks():
    """A ``recompute`` whose segment holds a ``key_stream`` and another
    ``recompute``: the same function as the segments run plainly, in a
    step scope, step after step."""
    nn = tpaddle.nn

    class Net(nn.Layer):
        def __init__(self, remat):
            super().__init__()
            self.remat = remat
            self.a = nn.Linear(8, 32)
            self.b = nn.Linear(32, 32)
            self.c = nn.Linear(32, 4)
            self.drop = nn.Dropout(0.3)

        def inner(self, h):
            return self.drop(nn.functional.gelu(self.b(h)))

        def outer(self, x):
            h = self.drop(self.a(x))
            with trandom.key_stream(trandom.split_key()):
                h = self.drop(h)
            if self.remat:
                return trecompute.recompute(self.inner, h)
            with trandom.key_stream(trandom.split_key()):
                return self.inner(h)

        def forward(self, x):
            if self.remat:
                return self.c(trecompute.recompute(self.outer, x))
            with trandom.key_stream(trandom.split_key()):
                return self.c(self.outer(x))

    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    y = rng.integers(0, 4, (6,)).astype(np.int64)
    runs = {}
    for remat in (False, True):
        trandom._streams.clear()
        tpaddle.seed(0)
        net = Net(remat)
        model = _Recording(net)
        opt = tpaddle.optimizer.AdamW(learning_rate=1e-2,
                                      parameters=net.parameters())
        model.prepare(opt, nn.CrossEntropyLoss())
        runs[remat] = [model.train_batch(x, y)[0] for _ in range(3)]
        runs[remat].append({k: p.detach().clone()
                            for k, p in net.named_parameters()})
    assert runs[True][:3] == runs[False][:3]
    for k, p in runs[False][3].items():
        assert torch.equal(runs[True][3][k], p), k
    assert len(set(runs[True][:3])) == 3


@pytest.mark.parametrize("between", ["captured_step", "begin_step"])
def test_a_step_run_inside_a_recomputed_segment_leaves_its_pairs(between):
    """A ``CapturedStep`` called inside a recomputed segment of a hapi
    body is part of that step: on the CPU its body runs in the step's
    scope, and on the card its replay starts with ``begin_step()``,
    which does nothing inside a scope.  Either between two dropouts of
    the segment keeps property 1 and fresh masks."""
    from paddle_tpu_torch._captured import CapturedStep

    nn = tpaddle.nn

    class Net(nn.Layer):
        def __init__(self, remat):
            super().__init__()
            self.remat = remat
            self.a = nn.Linear(8, 32)
            self.c = nn.Linear(32, 4)
            self.drop = nn.Dropout(0.3)
            self.inner = CapturedStep(lambda h: self.drop(h) * 1.5,
                                      torch.device("cpu"))

        def segment(self, x):
            h = self.drop(nn.functional.gelu(self.a(x)))
            if between == "captured_step":
                h = self.inner(h)
            else:
                trandom.begin_step()
            return self.drop(h)

        def forward(self, x):
            if self.remat:
                return self.c(trecompute.recompute(self.segment, x))
            with trandom.key_stream(trandom.split_key()):
                return self.c(self.segment(x))

    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    y = rng.integers(0, 4, (6,)).astype(np.int64)
    runs = {}
    for remat in (False, True):
        trandom._streams.clear()
        tpaddle.seed(0)
        net = Net(remat)
        model = _Recording(net)
        opt = tpaddle.optimizer.AdamW(learning_rate=1e-2,
                                      parameters=net.parameters())
        model.prepare(opt, nn.CrossEntropyLoss())
        runs[remat] = [model.train_batch(x, y)[0] for _ in range(3)]
        runs[remat].append({k: p.detach().clone()
                            for k, p in net.named_parameters()})
    assert runs[True][:3] == runs[False][:3]
    for k, p in runs[False][3].items():
        assert torch.equal(runs[True][3][k], p), k
    assert len(set(runs[True][:3])) == 3


def test_a_recompute_on_another_thread_is_in_the_callers_step():
    """Autograd runs a CUDA recompute on its device thread, where the
    thread-local step scope is not set: the recompute still runs in the
    caller's step, so a ``begin_step()`` there (a replay's) does
    nothing.  Here the backward runs on a thread of its own, on the
    CPU: input gradients equal the segment without recompute bitwise,
    step after step."""
    import threading

    drop = tpaddle.nn.Dropout(0.3)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (16, 32)).astype(np.float32)).requires_grad_(True)

    def segment(h):
        h = drop(h)
        trandom.begin_step()
        return drop(h * 1.5)

    out = {}
    for remat in (False, True):
        tpaddle.seed(3)
        out[remat] = []
        for _ in range(3):
            got = []
            with trandom.step_scope():
                if remat:
                    y = trecompute.recompute(segment, x)
                else:
                    with trandom.key_stream(trandom.split_key()):
                        y = segment(x)
                worker = threading.Thread(target=lambda: got.extend(
                    torch.autograd.grad(y.square().sum(), x)))
                worker.start()
                worker.join()
            out[remat].append((y.detach(), got[0]))
    for (y0, g0), (y1, g1) in zip(out[False], out[True]):
        assert torch.equal(y0, y1) and torch.equal(g0, g1)
    assert not torch.equal(out[True][0][1], out[True][1][1])


def test_split_key_in_a_step_scope_differs_call_by_call():
    """In a step scope consecutive ``split_key`` calls differ and draw
    nothing on the host once their pair exists; a step gets the values
    of the step before it (what a captured graph would hold of them),
    and a recompute its forward's.  Outside a scope each call draws."""
    seen = []
    x = torch.ones(4, requires_grad=True)

    def segment(x):
        seen.append((trandom.split_key(), trandom.split_key()))
        return x * x

    def step():
        with trandom.step_scope():
            keys = [trandom.split_key(), trandom.split_key()]
            with trandom.key_stream(keys[0]):
                pass
            keys.append(trandom.split_key())
            y = trecompute.recompute(segment, x)
            torch.autograd.grad(y.sum(), x)
        return keys

    tpaddle.seed(7)
    first = step()
    key = trandom.current_key()
    second = step()
    assert len(set(first)) == 3
    assert second == first
    assert torch.equal(trandom.current_key(), key)
    assert len(seen) == 4 and len(set(seen)) == 1
    assert len(set(seen[0])) == 2 and not set(seen[0]) & set(first)
    assert trandom.split_key() != trandom.split_key()
    assert not torch.equal(trandom.current_key(), key)


# ------------------------------------------------------- 4: against JAX


@pytest.mark.parametrize("policy", POLICIES)
def test_hapi_recompute_at_dropout_0_trains_as_jax(policy):
    tokens, labels = _batch()
    losses = {}
    for name, paddle, cls in (("jax", jpaddle, JModel),
                              ("torch", tpaddle, Model)):
        paddle.seed(0)
        net = prog.build_gpt(paddle, V, D, H, FFN, L, S, recompute=True,
                             policy=policy)
        net.set_state_dict(prog.gpt_state_from_params(_params(), L))
        model = cls(net)
        model.prepare(paddle.optimizer.AdamW(
            learning_rate=1e-3, weight_decay=0.01,
            parameters=net.parameters()), _loss(paddle))
        losses[name] = [float(model.train_batch(tokens, labels)[0])
                        for _ in range(3)]
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5,
                               atol=1e-5)
    assert losses["torch"][-1] < losses["torch"][0]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "recompute"])
def test_jax_hapi_step_freezes_its_masks_and_the_port_does_not(remat):
    """A reference quirk, not followed: the JAX hapi step draws its
    dropout key while ``jax.jit`` traces it, so at lr 0 on one batch its
    losses repeat (the same masks every step); the port's differ."""
    rng = np.random.default_rng(11)
    weights = {"a.weight": rng.standard_normal((8, 32)).astype(np.float32),
               "a.bias": np.zeros(32, np.float32),
               "b.weight": rng.standard_normal((32, 4)).astype(np.float32),
               "b.bias": np.zeros(4, np.float32)}
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.integers(0, 4, (16,)).astype(np.int64)
    losses = {}
    for name, paddle, cls, rec in (
            ("jax", jpaddle, JModel, jrecompute),
            ("torch", tpaddle, Model, trecompute)):
        nn = paddle.nn

        class Block(nn.Layer):
            def __init__(self):
                super().__init__()
                self.a = nn.Linear(8, 32)
                self.drop = nn.Dropout(0.5)

            def forward(self, x):
                return self.drop(nn.functional.gelu(self.a(x)))

        class Net(nn.Layer):
            def __init__(self):
                super().__init__()
                self.block = Block()
                self.b = nn.Linear(32, 4)

            def forward(self, x):
                h = rec.recompute(self.block, x) if remat else self.block(x)
                return self.b(h)

        paddle.seed(0)
        net = Net()
        net.set_state_dict({"block." + k if k[0] == "a" else k: v
                            for k, v in weights.items()})
        model = cls(net)
        model.prepare(paddle.optimizer.SGD(learning_rate=0.0,
                                           parameters=net.parameters()),
                      nn.CrossEntropyLoss())
        losses[name] = [float(model.train_batch(x, y)[0]) for _ in range(3)]
    assert len(set(losses["jax"])) == 1, losses
    assert len(set(losses["torch"])) == 3, losses


# ----------------------------------------------- 5: the state carries over


def _replayed(model, snap, batch, live):
    loss, params = model.replay_train_batch(snap, batch)
    want_loss, want = live
    assert loss == want_loss
    for k, p in want.items():
        assert torch.equal(params[k], p), k


def test_replay_snapshot_replays_a_recompute_step():
    model = _model("full")
    batches = [_batch(s) for s in (1, 2, 3)]
    tpaddle.seed(7)
    first = model.train_state_snapshot()
    assert "pairs" not in first["rng"]["default"]      # none made yet
    lives = []
    for tokens, labels in batches:
        snap = model.train_state_snapshot() if lives else first
        loss, _ = model.train_batch(tokens, labels)
        lives.append((snap, (loss, {
            k: p.detach().clone()
            for k, p in model.network.named_parameters()})))
    assert set(lives[2][0]["rng"]["default"]["pairs"]) == {"0", "1"}
    after = trandom.get_rng_state()
    # the last step from a snapshot with pairs, the first from one
    # without (a snapshot from before pairs existed)
    _replayed(model, lives[2][0], batches[2], lives[2][1])
    _replayed(model, lives[0][0], batches[0], lives[0][1])
    # the live state came back, the pairs' too
    now = trandom.get_rng_state()["default"]
    for k, pair in after["default"]["pairs"].items():
        assert torch.equal(now["pairs"][k]["cpu"], pair["cpu"])
        assert int(now["pairs"][k]["seed"]) == int(pair["seed"])


def test_a_snapshot_without_pairs_loads_and_redraws_them():
    model = _model("full")
    tokens, labels = _batch()
    tpaddle.seed(7)
    model.train_batch(tokens, labels)
    snap = trandom.get_rng_state()
    older = {name: {k: v for k, v in st.items() if k != "pairs"}
             for name, st in snap.items()}
    trandom.set_rng_state(older)
    assert all(p.stale for p in trandom._streams["default"].pairs)
    key = torch.Generator()
    key.set_state(older["default"]["key"])
    want = [int(torch.randint(2 ** 63 - 1, (), generator=key))
            for _ in range(L)]
    model.train_batch(tokens, labels)
    assert [p.seed for p in trandom._streams["default"].pairs] == want
    # and the {device: state} form of the default stream alone
    trandom.set_rng_state({"cpu": snap["default"]["cpu"]})
    model.train_batch(tokens, labels)


class _Tokens(tpaddle.io.Dataset):
    def __init__(self):
        self.tokens = np.random.default_rng(5).integers(
            0, V, (8, S)).astype(np.int64)
        self.labels = prog.next_token_labels(self.tokens)

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, i):
        return self.tokens[i], self.labels[i]


def _fit(ckdir, kill_at=None, resume=None, seed=7):
    from paddle_tpu_torch.hapi import Callback, CheckpointCallback
    from paddle_tpu_torch.resilience import (FaultSpec, SimulatedCrash,
                                             injected_faults)

    class Losses(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    model = _model("dots")
    tpaddle.seed(seed)
    rec = Losses()
    args = dict(batch_size=2, epochs=2, shuffle=False, verbose=0,
                callbacks=[rec, CheckpointCallback(ckdir, every_n_steps=1)],
                resume_from=resume)
    if kill_at is None:
        model.fit(_Tokens(), **args)
    else:
        with injected_faults(FaultSpec("hapi.train_step", "kill",
                                       occurrence=kill_at)):
            with pytest.raises(SimulatedCrash):
                model.fit(_Tokens(), **args)
    return rec.losses


@pytest.mark.faultinject
def test_killed_fit_resumes_bitwise_with_pairs(tmp_path):
    ref = _fit(str(tmp_path / "ref"))
    ckdir = str(tmp_path / "ck")
    part_a = _fit(ckdir, kill_at=5)
    # a fresh process has no pairs: the checkpoint makes them
    trandom._streams.clear()
    part_b = _fit(ckdir, resume=ckdir, seed=8)
    other = _fit(str(tmp_path / "other"), seed=8)
    assert len(ref) == 8 and len(part_a) == 5 and len(part_b) == 3
    assert part_a + part_b == ref               # bitwise on the CPU
    assert other[5:] != ref[5:]                 # the masks mattered


# ----------------------------------------- outside a step scope: eager


def test_eager_semantics_outside_a_step_scope_are_kept():
    """After pairs exist, an eager ``recompute`` still draws one
    ``split_key`` and replays ``key_stream(seed)``'s masks, and leaves
    the pairs as they were."""
    model = _model("full")
    tokens, labels = _batch()
    tpaddle.seed(7)
    model.train_batch(tokens, labels)
    pairs = trandom.get_rng_state()["default"]["pairs"]
    net = model.network
    block = net.blocks[0]
    x0 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, S, D)).astype(np.float32))
    snap = trandom.get_rng_state()
    out = {}
    for name in ("recompute", "plain"):
        trandom.set_rng_state(snap)
        for p in block.parameters():
            p.clear_grad()
        x = x0.clone().requires_grad_(True)
        if name == "recompute":
            y = trecompute.recompute(block, x)
        else:
            with trandom.key_stream(trandom.split_key()):
                y = block(x)
        y.square().sum().backward()
        out[name] = [y.detach(), x.grad] + [p.grad for p in
                                            block.parameters()]
        out[name + "_key"] = trandom.current_key()
    for a, b in zip(out["recompute"], out["plain"]):
        assert torch.equal(a, b)
    trandom.set_rng_state(snap)
    trandom.split_key()
    assert torch.equal(trandom.current_key(), out["recompute_key"])
    now = trandom.get_rng_state()["default"]["pairs"]
    for k, pair in pairs.items():
        assert torch.equal(now[k]["cpu"], pair["cpu"])
    # a key_stream outside a scope still makes a fresh generator
    with trandom.key_stream(5):
        gen = trandom.generator("cpu")
    assert all(gen is not g for g in trandom.generators("cpu"))
