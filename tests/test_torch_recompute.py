"""Eager ``recompute`` (``paddle_tpu_torch/distributed/recompute.py``)
against the JAX package's (``paddle_tpu/distributed/recompute.py``) on
the CPU.

- Without dropout, ``recompute`` of a ``Layer`` and of a plain function
  under each policy gives the output and the gradients of the input and
  of every parameter that JAX's gives, within 1e-5 (weights carried JAX
  to port as ``state_dict`` numpy arrays, inputs from a numpy seed).
- With dropout 0.2 the port's recompute equals the port's plain forward
  and backward run under the same stream state (the segment under
  ``key_stream(split_key())``), bit for bit, and the outer stream
  advances by exactly one ``split_key`` a call, in both packages
  (checked through ``current_key``).  The masks themselves are not
  compared with JAX's: a JAX key and a torch generator draw differently
  from the same seed.
- The Paddle-style GPT (``models/paddle_gpt.py``) with ``recompute=True``
  trains as JAX's does at dropout 0, and at dropout 0.1 the port's
  program gives the same loss and gradients with and without recompute,
  bit for bit.
- The backward's recompute runs under the caller's autocast even when
  autograd runs it on another thread (as it does on the card)."""
import threading

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.core import random as jrandom
from paddle_tpu.distributed import recompute as jrecompute

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.distributed import recompute as trecompute
from paddle_tpu_torch.models import paddle_gpt as prog

TOL = dict(atol=1e-5, rtol=1e-5)
POLICIES = ("full", "dots", "dots_no_batch", "nothing")


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    tpaddle.set_device("cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mlp(paddle, p):
    nn = paddle.nn
    F = nn.functional

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = nn.Linear(8, 16)
            self.b = nn.Linear(16, 8)

        def forward(self, x):
            return self.b(F.dropout(F.gelu(self.a(x)), p))

    return MLP()


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa
    return {"a.weight": f(8, 16), "a.bias": f(16), "b.weight": f(16, 8),
            "b.bias": f(8)}, f(4, 8), f(8, 3)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def _layer_run(paddle, recompute, policy, p=0.0):
    weights, x, _ = _weights()
    paddle.seed(0)
    layer = _mlp(paddle, p)
    layer.set_state_dict(weights)
    xt = paddle.to_tensor(x, stop_gradient=False)
    y = recompute(layer, xt, policy=policy)
    (y * y).sum().backward()
    return (_np(y), _np(xt.grad),
            {k: _np(v.grad) for k, v in layer.named_parameters()})


def _fn_run(paddle, recompute, policy):
    _, x, w = _weights()

    def segment(x, w):
        return paddle.matmul(paddle.tanh(x), w)

    xt = paddle.to_tensor(x, stop_gradient=False)
    wt = paddle.to_tensor(w, stop_gradient=False)
    y = recompute(segment, xt, wt, policy=policy)
    (y * y).sum().backward()
    return _np(y), _np(xt.grad), _np(wt.grad)


@pytest.mark.parametrize("policy", POLICIES)
def test_layer_matches_jax(policy):
    jy, jgx, jgp = _layer_run(jpaddle, jrecompute.recompute, policy)
    ty, tgx, tgp = _layer_run(tpaddle, trecompute.recompute, policy)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(tgx, jgx, **TOL)
    assert set(tgp) == set(jgp)
    for k in jgp:
        np.testing.assert_allclose(tgp[k], jgp[k], **TOL, err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
def test_function_matches_jax(policy):
    for got, want in zip(_fn_run(tpaddle, trecompute.recompute, policy),
                         _fn_run(jpaddle, jrecompute.recompute, policy)):
        np.testing.assert_allclose(got, want, **TOL)


def _plain(layer, xt):
    """The layer's forward under the seed recompute would draw."""
    with trandom.key_stream(trandom.split_key()):
        return layer(xt)


@pytest.mark.parametrize("policy", POLICIES)
def test_dropout_replays_the_plain_masks_bitwise(policy):
    weights, x, _ = _weights()
    tpaddle.seed(5)
    layer = _mlp(tpaddle, 0.2)
    layer.set_state_dict(weights)
    snap = trandom.get_rng_state()
    out = {}
    for name, run in (("recompute", lambda xt: trecompute.recompute(
            layer, xt, policy=policy)), ("plain", lambda xt: _plain(
                layer, xt))):
        trandom.set_rng_state(snap)
        for p in layer.parameters():
            p.clear_grad()
        xt = tpaddle.to_tensor(x, stop_gradient=False)
        y = run(xt)
        (y * y).sum().backward()
        out[name] = [y.detach(), xt.grad] + [p.grad.clone() for p in
                                             layer.parameters()]
        out[name + "_key"] = trandom.current_key()
    layer.eval()
    with torch.no_grad():
        kept = layer(tpaddle.to_tensor(x))
    assert not torch.equal(out["recompute"][0], kept)   # units dropped
    for a, b in zip(out["recompute"], out["plain"]):
        assert torch.equal(a, b)
    assert torch.equal(out["recompute_key"], out["plain_key"])


def _one_draw(random_mod, run, key_data):
    """The stream's key after ``run()`` equals its key after one
    ``split_key()`` from the same state, and differs from the key
    before."""
    snap = random_mod.get_rng_state()
    before = key_data(random_mod.current_key())
    run()
    after = key_data(random_mod.current_key())
    random_mod.set_rng_state(snap)
    random_mod.split_key()
    assert np.array_equal(key_data(random_mod.current_key()), after)
    assert not np.array_equal(before, after)


def test_outer_stream_advances_one_draw_a_call():
    weights, x, _ = _weights()
    for paddle, rnd, rec, key_data in (
            (tpaddle, trandom, trecompute.recompute,
             lambda k: k.numpy()),
            (jpaddle, jrandom, jrecompute.recompute,
             lambda k: np.asarray(jax.random.key_data(k)))):
        paddle.seed(9)
        layer = _mlp(paddle, 0.2)
        layer.set_state_dict(weights)

        _one_draw(rnd, lambda: rec(layer, paddle.to_tensor(
            x, stop_gradient=False)).sum().backward(), key_data)


def test_backward_on_another_thread_keeps_the_callers_autocast():
    """The recompute runs wherever autograd runs it: on the card, its
    device thread, where the port's thread-local autocast is off."""
    weights, x, _ = _weights()
    nn = tpaddle.nn

    class Matmuls(nn.Layer):           # matmul is on autocast's white list
        def __init__(self):
            super().__init__()
            self.a = nn.Linear(8, 16)
            self.b = nn.Linear(16, 8)

        def forward(self, x):
            h = nn.functional.gelu(tpaddle.matmul(x, self.a.weight))
            return tpaddle.matmul(h, self.b.weight)

    layer = Matmuls()
    layer.set_state_dict(weights)
    grads = {}
    for name in ("recompute", "kept"):
        for p in layer.parameters():
            p.clear_grad()
        xt = tpaddle.to_tensor(x, stop_gradient=False)
        with tpaddle.amp.auto_cast(dtype="bfloat16"):
            y = (trecompute.recompute(layer, xt) if name == "recompute"
                 else layer(xt))
        assert y.dtype == torch.bfloat16
        errors = []

        def backward():
            try:
                y.float().sum().backward()
            except Exception as e:  # noqa: BLE001 - checked below
                errors.append(e)

        worker = threading.Thread(target=backward)
        worker.start()
        worker.join()
        assert errors == []
        grads[name] = [xt.grad, layer.a.weight.grad, layer.b.weight.grad]
    for a, b in zip(grads["recompute"], grads["kept"]):
        assert torch.equal(a, b)


def test_remat_and_no_recompute():
    _, x, w = _weights()

    def f(x, w):
        return torch.tanh(x) @ w

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w)
    want = f(xt, wt)
    for wrapped in (trecompute.remat(f), trecompute.remat(policy="dots")(f),
                    trecompute.remat(f, policy="nothing", prevent_cse=False)):
        got = wrapped(xt, wt)
        assert torch.equal(got, want)
        assert torch.equal(torch.autograd.grad(got.sum(), xt)[0],
                           torch.autograd.grad(f(xt, wt).sum(), xt)[0])
    with pytest.raises(ValueError, match="unknown remat policy"):
        trecompute.remat(f, policy="some")

    def g():
        pass

    assert trecompute.no_recompute(g) is g and g._no_recompute is True
    assert jrecompute.no_recompute(lambda: 0)._no_recompute is True
    # use_reentrant is accepted and changes nothing
    layer_out = _layer_run(tpaddle, lambda fn, *a, **k: trecompute.recompute(
        fn, *a, use_reentrant=False, **k), "full")
    base = _layer_run(tpaddle, trecompute.recompute, "full")
    np.testing.assert_array_equal(layer_out[0], base[0])


# ------------------------------------------------- the program as a whole

V, D, H, FFN, L, S, B = 128, 64, 4, 256, 2, 32, 2


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


def _program(paddle, **kw):
    paddle.seed(0)
    model = prog.build_gpt(paddle, V, D, H, FFN, L, S, **kw)
    missing, unexpected = model.set_state_dict(
        prog.gpt_state_from_params(_params(), L))
    assert not missing and not unexpected
    tokens = np.random.default_rng(1).integers(0, V, (B, S))
    return model, tokens.astype(np.int64), prog.next_token_labels(tokens)


def test_program_with_recompute_trains_as_jax():
    out = {}
    for name, paddle in (("jax", jpaddle), ("torch", tpaddle)):
        model, tokens, labels = _program(paddle, recompute=True)
        out[name] = prog.train(paddle, model, tokens, labels, steps=3)
    np.testing.assert_allclose(out["torch"], out["jax"], **TOL)
    assert out["torch"][-1] < out["torch"][0]


def _grads_after_one_step(**kw):
    model, tokens, labels = _program(tpaddle, dropout=0.1, **kw)
    tpaddle.seed(3)
    loss = prog.loss_fn(tpaddle, model, tpaddle.to_tensor(tokens),
                        tpaddle.to_tensor(labels))
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in model.named_parameters()}


def test_program_with_dropout_is_the_same_function_with_recompute():
    base_loss, base = _grads_after_one_step()
    loss, grads = _grads_after_one_step(recompute=True)
    assert torch.equal(loss, base_loss)
    assert set(grads) == set(base)
    for k in base:
        assert torch.equal(grads[k], base[k]), k
    assert all(b.drop is None for b in _program(tpaddle)[0].blocks)
