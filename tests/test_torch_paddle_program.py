"""The whole slice on the CPU: one Paddle-style GPT program
(``paddle_tpu_torch/models/paddle_gpt.py``, written against the top-level
surface only) run with ``paddle = paddle_tpu`` and with ``paddle =
paddle_tpu_torch`` — 2 layers, hidden 64, 4 heads, sequence 32, the same
initial weights from a numpy seed, 3 AdamW steps in fp32: the losses and
every parameter after the steps agree at 1e-5.  The JAX side takes the
attention route ``paddle_tpu/ops/attention.py`` chooses on the CPU.  The
step-0 loss also equals the port's ``gpt_loss`` on the same tree."""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.models import paddle_gpt as prog

TOL = dict(atol=1e-5, rtol=1e-5)
V, D, H, FFN, L, S, B = 128, 64, 4, 256, 2, 32, 2


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    tpaddle.set_device("cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _params(seed=0):
    """A ``gpt_init``-shaped tree of numpy arrays (its init stds)."""
    rng = np.random.default_rng(seed)

    def n(*shape, std=0.02):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    resid = 0.02 / np.sqrt(2 * L)
    return {
        "wte": n(V, D), "wpe": n(S, D, std=0.01),
        "lnf_g": 1 + n(D), "lnf_b": n(D),
        "blocks": {
            "ln1_g": 1 + n(L, D), "ln1_b": n(L, D),
            "qkv_w": n(L, D, 3 * D), "qkv_b": n(L, 3 * D),
            "proj_w": n(L, D, D, std=resid), "proj_b": n(L, D),
            "ln2_g": 1 + n(L, D), "ln2_b": n(L, D),
            "up_w": n(L, D, FFN), "up_b": n(L, FFN),
            "down_w": n(L, FFN, D, std=resid), "down_b": n(L, D)},
    }


def _model(paddle, params):
    paddle.seed(0)
    model = prog.build_gpt(paddle, V, D, H, FFN, L, S)
    state = prog.gpt_state_from_params(params, L)
    missing, unexpected = model.set_state_dict(state)
    assert not missing and not unexpected, (missing, unexpected)
    return model


def _batch(seed=1):
    tokens = np.random.default_rng(seed).integers(0, V, (B, S))
    return tokens.astype(np.int64), prog.next_token_labels(tokens)


def _numpy_state(model):
    return {k: np.asarray(v.detach().numpy(), dtype=np.float32)
            for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def runs():
    params = _params()
    tokens, labels = _batch()
    out = {}
    for name, paddle in (("jax", jpaddle), ("torch", tpaddle)):
        model = _model(paddle, params)
        losses = prog.train(paddle, model, tokens, labels, steps=3)
        out[name] = (losses, _numpy_state(model))
    return out


def test_losses_agree(runs):
    jl, tl = runs["jax"][0], runs["torch"][0]
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]


def test_parameters_agree_after_three_steps(runs):
    js, ts = runs["jax"][1], runs["torch"][1]
    assert sorted(js) == sorted(ts)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], err_msg=k, **TOL)


def test_step_zero_loss_is_gpt_loss():
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_loss

    params = _params()
    tokens, labels = _batch()
    cfg = GPTConfig(vocab_size=V, max_seq_len=S, hidden=D, num_layers=L,
                    num_heads=H, ffn_hidden=FFN, dtype="float32",
                    remat="nothing")
    tree = {"wte": params["wte"], "wpe": params["wpe"],
            "lnf_g": params["lnf_g"], "lnf_b": params["lnf_b"],
            "blocks": params["blocks"]}
    tree = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in tree.items()}
    want = gpt_loss(cfg, tree, torch.from_numpy(tokens))
    model = _model(tpaddle, params)
    got = prog.loss_fn(tpaddle, model, tpaddle.to_tensor(tokens),
                       tpaddle.to_tensor(labels))
    np.testing.assert_allclose(float(got), float(want), **TOL)
