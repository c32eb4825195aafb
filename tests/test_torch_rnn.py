"""The port's recurrent layers (``nn/layer/rnn.py``) against the JAX
package's: weights carried by name (``tests/torch_eager_ref.py``), the
same seeded inputs and cotangents, outputs, final states and every
gradient (parameters and input) at fp32 1e-5.

The JAX ``_MultiLayerRNN.forward`` drops ``initial_states`` (ROADMAP §3,
reference faults), so the comparisons with JAX run without them; the
port honours them, and a further test holds its layers, given states,
to a loop of its own cells."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from torch_eager_ref import assert_vjp_close, jax_vjp, pair, rand, \
    torch_vjp

TOL = dict(atol=1e-5, rtol=1e-5)
CELLS = {"SimpleRNNCell": 1, "LSTMCell": 4, "GRUCell": 3}


def _flat_states(s):
    if isinstance(s, (tuple, list)):
        return [a for x in s for a in _flat_states(x)]
    return [s]


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("with_state", [False, True])
def test_cell_step_and_grads_match_jax(name, with_state):
    """One cell step: output, new state, and gradients of every
    parameter, the input and the incoming state."""
    jcell, tcell = pair(lambda: getattr(jpaddle.nn, name)(5, 7),
                        lambda: getattr(tpaddle.nn, name)(5, 7))
    assert sorted(dict(tcell.named_parameters())) == \
        ["bias_hh", "bias_ih", "weight_hh", "weight_ih"]
    assert tuple(tcell.weight_ih.shape) == (CELLS[name] * 7, 5)
    x = rand((3, 5), 0)
    h = rand((3, 7), 1)
    c = rand((3, 7), 2)
    lstm = name == "LSTMCell"
    params, _ = jcell.raw_state()

    def jloss(params, x, h, c):
        with jcell.swap_state(params, {}):
            st = None if not with_state else (
                (jpaddle.Tensor(h), jpaddle.Tensor(c)) if lstm
                else jpaddle.Tensor(h))
            out, new = jcell(jpaddle.Tensor(x), st)
        leaves = [out.data] + [t.data for t in _flat_states(new)]
        return sum(jnp.sum(l * (k + 1) * 0.5) for k, l in enumerate(leaves)), \
            leaves

    (jv, jleaves), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    tp = dict(tcell.named_parameters())
    tx, th, tc = (torch.tensor(a, requires_grad=True) for a in (x, h, c))
    st = None if not with_state else ((th, tc) if lstm else th)
    out, new = tcell(tx, st)
    leaves = [out] + _flat_states(new)
    tv = sum((l * (k + 1) * 0.5).sum() for k, l in enumerate(leaves))
    grads = torch.autograd.grad(tv, list(tp.values()) + [tx, th, tc],
                                allow_unused=True)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    for k, g in zip(tp, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[0][k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(grads[len(tp)].numpy(), np.asarray(jg[1]),
                               **TOL)
    if with_state:
        np.testing.assert_allclose(grads[len(tp) + 1].numpy(),
                                   np.asarray(jg[2]), **TOL)
        if lstm:
            np.testing.assert_allclose(grads[len(tp) + 2].numpy(),
                                       np.asarray(jg[3]), **TOL)


class _OutOnly:
    """Wraps a multi-layer RNN so the vjp runners see one output."""

    @staticmethod
    def make(base, **kw):
        class Net(base.nn.Layer):
            def __init__(self):
                super().__init__()
                self.rnn = getattr(base.nn, kw["kind"])(
                    5, 6, num_layers=2, direction=kw["direction"],
                    time_major=kw["time_major"])

            def forward(self, x):
                out, _ = self.rnn(x)
                return out

        return Net


@pytest.mark.parametrize("kind", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("time_major", [False, True])
def test_multilayer_outputs_and_grads_match_jax(kind, direction,
                                                time_major):
    kw = dict(kind=kind, direction=direction, time_major=time_major)
    jnet, tnet = pair(_OutOnly.make(jpaddle, **kw),
                      _OutOnly.make(tpaddle, **kw))
    x = rand((4, 3, 5) if time_major else (3, 4, 5), 3)
    assert_vjp_close(jax_vjp(jnet, x), torch_vjp(tnet, x), **TOL)


@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
def test_final_states_match_jax(kind):
    jl, tl = pair(lambda: getattr(jpaddle.nn, kind)(5, 6, num_layers=2,
                                                    direction="bidirect"),
                  lambda: getattr(tpaddle.nn, kind)(5, 6, num_layers=2,
                                                    direction="bidirect"))
    x = rand((3, 4, 5), 4)
    jout, jst = jl(jpaddle.Tensor(x))
    tout, tst = tl(torch.tensor(x))
    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout.data), **TOL)
    js, ts = _flat_states(jst), _flat_states(tst)
    assert len(js) == len(ts) == (8 if kind == "LSTM" else 4)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b.data),
                                   **TOL)


@pytest.mark.parametrize("kind", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("layout", ["paddle", "per_layer"])
def test_initial_states_are_honoured(kind, layout):
    """Given states, the port's layer equals a loop of its own cells
    started from them (the JAX layer drops them: a reference fault)."""
    tpaddle.seed(0)
    L, D, B, T, H = 2, 2, 3, 4, 6
    net = getattr(tpaddle.nn, kind)(5, H, num_layers=L, direction="bidirect")
    x = torch.tensor(rand((B, T, 5), 5))
    h0 = torch.tensor(rand((L * D, B, H), 6))
    c0 = torch.tensor(rand((L * D, B, H), 7))
    lstm = kind == "LSTM"
    per = [(h0[i], c0[i]) if lstm else h0[i] for i in range(L * D)]
    init = (((h0, c0) if lstm else h0) if layout == "paddle" else per)
    out, states = net(x, init)

    inp = x
    want_states = []
    for layer in range(L):
        outs = []
        for d in range(D):
            cell = net.layers[layer * D + d].cell
            st = per[layer * D + d]
            steps = range(T - 1, -1, -1) if d else range(T)
            ys = [None] * T
            for t in steps:
                y, st = cell(inp[:, t], st)
                ys[t] = y
            outs.append(torch.stack(ys, 1))
            want_states.append(st)
        inp = torch.cat(outs, -1)
    np.testing.assert_allclose(out.detach().numpy(), inp.detach().numpy(),
                               atol=1e-6, rtol=1e-6)
    for a, b in zip(_flat_states(states), _flat_states(want_states)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, rtol=1e-6)
    zero, _ = net(x)
    assert not torch.allclose(zero, out)


def test_wrong_number_of_initial_states_is_loud():
    net = tpaddle.nn.GRU(5, 6, num_layers=2)
    with pytest.raises(ValueError, match="initial_states"):
        net(torch.zeros(2, 3, 5), [torch.zeros(2, 6)])


def test_rnn_wrapper_reverse_matches_jax():
    jr, tr = pair(lambda: jpaddle.nn.RNN(jpaddle.nn.GRUCell(5, 4),
                                         is_reverse=True),
                  lambda: tpaddle.nn.RNN(tpaddle.nn.GRUCell(5, 4),
                                         is_reverse=True))
    x = rand((2, 6, 5), 8)
    jo, js = jr(jpaddle.Tensor(x))
    to, ts = tr(torch.tensor(x))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo.data),
                               **TOL)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js.data),
                               **TOL)
