"""The port's autocast (``amp/``) against the JAX package's.

O1 follows the JAX package's white and black lists (not
``torch.autocast``'s): every layer of a ResNet-18 hands on the dtype the
JAX layer hands on, under ``auto_cast`` in train and eval mode, and the
eval logits agree at 2e-2 of their largest entry (bf16 convolutions: one
rounding of each output, in another summation order, over 18 layers).
The per-op rules, custom lists, ``decorate`` (O2) and ``GradScaler``'s
loss-scale state machine over a run with injected infs are held exactly."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu.vision import models as jm

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.vision import models as tm
from torch_eager_ref import pair, rand



@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Four threads for these large CPU convolutions, then the count the
    other test modules set (some hold results bit for bit)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _record(layer, named, store, dtype_of):
    handles = []
    for name, sub in named(layer):
        if name:
            handles.append(sub.register_forward_post_hook(
                (lambda n: lambda lay, args, out: store.__setitem__(
                    n, dtype_of(out)))(name)))
    return handles


@pytest.mark.parametrize("train", [True, False])
def test_o1_resnet18_dtype_flow_and_logits(train):
    jl, tl = pair(lambda: jm.resnet18(num_classes=10),
                  lambda: tm.resnet18(num_classes=10))
    x = rand((2, 3, 32, 32), 0)
    jdt, tdt = {}, {}
    _record(jl, lambda l: l.named_sublayers(), jdt,
            lambda o: str(o.data.dtype))
    _record(tl, lambda l: l.named_sublayers(), tdt,
            lambda o: str(o.dtype).replace("torch.", ""))
    (jl.train if train else jl.eval)()
    (tl.train if train else tl.eval)()
    params, buffers = jl.raw_state()

    def fwd(params, buffers, x):
        with jl.swap_state(params, buffers), \
                jpaddle.amp.auto_cast(dtype="bfloat16"):
            return jl(jpaddle.Tensor(x)).data

    jo = np.asarray(jax.jit(fwd)(params, buffers, jnp.asarray(x)))
    with torch.no_grad(), tpaddle.amp.auto_cast(dtype="bfloat16"):
        to = tl(torch.from_numpy(x))
    assert tdt == jdt
    # the flow the bench describes: convolutions bf16, batch norm fp32
    assert tdt["conv1"] == "bfloat16" and tdt["bn1"] == "float32"
    assert tdt["layer1.0.relu"] == "float32" and tdt["fc"] == "float32"
    assert to.dtype == torch.float32
    if not train:
        err = np.abs(to.numpy() - jo).max() / np.abs(jo).max()
        assert err <= 2e-2, err


def _t(shape, seed, dtype=torch.float32):
    return torch.from_numpy(rand(shape, seed)).to(dtype)


def test_o1_op_rules():
    x, w = _t((2, 3, 5, 5), 0), _t((4, 3, 3, 3), 1)
    with tpaddle.amp.auto_cast():
        y = tops.conv2d(x, w, _t((4,), 2))
        assert y.dtype == torch.bfloat16               # white
        out, m, v = tops.batch_norm_train(y, _t((4,), 3), _t((4,), 4))
        assert out.dtype == m.dtype == v.dtype == torch.float32  # black
        assert tops.relu(y).dtype == torch.bfloat16     # neither list
        assert tops.layer_norm(y, _t((3,), 5)).dtype == torch.float32
        lin = tnn.Linear(3, 2)
        assert tops.matmul(y, lin.weight).dtype == torch.bfloat16
        assert lin(y).dtype == torch.float32           # bf16 out + fp32 bias
        logits = tops.matmul(_t((4, 6), 6), _t((6, 3), 7))
        loss = tops.cross_entropy(logits, torch.tensor([0, 1, 2, 0]))
        assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
        assert tops.softmax(logits).dtype == torch.float32
    assert tops.conv2d(x, w).dtype == torch.float32   # off outside


def test_custom_lists_and_jax_agreement():
    x, w = rand((2, 3, 5, 5), 0), rand((4, 3, 3, 3), 1)
    with tpaddle.amp.auto_cast(custom_black_list={"conv2d"}):
        assert tops.conv2d(torch.from_numpy(x),
                           torch.from_numpy(w)).dtype == torch.float32
    with tpaddle.amp.auto_cast(custom_white_list={"relu"}):
        assert tops.relu(torch.from_numpy(x)).dtype == torch.bfloat16
    with tpaddle.amp.auto_cast(enable=False):
        assert tops.conv2d(torch.from_numpy(x),
                           torch.from_numpy(w)).dtype == torch.float32
    with tpaddle.amp.auto_cast(dtype="float16"):
        assert tops.conv2d(torch.from_numpy(x),
                           torch.from_numpy(w)).dtype == torch.float16
    import importlib

    jac = importlib.import_module("paddle_tpu.amp.auto_cast")
    tac = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

    assert tac.WHITE_LIST == jac.WHITE_LIST
    assert tac.BLACK_LIST == jac.BLACK_LIST


def test_decorate_o2_casts_parameters():
    net = tnn.Sequential(tnn.Linear(4, 3), tnn.LayerNorm(3))
    out = tpaddle.amp.decorate(net, level="O2", dtype="bfloat16")
    assert out is net
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    y = net(torch.randn(2, 4).bfloat16())
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    nets, opt = tpaddle.amp.decorate([net], optimizers="opt")
    assert nets == [net] and opt == "opt"


def test_grad_scaler_sequence_equals_jax():
    """Ten steps with an inf gradient at steps 2, 3 and 7, dynamic scaling
    (increase every 2 good steps, decrease after 1 bad one): the scale
    after every step, the skipped steps and the parameters are the JAX
    package's."""
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    w0 = rand((3,), 0)
    jp_ = jpaddle.core.tensor.Parameter(jnp.asarray(w0))
    jopt = jpaddle.optimizer.SGD(0.1, parameters=[jp_])
    js = jpaddle.amp.GradScaler(**kw)
    tp_ = tnn.Parameter(torch.from_numpy(w0.copy()))
    topt = tpaddle.optimizer.SGD(0.1, parameters=[tp_])
    ts = tpaddle.amp.GradScaler(**kw)
    jscales, tscales = [], []
    for step in range(10):
        g = rand((3,), step + 1) * js.get_loss_scaling()
        if step in (2, 3, 7):
            g[1] = np.inf
        jp_.grad = jpaddle.Tensor(jnp.asarray(g))
        tp_.grad = torch.from_numpy(g.copy())
        js.step(jopt)
        ts.step(topt)
        jscales.append(js.get_loss_scaling())
        tscales.append(ts.get_loss_scaling())
    assert tscales == jscales
    assert len(set(tscales)) > 2                     # it moved both ways
    np.testing.assert_allclose(tp_.detach().numpy(), np.asarray(jp_.data),
                               rtol=1e-6)
    assert ts.state_dict() == js.state_dict()
    loss = torch.tensor(2.0)
    assert float(ts.scale(loss)) == 2.0 * ts.get_loss_scaling()
