"""The port's ResNets (``vision/models.py``) against the JAX package's,
which has no test of its own: weights carried across by name, then one
training-mode forward and backward at 2 x 3 x 64 x 64 (the JAX side jitted
with ``jax.value_and_grad``), and eval-mode logits of ResNet-18/34/50.
``test_torch_vision_zoo.py`` covers the other families.

Tolerances.  ResNet-18: logits, loss, every gradient and every batch-norm
buffer at 1e-4 (atol and rtol).  ResNet-50's training step is
ill-conditioned in fp32 at this size: train-mode batch norm over the few
values a channel of layer3/layer4 holds divides rounding error by a small
spread, so the JAX package and the port each differ from a float64
evaluation by up to tenths of a gradient tensor's largest entry.  So its
loss is held at 1e-4 relative, its logits and buffers at 1e-3 of their
largest entry, and each gradient tensor against the port's own float64
evaluation: each package's error is at most half the tensor's largest
entry, and over all 161 gradients together (the L2 norm of the
difference over that of the float64 gradients) the port's error is at
most twice the JAX package's, which is at most 0.1."""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
from paddle_tpu.vision import models as jm

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.vision import models as tm
from torch_eager_ref import (assert_vjp_close, jax_vjp, pair, rand,
                             torch_vjp)



@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Four threads for these large CPU convolutions, then the count the
    other test modules set (some hold results bit for bit)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)
TOL = dict(atol=1e-4, rtol=1e-4)


def _maxrel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_resnet18_training_step():
    jl, tl = pair(lambda: jm.resnet18(num_classes=10),
                  lambda: tm.resnet18(num_classes=10))
    x, y = rand((2, 3, 64, 64), 0), np.array([3, 7], np.int64)
    j = jax_vjp(jl, x, loss_fn=jnn.CrossEntropyLoss(), y=y)
    t = torch_vjp(tl, x, loss_fn=tnn.CrossEntropyLoss(), y=y)
    assert_vjp_close(j, t, **TOL)
    assert len(t[4]) == 40                          # 20 BN layers


def test_resnet50_training_step():
    jl, tl = pair(lambda: jm.resnet50(num_classes=10),
                  lambda: tm.resnet50(num_classes=10))
    ref64 = copy.deepcopy(tl).double()
    x, y = rand((2, 3, 64, 64), 0), np.array([3, 7], np.int64)
    jo, jloss, jg, jgx, jb = jax_vjp(jl, x, loss_fn=jnn.CrossEntropyLoss(),
                                     y=y)
    to, tloss, tg, tgx, tb = torch_vjp(tl, x, loss_fn=tnn.CrossEntropyLoss(),
                                       y=y)
    _, loss64, g64, _, _ = torch_vjp(ref64, x.astype(np.float64),
                                     loss_fn=tnn.CrossEntropyLoss(), y=y)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    np.testing.assert_allclose(tloss, loss64, rtol=1e-4)
    assert _maxrel(to, jo) <= 1e-3
    assert sorted(tb) == sorted(jb) and len(tb) == 106
    for k in jb:
        assert _maxrel(tb[k], jb[k]) <= 1e-3, k
    assert sorted(tg) == sorted(jg) and len(tg) == 161
    for k in jg:
        assert _maxrel(jg[k], g64[k]) <= 0.5, k
        assert _maxrel(tg[k], g64[k]) <= 0.5, k
    flat = lambda g: np.concatenate([g[k].ravel() for k in sorted(g)])  # noqa
    ref = flat(g64)
    e_jax = np.linalg.norm(flat(jg) - ref) / np.linalg.norm(ref)
    e_port = np.linalg.norm(flat(tg) - ref) / np.linalg.norm(ref)
    assert e_jax <= 0.1 and e_port <= max(2 * e_jax, 1e-4), (e_port, e_jax)


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50"])
def test_resnet_eval_logits(name):
    """Eval-mode batch norm is well conditioned: the logits agree at 1e-5
    of their largest entry (they reach hundreds: the random-init residual
    stream grows with depth)."""
    jl, tl = pair(lambda: getattr(jm, name)(num_classes=10),
                  lambda: getattr(tm, name)(num_classes=10), seed=1)
    x = rand((2, 3, 32, 32), 2)
    jo = jax_vjp(jl, x, train=False)[0]
    to = torch_vjp(tl, x, train=False)[0]
    assert _maxrel(to, jo) <= 1e-5


def test_resnet50_structure_matches_jax():
    """267 state-dict entries: 161 parameters plus the 106 _mean /
    _variance buffers, under the JAX names."""
    tl = tm.resnet50(num_classes=10)
    jl = jm.resnet50(num_classes=10)
    assert list(tl.state_dict()) == list(jl.state_dict())
    assert len(tl.state_dict()) == 267 and len(tl.parameters()) == 161
    assert tuple(tl.fc.weight.shape) == (2048, 10)   # Paddle's [in, out]
