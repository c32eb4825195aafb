"""The deep families of ``vision/models.py`` (ResNet-101/152, DenseNet-121)
against the JAX package, the same checks as ``test_torch_vision_zoo.py``,
in a file of their own so that each runs in about a minute: eval-mode
logits at the smallest input
each constructor takes, and train-mode logits (the JAX forward jitted).

Train-mode batch norm normalises over the values a channel holds in the
batch; at 32 x 32 the last stage of a ResNet or DenseNet holds one
position, so its batch norm sees two values and the output is fp32
rounding scaled up (both packages differ from each other by tenths).  So
train mode runs at 4 x 3 x 64 x 64 (16 values a channel there) for the
families with batch norm.  Logits are held at 1e-3 of their largest entry
in train mode (5e-3 for ResNet-152, whose 155 train-mode batch norms
compound it: 1.5e-3 measured) and at 5e-4 in eval mode (depthwise and grouped
convolutions of MobileNet and ShuffleNet sum few terms in another
order).  VGG and AlexNet run at 224 x 224: below it their adaptive
pooling takes the JAX package's non-divisible path, which cannot be
jitted."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu.vision import models as jm

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

BN_TRAIN = (4, 3, 64, 64)
TRAIN_TOL = {"ResNet152": 5e-3}
ZOO = [
    ("ResNet101", lambda m: m.resnet101(num_classes=10), (2, 3, 32, 32),
     BN_TRAIN),
    ("ResNet152", lambda m: m.ResNet(152, num_classes=10), (2, 3, 32, 32),
     BN_TRAIN),
    ("DenseNet121", lambda m: m.densenet121(num_classes=10), (2, 3, 32, 32),
     BN_TRAIN),
]


def _maxrel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _logits(jl, tl, x, train):
    params, buffers = jl.raw_state()
    (jl.train if train else jl.eval)()
    (tl.train if train else tl.eval)()

    def fwd(params, buffers, x):
        with jl.swap_state(params, buffers):
            return jl(jpaddle.Tensor(x)).data

    jo = np.asarray(jax.jit(fwd)(params, buffers, jnp.asarray(x)))
    with torch.no_grad():
        return tl(torch.from_numpy(x)).numpy(), jo


@pytest.mark.parametrize("name,ctor,shape,train_shape", ZOO,
                         ids=[z[0] for z in ZOO])
def test_family_logits_train_and_eval(name, ctor, shape, train_shape):
    """Models with dropout (VGG, AlexNet, SqueezeNet) draw different masks
    in the two packages: their train-mode logits are held to shape and
    finiteness, their eval-mode logits to the values."""
    jl, tl = pair(lambda: ctor(jm), lambda: ctor(tm))
    assert list(tl.state_dict()) == list(jl.state_dict())
    to, jo = _logits(jl, tl, rand(shape, 5), train=False)
    assert _maxrel(to, jo) <= 5e-4
    to, jo = _logits(jl, tl, rand(train_shape or shape, 6), train=True)
    if train_shape is None and name != "LeNet":
        assert to.shape == jo.shape and np.isfinite(to).all()
    else:
        assert _maxrel(to, jo) <= TRAIN_TOL.get(name, 1e-3)
