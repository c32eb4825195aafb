"""The layers this slice adds to the port's ``nn`` (``Embedding``,
``Dropout2D``, ``Pad2D``, ``Upsample`` and its two subclasses,
``Bilinear``, ``CosineSimilarity``, ``Unfold``, ``InstanceNorm2D``,
``RMSNorm``, ``SyncBatchNorm``, ``SpectralNorm``, ``SELU``) against the
JAX package's: the JAX weights carried over by name, outputs, the loss,
every parameter gradient and the input gradient at 1e-5, in the style of
``tests/test_torch_nn.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn as tnn
from torch_eager_ref import (assert_vjp_close, carry, jax_state, jax_vjp,
                             pair, rand, torch_vjp)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SINGLE = [
    ("Pad2D", dict(padding=[1, 2, 0, 1]), (2, 3, 4, 5)),
    ("Pad2D", dict(padding=[1, 1, 2, 2], mode="reflect"), (2, 3, 4, 5)),
    ("Upsample", dict(scale_factor=2), (1, 2, 3, 4)),
    ("Upsample", dict(size=(5, 7), mode="bilinear"), (1, 2, 3, 4)),
    ("UpsamplingNearest2D", dict(size=(6, 8)), (1, 2, 3, 4)),
    ("UpsamplingBilinear2D", dict(scale_factor=2), (1, 2, 3, 4)),
    ("Unfold", dict(kernel_sizes=2, strides=1), (2, 3, 4, 4)),
    ("Unfold", dict(kernel_sizes=[3, 2], paddings=1, strides=2),
     (1, 2, 5, 6)),
    ("InstanceNorm2D", dict(num_features=3), (2, 3, 4, 4)),
    ("RMSNorm", dict(hidden_size=8), (3, 5, 8)),
    ("SyncBatchNorm", dict(num_features=3), (4, 3, 2, 2)),
    ("SELU", {}, (3, 4)),
    ("Dropout2D", dict(p=0.5), (2, 3, 4, 4)),
]


@pytest.mark.parametrize("name,kw,shape", SINGLE,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(SINGLE)])
def test_layer_matches_jax(name, kw, shape):
    jl, tl = pair(lambda: getattr(jnn, name)(**kw),
                  lambda: getattr(tnn, name)(**kw))
    # Dropout2D is checked in eval (identity); its training draws are
    # the port's generator's (tests/test_torch_ops.py holds their rate)
    train = name != "Dropout2D"
    x = rand(shape, 3)
    assert_vjp_close(jax_vjp(jl, x, train=train),
                     torch_vjp(tl, x, train=train), **TOL)


def test_sync_batch_norm_converts_and_is_batch_norm_on_one_card():
    jpaddle.seed(0)
    tpaddle.seed(0)
    net = tnn.Sequential(tnn.Conv2D(3, 4, 3), tnn.BatchNorm2D(4))
    conv = tnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(conv[1], tnn.SyncBatchNorm)
    ref = tnn.BatchNorm2D(4)
    ref.set_state_dict(net[1].state_dict())
    x = torch.from_numpy(rand((2, 3, 6, 6), 1))
    h = conv[0](x)
    torch.testing.assert_close(conv[1](h), ref(h), **TOL)
    torch.testing.assert_close(conv[1]._mean, ref._mean, **TOL)


def test_embedding_matches_jax():
    jl, tl = pair(lambda: jnn.Embedding(11, 6, padding_idx=3),
                  lambda: tnn.Embedding(11, 6, padding_idx=3))
    assert np.all(np.asarray(jax_state(jl)["weight"])[3] == 0)
    assert torch.all(tl.weight[3] == 0)
    ids = np.random.RandomState(0).randint(0, 11, (4, 5))
    ct = rand((4, 5, 6), 2)
    params, buffers = jl.raw_state()

    def loss(params):
        with jl.swap_state(params, buffers):
            out = jl(jpaddle.Tensor(jnp.asarray(ids))).data
        return jnp.sum(out * ct), out

    (jval, jout), jg = jax.value_and_grad(loss, has_aux=True)(params)
    tout = tl(torch.from_numpy(ids))
    tval = (tout * torch.from_numpy(ct)).sum()
    tval.backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(tval), float(jval), **TOL)
    np.testing.assert_allclose(tl.weight.grad.numpy(),
                               np.asarray(jg["weight"]), **TOL)


@pytest.mark.parametrize("name", ["Bilinear", "CosineSimilarity"])
def test_two_input_layer_matches_jax(name):
    if name == "Bilinear":
        jl, tl = pair(lambda: jnn.Bilinear(4, 5, 3),
                      lambda: tnn.Bilinear(4, 5, 3))
        x1, x2 = rand((6, 4), 1), rand((6, 5), 2)
    else:
        jl, tl = pair(lambda: jnn.CosineSimilarity(axis=1),
                      lambda: tnn.CosineSimilarity(axis=1))
        x1, x2 = rand((6, 4), 1), rand((6, 4), 2)
    params, buffers = jl.raw_state()

    def loss(params, a, b):
        with jl.swap_state(params, buffers):
            out = jl(jpaddle.Tensor(a), jpaddle.Tensor(b)).data
        return jnp.sum(out * jnp.arange(out.size).reshape(out.shape)), out

    (jval, jout), (jg, ja, jb) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(x1),
                                              jnp.asarray(x2))
    t1 = torch.tensor(x1, requires_grad=True)
    t2 = torch.tensor(x2, requires_grad=True)
    tout = tl(t1, t2)
    tval = (tout * torch.arange(tout.numel()).reshape(tout.shape)).sum()
    tval.backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(jb), **TOL)
    for k, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[k]), **TOL)


def test_spectral_norm_matches_jax():
    jl, tl = pair(lambda: jnn.SpectralNorm([4, 6], dim=0, power_iters=3),
                  lambda: tnn.SpectralNorm([4, 6], dim=0, power_iters=3))
    w = rand((4, 6), 5)
    jout = jl(jpaddle.to_tensor(w)).numpy()
    tout = tl(torch.from_numpy(w))
    np.testing.assert_allclose(tout.detach().numpy(), jout, **TOL)
    assert not tl.weight_u.requires_grad and not tl.weight_v.requires_grad


def test_layer_names_match_the_jax_nn():
    """Every layer class of the JAX ``nn`` this slice covers exists in the
    port's ``nn`` (``rnn.py``'s are a later slice)."""
    from paddle_tpu.nn.layer import (activation, common, conv, loss, norm,
                                     pooling, transformer)

    for mod in (activation, common, conv, loss, norm, pooling, transformer):
        for name in mod.__all__:
            assert hasattr(tnn, name), f"{mod.__name__}.{name}"


def test_functional_exports_match_the_jax_functional():
    import paddle_tpu.nn.functional as jF

    import paddle_tpu_torch.nn.functional as tF

    # the JAX ops modules have no __all__, so the star imports also carry
    # their helpers: the registry's decorator, the PRNG key splitter and
    # the MXU precision policy (the port's is ops/linalg.py's _exact)
    helpers = {"register_op", "split_key", "mxu_precision"}
    names = {n for n in dir(jF) if not n.startswith("_")
             and callable(getattr(jF, n))} - helpers
    missing = sorted(n for n in names if not hasattr(tF, n))
    assert missing == [], missing
