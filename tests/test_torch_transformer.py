"""The port's ``nn.MultiHeadAttention`` and ``nn.Transformer*`` layers
against the JAX package's at dropout 0 (forward, every weight gradient
and the input gradient at 1e-4; the JAX side jitted), the routing of
``scaled_dot_product_attention`` (flash when its gate holds and no
dropout is drawn, as in JAX), and attention dropout by property: the
keep rate, the 1/keep scale, eval equal to no dropout, and the same mask
for the same seed."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.ops import attention as tatt
from torch_eager_ref import (assert_vjp_close, carry, jax_vjp, pair, rand,
                             torch_vjp)



@pytest.fixture(autouse=True, scope="module")
def _threads():
    """One thread for these small layers, then the count the other test
    modules set.  More threads buy nothing here and cost reproducibility:
    on the first parallel call after the thread count grows, PyTorch's
    CPU ``exp`` can return values up to 1e-4 off on a worker thread, and
    the attention backward's ``dP - delta`` cancellation carries that
    into gradients beyond this file's 1e-4 tolerance."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seq", [16, 128])
def test_multi_head_attention(seq):
    """S = 16 takes the naive route in both packages; S = 128 takes flash
    (the JAX kernel in interpret mode, the port's plain versions)."""
    jl, tl = pair(lambda: jnn.MultiHeadAttention(32, 4),
                  lambda: tnn.MultiHeadAttention(32, 4))
    x = rand((2, seq, 32), 1)
    assert_vjp_close(jax_vjp(jl, x), torch_vjp(tl, x), **TOL)


def _jax_call(layer, *arrays, **kw):
    params, buffers = layer.raw_state()

    def fwd(params, *xs):
        with layer.swap_state(params, buffers):
            out = layer(*[jpaddle.Tensor(a) for a in xs], **{
                k: jpaddle.Tensor(v) for k, v in kw.items()})
        return out.data

    return np.asarray(jax.jit(fwd)(params, *map(jnp.asarray, arrays)))


def test_multi_head_attention_cross_mask_and_cache():
    jl, tl = pair(lambda: jnn.MultiHeadAttention(32, 4, kdim=24, vdim=16),
                  lambda: tnn.MultiHeadAttention(32, 4, kdim=24, vdim=16))
    q, k, v = rand((2, 6, 32), 1), rand((2, 9, 24), 2), rand((2, 9, 16), 3)
    mask = np.where(rand((6, 9), 4) > 0.5, -1e4, 0.0).astype(np.float32)
    jo = _jax_call(jl, q, k, v, attn_mask=mask)
    with torch.no_grad():
        to = tl(*map(torch.from_numpy, (q, k, v)),
                attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    jl, tl = pair(lambda: jnn.MultiHeadAttention(16, 2),
                  lambda: tnn.MultiHeadAttention(16, 2))
    cache = (torch.from_numpy(rand((1, 2, 3, 8), 5)),
             torch.from_numpy(rand((1, 2, 3, 8), 6)))
    with torch.no_grad():
        out, (ck, cv) = tl(torch.from_numpy(rand((1, 4, 16), 7)),
                           cache=cache)
    assert out.shape == (1, 4, 16) and ck.shape == (1, 2, 7, 8)


LAYERS = [
    ("encoder_layer", lambda m: m.TransformerEncoderLayer(
        32, 4, 64, dropout=0.0), (2, 16, 32)),
    ("encoder_layer_pre_ln_gelu", lambda m: m.TransformerEncoderLayer(
        32, 4, 64, dropout=0.0, activation="gelu", normalize_before=True),
     (2, 16, 32)),
    ("encoder", lambda m: m.TransformerEncoder(m.TransformerEncoderLayer(
        32, 4, 64, dropout=0.0), 2, norm=m.LayerNorm(32)), (2, 16, 32)),
    ("encoder_flash", lambda m: m.TransformerEncoder(
        m.TransformerEncoderLayer(32, 4, 64, dropout=0.0), 2),
     (1, 128, 32)),
]


@pytest.mark.parametrize("name,ctor,shape", LAYERS, ids=[l[0] for l in LAYERS])
def test_encoder_layers(name, ctor, shape):
    jl, tl = pair(lambda: ctor(jnn), lambda: ctor(tnn))
    assert list(tl.state_dict()) == list(jl.state_dict())
    x = rand(shape, 2)
    assert_vjp_close(jax_vjp(jl, x), torch_vjp(tl, x), **TOL)


@pytest.mark.parametrize("pre", [False, True])
def test_decoder_and_transformer(pre):
    jl, tl = pair(lambda: jnn.Transformer(32, 4, 2, 2, 64, dropout=0.0,
                                          normalize_before=pre),
                  lambda: tnn.Transformer(32, 4, 2, 2, 64, dropout=0.0,
                                          normalize_before=pre))
    assert list(tl.state_dict()) == list(jl.state_dict())
    src, tgt = rand((2, 10, 32), 1), rand((2, 7, 32), 2)
    mask = np.asarray(jnn.Transformer.generate_square_subsequent_mask(7).data)
    np.testing.assert_array_equal(
        tnn.Transformer.generate_square_subsequent_mask(7).numpy(), mask)
    jo = _jax_call(jl, src, tgt, tgt_mask=mask)
    src_t, tgt_t = torch.tensor(src, requires_grad=True), torch.tensor(tgt)
    to = tl(src_t, tgt_t, tgt_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(to.detach().numpy(), jo, **TOL)
    to.sum().backward()
    assert torch.isfinite(src_t.grad).all() and src_t.grad.abs().sum() > 0


def test_sdpa_routing(monkeypatch):
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q = torch.from_numpy(rand((1, 2, 128, 16), 0))
    sdpa = tpaddle.nn.functional.scaled_dot_product_attention
    sdpa(q, q, q)
    assert len(calls) == 1                            # gate holds
    sdpa(q, q, q, dropout_p=0.1, training=False)
    assert len(calls) == 2                            # no dropout drawn
    sdpa(q, q, q, dropout_p=0.1, training=True)
    sdpa(q, q, q, attn_mask=torch.zeros(128, 128))
    sdpa(q[:, :, :100], q[:, :, :100], q[:, :, :100])  # S % 128 != 0
    sdpa(q, q, q, use_flash=False)
    assert len(calls) == 2


def test_attention_dropout_properties():
    """With v the identity the output is the dropped probabilities."""
    B, H, S = 2, 2, 64
    q = torch.from_numpy(rand((B, H, S, S), 0))
    k = torch.from_numpy(rand((B, H, S, S), 1))
    v = torch.eye(S).expand(B, H, S, S)
    probs = tatt._naive_attention(q, k, v, training=False)
    tpaddle.seed(3)
    a = tatt._naive_attention(q, k, v, dropout_p=0.25)
    tpaddle.seed(3)
    b = tatt._naive_attention(q, k, v, dropout_p=0.25)
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    torch.testing.assert_close(a[kept], probs[kept] / 0.75)
    assert torch.equal(tatt._naive_attention(q, k, v, dropout_p=0.25,
                                             training=False), probs)


def test_encoder_attention_dropout_train_and_eval():
    tpaddle.seed(0)
    enc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        32, 4, 64, dropout=0.0, attn_dropout=0.3), 2)
    x = torch.from_numpy(rand((2, 16, 32), 1))
    enc.eval()
    with torch.no_grad():
        e1, e2 = enc(x), enc(x)
    assert torch.equal(e1, e2)
    enc.train()
    tpaddle.seed(4)
    t1 = enc(x)
    tpaddle.seed(4)
    t2 = enc(x)
    assert torch.equal(t1, t2) and not torch.allclose(t1, e1)
    t1.sum().backward()
    assert all(p.grad is not None for p in enc.parameters())


def test_multi_head_attention_under_autocast_matches_jax_dtypes():
    jl, tl = pair(lambda: jnn.MultiHeadAttention(32, 4),
                  lambda: tnn.MultiHeadAttention(32, 4))
    x = rand((2, 16, 32), 1)
    params, buffers = jl.raw_state()

    def fwd(params, x):
        with jl.swap_state(params, buffers), jpaddle.amp.auto_cast():
            return jl(jpaddle.Tensor(x)).data

    jo = jax.jit(fwd)(params, jnp.asarray(x))
    with torch.no_grad(), tpaddle.amp.auto_cast():
        to = tl(torch.from_numpy(x))
    assert str(to.dtype).replace("torch.", "") == str(jo.dtype)
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo,
                                                              np.float32),
                               atol=3e-2, rtol=3e-2)
