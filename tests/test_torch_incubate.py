"""The port's ``incubate`` (the fused transformer layers of ``incubate/
nn.py`` and the custom-op API of ``incubate/custom_op.py``) against the
JAX package's.

The fused layers are built in both packages from one seed, the JAX
weights carried by name, and their outputs and every gradient
(parameters and input) held at fp32 1e-5 over pre- and post-LN, relu
and gelu, with an additive attention mask; the fused encoder layer also
equals the port's ``nn.TransformerEncoderLayer`` given the same weights
(the chip smoke's phase 21 (c) check on the card).  Custom ops register
in the port's op registry (and leave it as they found it)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.incubate.nn as jinc

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.incubate.nn as tinc
from paddle_tpu_torch.core.dispatch import OP_REGISTRY
from paddle_tpu_torch.incubate import CustomOpBuilder, build_op, custom_op
from torch_eager_ref import assert_vjp_close, jax_vjp, pair, rand, \
    torch_vjp

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pre_ln", [False, True])
def test_fused_attention_matches_jax(pre_ln):
    kw = dict(embed_dim=32, num_heads=4, dropout_rate=0.0,
              attn_dropout_rate=0.0, normalize_before=pre_ln)
    j, t = pair(lambda: jinc.FusedMultiHeadAttention(**kw),
                lambda: tinc.FusedMultiHeadAttention(**kw))
    assert sorted(dict(t.named_parameters())) == sorted(
        k for k in j.state_dict())
    x = rand((2, 8, 32), 0)
    assert_vjp_close(jax_vjp(j, x), torch_vjp(t, x), **TOL)


def test_fused_attention_with_a_mask_matches_jax():
    kw = dict(embed_dim=16, num_heads=2, dropout_rate=0.0,
              attn_dropout_rate=0.0)
    j, t = pair(lambda: jinc.FusedMultiHeadAttention(**kw),
                lambda: tinc.FusedMultiHeadAttention(**kw))
    x = rand((2, 6, 16), 1)
    mask = np.where(np.random.RandomState(2).rand(2, 1, 6, 6) < 0.3,
                    -1e9, 0.0).astype(np.float32)
    jo = j(jpaddle.Tensor(x), attn_mask=jpaddle.Tensor(mask))
    to = t(torch.tensor(x), attn_mask=torch.tensor(mask))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo.data),
                               **TOL)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("pre_ln", [False, True])
def test_fused_feedforward_matches_jax(activation, pre_ln):
    kw = dict(d_model=16, dim_feedforward=40, dropout_rate=0.0,
              activation=activation, normalize_before=pre_ln)
    j, t = pair(lambda: jinc.FusedFeedForward(**kw),
                lambda: tinc.FusedFeedForward(**kw))
    x = rand((3, 5, 16), 3)
    assert_vjp_close(jax_vjp(j, x), torch_vjp(t, x), **TOL)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("pre_ln", [False, True])
def test_fused_encoder_layer_matches_jax(activation, pre_ln):
    kw = dict(d_model=32, nhead=4, dim_feedforward=64, dropout_rate=0.0,
              activation=activation, normalize_before=pre_ln)
    j, t = pair(lambda: jinc.FusedTransformerEncoderLayer(**kw),
                lambda: tinc.FusedTransformerEncoderLayer(**kw))
    x = rand((2, 8, 32), 4)
    assert_vjp_close(jax_vjp(j, x), torch_vjp(t, x), **TOL)


def fused_from_encoder(layer, fused):
    """Load an ``nn.TransformerEncoderLayer``'s weights into a
    ``FusedTransformerEncoderLayer`` (q, k, v packed head-major)."""
    a, f = layer.self_attn, fused.fused_attn
    with torch.no_grad():
        f.qkv_weight.copy_(torch.cat([a.q_proj.weight, a.k_proj.weight,
                                      a.v_proj.weight], 1))
        f.qkv_bias.copy_(torch.cat([a.q_proj.bias, a.k_proj.bias,
                                    a.v_proj.bias]))
        f.linear_weight.copy_(a.out_proj.weight)
        f.linear_bias.copy_(a.out_proj.bias)
        f.ln_scale.copy_(layer.norm1.weight)
        f.ln_bias.copy_(layer.norm1.bias)
        ffn = fused.ffn
        ffn.w1.copy_(layer.linear1.weight)
        ffn.b1.copy_(layer.linear1.bias)
        ffn.w2.copy_(layer.linear2.weight)
        ffn.b2.copy_(layer.linear2.bias)
        ffn.ln_scale.copy_(layer.norm2.weight)
        ffn.ln_bias.copy_(layer.norm2.bias)
    return fused


@pytest.mark.parametrize("pre_ln", [False, True])
def test_fused_encoder_layer_equals_the_unfused_layer(pre_ln):
    tpaddle.seed(5)
    ref = tpaddle.nn.TransformerEncoderLayer(
        32, 4, 64, dropout=0.0, activation="gelu", attn_dropout=0.0,
        normalize_before=pre_ln)
    fused = fused_from_encoder(ref, tinc.FusedTransformerEncoderLayer(
        32, 4, 64, dropout_rate=0.0, activation="gelu",
        normalize_before=pre_ln))
    x = torch.tensor(rand((2, 8, 32), 6))
    np.testing.assert_allclose(fused(x).detach().numpy(),
                               ref(x).detach().numpy(), **TOL)


def test_fused_layers_reject_what_jax_rejects():
    with pytest.raises(NotImplementedError, match="need_weights"):
        tinc.FusedMultiHeadAttention(32, 4, need_weights=True)
    layer = tinc.FusedMultiHeadAttention(32, 4)
    with pytest.raises(NotImplementedError, match="cache"):
        layer(torch.ones(1, 4, 32), cache=("k", "v"))


def test_fused_encoder_layer_trains():
    tpaddle.seed(1)
    layer = tinc.FusedTransformerEncoderLayer(32, 4, 64, dropout_rate=0.0,
                                              normalize_before=True)
    opt = tpaddle.optimizer.SGD(learning_rate=0.05,
                                parameters=layer.parameters())
    x = torch.tensor(rand((2, 8, 32), 7))
    losses = []
    for _ in range(4):
        loss = (layer(x) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0]


# ------------------------------------------------------------- custom ops


@pytest.fixture()
def registry():
    """Custom ops registered by a test leave the port's registry as it
    was (``test_torch_ops.py`` holds the registry to the JAX corpus)."""
    before = set(OP_REGISTRY)
    yield
    for name in set(OP_REGISTRY) - before:
        del OP_REGISTRY[name]


def test_register_and_call(registry):
    my = build_op("test_relu6", lambda x: torch.clamp(x, 0.0, 6.0))
    out = my(torch.tensor([-1.0, 3.0, 9.0]))
    assert out.tolist() == [0.0, 3.0, 6.0]
    assert OP_REGISTRY["test_relu6"].eager_fn is my
    assert tpaddle.core.dispatch.get_op("test_relu6").differentiable


def test_autograd_through_custom_op(registry):
    sq = build_op("test_square", lambda x: x * x)
    x = torch.tensor([2.0, -3.0], requires_grad=True)
    sq(x).sum().backward()
    assert x.grad.tolist() == [4.0, -6.0]


def test_custom_backward_rule_wins(registry):
    op = custom_op.custom_op(
        "test_scaled_id", forward=lambda x: (x * 3.0, None),
        backward=lambda res, g: (g * 100.0,))   # deliberately not 3
    x = torch.tensor([1.0], requires_grad=True)
    op(x).sum().backward()
    assert x.grad.tolist() == [100.0]


def test_custom_backward_gets_residuals_and_two_inputs(registry):
    op = custom_op.custom_op(
        "test_mul", forward=lambda a, b: (a * b, (a, b)),
        backward=lambda res, g: (g * res[1], g * res[0]))
    a = torch.tensor([2.0, 5.0], requires_grad=True)
    b = torch.tensor([3.0, -1.0], requires_grad=True)
    op(a, b).sum().backward()
    assert a.grad.tolist() == [3.0, -1.0] and b.grad.tolist() == [2.0, 5.0]


def test_builder_style_and_decorator(registry):
    op = CustomOpBuilder("test_cube").set_forward(lambda x: x ** 3) \
        .set_differentiable(False).register()
    assert op(torch.tensor([2.0])).tolist() == [8.0]
    assert not OP_REGISTRY["test_cube"].differentiable

    @custom_op.custom_op("test_twice")
    def twice(x):
        return 2 * x

    assert twice(torch.tensor([1.5])).tolist() == [3.0]
    with pytest.raises(ValueError, match="set_forward"):
        CustomOpBuilder("test_empty").register()
