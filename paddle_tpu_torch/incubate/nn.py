"""incubate.nn fused transformer layers (the port of
``paddle_tpu/incubate/nn.py``).

Reference parity: python/paddle/incubate/nn/layer/fused_transformer.py —
FusedMultiHeadAttention (:39), FusedFeedForward (:230),
FusedTransformerEncoderLayer (:362) — backed by the hand-fused CUDA
kernels of operators/fused/ (fused_attention_op.cu,
fused_feedforward_op.cu).

These classes deliver the FUSION SEMANTICS (one packed qkv projection,
the pre/post-LN residual layout, the computation order of the reference
kernels) through the port's ops, so ``amp.auto_cast`` casts them as it
casts every op, and the attention is ``ops.scaled_dot_product_attention``:
on the card the port's flash kernels whenever no attention dropout is
drawn.  The bias, residual and LayerNorm chains run as their own torch
passes (a fused kernel for them is ROADMAP item 3's work).
"""
from __future__ import annotations

from .. import ops
from ..nn.initializer import Constant, XavierUniform
from ..nn.layer.layers import Layer

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer"]


class FusedMultiHeadAttention(Layer):
    """fused_attention_op semantics: [pre-LN →] ONE packed qkv matmul →
    attention (flash when available) → out proj → dropout → residual
    [→ post-LN]."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, normalize_before=False,
                 need_weights=False, qkv_weight_attr=None,
                 linear_weight_attr=None, epsilon=1e-5):
        super().__init__()
        if need_weights:
            raise NotImplementedError(
                "need_weights=True is unsupported (the reference fused op "
                "asserts the same); flash attention never materializes "
                "the weight matrix")
        assert embed_dim % num_heads == 0
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        E = embed_dim
        # packed head-major qkv: one matmul for q, k, v (THE fusion)
        self.qkv_weight = self.create_parameter(
            [E, 3 * E], default_initializer=XavierUniform())
        self.qkv_bias = self.create_parameter([3 * E], is_bias=True)
        self.linear_weight = self.create_parameter(
            [E, E], default_initializer=XavierUniform())
        self.linear_bias = self.create_parameter([E], is_bias=True)
        self.ln_scale = self.create_parameter(
            [E], default_initializer=Constant(1.0))
        self.ln_bias = self.create_parameter([E], is_bias=True)

    def forward(self, x, attn_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(
                "FusedMultiHeadAttention: decode cache is not wired; use "
                "nn.MultiHeadAttention (gen_cache) for incremental decode")
        B, S, E = x.shape
        H, hd = self.num_heads, self.head_dim
        residual = x
        if self.normalize_before:
            x = ops.layer_norm(x, self.ln_scale, self.ln_bias,
                               epsilon=self.epsilon)
        qkv = ops.add(ops.matmul(x, self.qkv_weight), self.qkv_bias)
        qkv = qkv.reshape(B, S, 3, H, hd)
        q = qkv[:, :, 0].transpose(1, 2)
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        out = ops.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.attn_dropout_rate, training=self.training)
        out = out.transpose(1, 2).reshape(B, S, E)
        out = ops.add(ops.matmul(out, self.linear_weight),
                      self.linear_bias)
        if self.training and self.dropout_rate > 0:
            out = ops.dropout(out, p=self.dropout_rate, training=True)
        out = ops.add(residual, out)
        if not self.normalize_before:
            out = ops.layer_norm(out, self.ln_scale, self.ln_bias,
                                 epsilon=self.epsilon)
        return out


class FusedFeedForward(Layer):
    """fused_feedforward_op semantics: [pre-LN →] linear → act → dropout
    → linear → dropout → residual [→ post-LN]."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False):
        super().__init__()
        self.d_model = d_model
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (act_dropout_rate
                                 if act_dropout_rate is not None
                                 else dropout_rate)
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        self.w1 = self.create_parameter(
            [d_model, dim_feedforward], default_initializer=XavierUniform())
        self.b1 = self.create_parameter([dim_feedforward], is_bias=True)
        self.w2 = self.create_parameter(
            [dim_feedforward, d_model], default_initializer=XavierUniform())
        self.b2 = self.create_parameter([d_model], is_bias=True)
        self.ln_scale = self.create_parameter(
            [d_model], default_initializer=Constant(1.0))
        self.ln_bias = self.create_parameter([d_model], is_bias=True)

    def forward(self, x):
        residual = x
        if self.normalize_before:
            x = ops.layer_norm(x, self.ln_scale, self.ln_bias,
                               epsilon=self.epsilon)
        h = ops.add(ops.matmul(x, self.w1), self.b1)
        h = ops.gelu(h) if self.activation == "gelu" else ops.relu(h)
        if self.training and self.act_dropout_rate > 0:
            h = ops.dropout(h, p=self.act_dropout_rate, training=True)
        h = ops.add(ops.matmul(h, self.w2), self.b2)
        if self.training and self.dropout_rate > 0:
            h = ops.dropout(h, p=self.dropout_rate, training=True)
        out = ops.add(residual, h)
        if not self.normalize_before:
            out = ops.layer_norm(out, self.ln_scale, self.ln_bias,
                                 epsilon=self.epsilon)
        return out


class FusedTransformerEncoderLayer(Layer):
    """fused_transformer.py:362 — attention block + FFN block, each with
    its own residual/LN placement."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead,
            dropout_rate=dropout_rate,
            attn_dropout_rate=(attn_dropout_rate
                               if attn_dropout_rate is not None
                               else dropout_rate),
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))
