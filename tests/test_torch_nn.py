"""The port's functional ops and ``nn`` layers against the JAX package.

Every op of ``ops/nn_ops.py``, ``ops/loss.py``, ``ops/activation.py`` and
``ops/linalg.py`` that the layers use, forward and the gradients of its
float inputs, against the JAX op's pure function (jitted, or eager where
the JAX op cannot be jitted); every layer of ``nn/layer`` with weights
carried from the JAX layer, forward, weight and input gradients and
buffers.  fp32 at 1e-5 (atol and rtol) unless stated."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu.ops import activation as jact
from paddle_tpu.ops import linalg as jlin
from paddle_tpu.ops import loss as jloss
from paddle_tpu.ops import nn_ops as jops

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import ops as tops
from torch_eager_ref import (assert_vjp_close, carry, jax_state, jax_vjp,
                             pair, rand, torch_vjp)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def op_pair(jfn, tfn, floats, others=(), jit=True, ct_seed=99, **kw):
    """Forward and the gradients of the float arguments of one op in both
    packages, with a seeded cotangent on its (first) output."""
    def jf(*fa):
        out = jfn(*fa, *others, **kw)
        return out[0] if isinstance(out, tuple) else out

    f = jax.jit(jf) if jit else jf
    jargs = [jnp.asarray(a) for a in floats]
    out, pull = jax.vjp(f, *jargs)
    ct = rand(out.shape, ct_seed)
    jgrads = pull(jnp.asarray(ct))
    targs = [torch.tensor(a, requires_grad=True) for a in floats]
    tothers = [torch.as_tensor(o) if isinstance(o, np.ndarray) else o
               for o in others]
    tout = tfn(*targs, *tothers, **kw)
    tout = tout[0] if isinstance(tout, tuple) else tout
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out),
                               err_msg="out", **TOL)
    tgrads = torch.autograd.grad(tout, targs, torch.from_numpy(ct),
                                 allow_unused=True)
    for i, (tg, jg) in enumerate(zip(tgrads, jgrads)):
        tg = np.zeros_like(floats[i]) if tg is None else tg.numpy()
        np.testing.assert_allclose(tg, np.asarray(jg), err_msg=f"grad {i}",
                                   **TOL)
    return tout


# ------------------------------------------------------------ convolution

CONV2D = [
    dict(padding=1),
    dict(padding=[1, 2]),
    dict(padding=[1, 0, 2, 1]),                     # asymmetric
    dict(padding="SAME", stride=2),
    dict(padding="SAME", stride=3, dilation=2),
    dict(padding="VALID", stride=2),
    dict(padding=2, dilation=2, groups=2),
    dict(padding=0, stride=(2, 1)),
]


@pytest.mark.parametrize("kw", CONV2D, ids=str)
@pytest.mark.parametrize("bias", [True, False])
def test_conv2d(kw, bias):
    x = rand((2, 4, 9, 11), 0)
    w = rand((6, 4 // kw.get("groups", 1), 3, 3), 1, 0.3)
    b = [rand((6,), 2)] if bias else []
    op_pair(jops.conv2d.pure_fn, tops.conv2d, [x, w, *b], **kw)


def test_conv2d_nhwc_takes_hwio_weights():
    x = rand((2, 9, 11, 4), 0)
    w = rand((3, 3, 4, 6), 1, 0.3)
    op_pair(jops.conv2d.pure_fn, tops.conv2d, [x, w, rand((6,), 2)],
            padding=[0, 1, 1, 0], stride=2, data_format="NHWC")


@pytest.mark.parametrize("kw", [dict(padding=1), dict(padding="SAME",
                                                      stride=2),
                                dict(padding=[2, 0], dilation=2)], ids=str)
def test_conv1d(kw):
    op_pair(jops.conv1d.pure_fn, tops.conv1d,
            [rand((2, 4, 13), 0), rand((5, 4, 3), 1, 0.3), rand((5,), 2)],
            **kw)


@pytest.mark.parametrize("kw", [dict(padding=1), dict(padding="SAME",
                                                      stride=2)], ids=str)
def test_conv3d(kw):
    op_pair(jops.conv3d.pure_fn, tops.conv3d,
            [rand((1, 2, 5, 6, 7), 0), rand((3, 2, 3, 3, 3), 1, 0.3),
             rand((3,), 2)], **kw)


@pytest.mark.parametrize("kw", [
    dict(stride=2, padding=1, output_padding=1),
    dict(stride=2, padding=[0, 1, 1, 0]),
    dict(stride=1, padding=0, dilation=2),
    dict(stride=2, padding=1, groups=2),
    dict(stride=3, padding=1, output_padding=2),
], ids=str)
def test_conv2d_transpose(kw):
    g = kw.get("groups", 1)
    op_pair(jops.conv2d_transpose.pure_fn, tops.conv2d_transpose,
            [rand((2, 4, 5, 6), 0), rand((4, 6 // g, 3, 3), 1, 0.3),
             rand((6,), 2)], **kw)


# ---------------------------------------------------------------- pooling

@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, stride=2, padding=1),
    dict(kernel_size=3, stride=2, ceil_mode=True),
    dict(kernel_size=2),
    dict(kernel_size=3, stride=2, padding="SAME"),
    dict(kernel_size=(3, 2), stride=(2, 1), padding=[1, 0, 0, 1]),
], ids=str)
def test_max_pool2d(kw):
    op_pair(jops.max_pool2d.pure_fn, tops.max_pool2d, [rand((2, 3, 9, 10),
                                                            0)], **kw)


@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, stride=2, padding=1),
    dict(kernel_size=3, stride=2, padding=1, exclusive=False),
    dict(kernel_size=3, stride=2, ceil_mode=True),
    dict(kernel_size=3, stride=2, padding=1, ceil_mode=True,
         exclusive=False),
    dict(kernel_size=2),
    dict(kernel_size=3, stride=2, padding="SAME"),
], ids=str)
def test_avg_pool2d(kw):
    op_pair(jops.avg_pool2d.pure_fn, tops.avg_pool2d, [rand((2, 3, 9, 10),
                                                            0)], **kw)


@pytest.mark.parametrize("size,jit", [((2, 5), True), (1, True),
                                      ((3, 4), False)])
def test_adaptive_avg_pool2d(size, jit):
    """(3, 4) of 8 x 10 takes JAX's non-divisible path, which only runs
    eagerly (its window bounds call int() on jnp values)."""
    op_pair(jops.adaptive_avg_pool2d.pure_fn, tops.adaptive_avg_pool2d,
            [rand((2, 3, 8, 10), 0)], others=(size,), jit=jit)


def test_adaptive_max_pool2d():
    op_pair(jops.adaptive_max_pool2d.pure_fn, tops.adaptive_max_pool2d,
            [rand((2, 3, 8, 10), 0)], others=((4, 5),))
    with pytest.raises(NotImplementedError):
        tops.adaptive_max_pool2d(torch.zeros(1, 1, 5, 5), 3)


def test_global_avg_pool2d():
    op_pair(jops.global_avg_pool2d.pure_fn, tops.global_avg_pool2d,
            [rand((2, 3, 5, 4), 0)])


# ------------------------------------------------------------------ norms

@pytest.mark.parametrize("nd", [1, 2])
def test_layer_norm(nd):
    shape = (3, 4, 6)[-nd - 1:]
    op_pair(jops.layer_norm.pure_fn, tops.layer_norm,
            [rand((2, 3, 4, 6), 0, 3.0), rand(shape[1:], 1),
             rand(shape[1:], 2)], epsilon=1e-5, normalized_ndim=nd)


@pytest.mark.parametrize("shape,fmt", [((4, 3, 5, 6), "NCHW"),
                                       ((6, 5), "NCHW"),
                                       ((4, 5, 6, 3), "NHWC"),
                                       ((2, 3, 4, 5, 2), "NCDHW")])
def test_batch_norm_train(shape, fmt):
    c = shape[-1] if fmt == "NHWC" else shape[1]
    x = rand(shape, 0, 2.0) + 1.0
    floats = [x, rand((c,), 1), rand((c,), 2)]
    op_pair(jops.batch_norm_train.pure_fn, tops.batch_norm_train, floats,
            epsilon=1e-5, data_format=fmt)
    _, jm, jv = jops.batch_norm_train.pure_fn(*map(jnp.asarray, floats),
                                              data_format=fmt)
    _, tm, tv = tops.batch_norm_train(*map(torch.from_numpy, floats),
                                      data_format=fmt)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_infer(fmt):
    op_pair(jops.batch_norm_infer.pure_fn, tops.batch_norm_infer,
            [rand((2, 3, 4, 3), 0), np.abs(rand((3,), 1)) + 0.5,
             rand((3,), 2), rand((3,), 3)], others=(), epsilon=1e-3,
            data_format=fmt)


def test_batch_norm_infer_running_stats_are_inputs():
    x, m, v = rand((2, 3, 4, 4), 0), rand((3,), 1), np.abs(rand((3,), 2))
    op_pair(lambda x, m, v: jops.batch_norm_infer.pure_fn(x, m, v),
            lambda x, m, v: tops.batch_norm_infer(x, m, v), [x, m, v])


def test_group_norm():
    op_pair(jops.group_norm.pure_fn, tops.group_norm,
            [rand((2, 6, 4, 5), 0, 2.0)], others=(3,))
    op_pair(lambda x, w, b: jops.group_norm.pure_fn(x, 2, w, b),
            lambda x, w, b: tops.group_norm(x, 2, w, b),
            [rand((2, 6, 4, 5), 0), rand((6,), 1), rand((6,), 2)])


# ------------------------------------------------------------ activations

ACTS = [("relu", {}), ("relu6", {}), ("leaky_relu", dict(negative_slope=0.2)),
        ("elu", dict(alpha=0.7)), ("selu", {}), ("celu", dict(alpha=1.5)),
        ("gelu", {}), ("gelu", dict(approximate=True)), ("silu", {}),
        ("hardswish", {}), ("hardsigmoid", {}), ("hardtanh", {}),
        ("hardshrink", {}), ("softshrink", {}), ("tanhshrink", {}),
        ("thresholded_relu", dict(threshold=0.3)), ("log_sigmoid", {}),
        ("softmax", dict(axis=1)), ("log_softmax", {}), ("softsign", {}),
        ("mish", {}), ("glu", {}), ("maxout", dict(groups=2, axis=1))]


@pytest.mark.parametrize("name,kw", ACTS, ids=lambda v: str(v))
def test_activation(name, kw):
    op_pair(getattr(jact, name).pure_fn, getattr(tops, name),
            [rand((3, 4, 6), 0, 2.0)], **kw)


@pytest.mark.parametrize("name", ["sigmoid", "tanh", "softplus"])
def test_math_activation(name):
    from paddle_tpu.ops import math as jmath

    op_pair(getattr(jmath, name).pure_fn, getattr(tops, name),
            [rand((3, 5), 0, 8.0)])


def test_prelu():
    op_pair(jact.prelu.pure_fn, tops.prelu,
            [rand((2, 3, 4), 0), rand((1, 3, 1), 1)])


# ------------------------------------------------------------------ losses

def _labels(n, c, seed, ignore=None):
    y = np.random.RandomState(seed).randint(0, c, (n,)).astype(np.int64)
    if ignore is not None:
        y[::3] = ignore
    return y


@pytest.mark.parametrize("kw", [
    dict(), dict(reduction="sum"), dict(reduction="none"),
    dict(ignore_index=2), dict(weight="w"), dict(weight="w", reduction="sum"),
    dict(use_softmax=False)], ids=str)
def test_cross_entropy(kw):
    x = rand((8, 5), 0, 2.0)
    if kw.get("use_softmax") is False:
        x = np.abs(x) / np.abs(x).sum(-1, keepdims=True)
    y = _labels(8, 5, 1, ignore=-100 if "ignore_index" not in kw else 2)
    kw = dict(kw)
    if kw.get("weight") == "w":
        w = np.abs(rand((5,), 3)) + 0.1
        op_pair(lambda x, w: jloss.cross_entropy.pure_fn(
                    x, jnp.asarray(y), weight=w, **{k: v for k, v in
                                                    kw.items()
                                                    if k != "weight"}),
                lambda x, w: tops.cross_entropy(
                    x, torch.from_numpy(y), weight=w, **{
                        k: v for k, v in kw.items() if k != "weight"}),
                [x, w])
        return
    op_pair(jloss.cross_entropy.pure_fn, tops.cross_entropy, [x],
            others=(y,), **kw)


def test_cross_entropy_soft_label_axis_and_weight():
    """Soft labels along axis 1; per-class weights broadcast over the last
    axis (JAX multiplies without moving them to ``axis``)."""
    x = rand((4, 5, 3), 0)
    soft = np.abs(rand((4, 5, 3), 1))
    soft /= soft.sum(1, keepdims=True)
    op_pair(lambda x, s: jloss.cross_entropy.pure_fn(
                x, s, soft_label=True, axis=1, reduction="sum"),
            lambda x, s: tops.cross_entropy(
                x, s, soft_label=True, axis=1, reduction="sum"), [x, soft])
    w = np.abs(rand((3,), 2)) + 0.1
    op_pair(lambda x, s, w: jloss.cross_entropy.pure_fn(
                x, s, soft_label=True, weight=w),
            lambda x, s, w: tops.cross_entropy(
                x, s, soft_label=True, weight=w), [x, soft, w])


def test_cross_entropy_class_axis_1():
    y = np.random.RandomState(1).randint(0, 5, (4, 3)).astype(np.int64)
    op_pair(jloss.cross_entropy.pure_fn, tops.cross_entropy,
            [rand((4, 5, 3), 0)], others=(y,), axis=1)


def test_cross_entropy_rejects_n1_labels_as_jax_does():
    """Labels shaped [N, 1] raise in the JAX package (take_along_axis);
    the port raises too rather than taking a shape JAX does not."""
    x, y = rand((4, 5), 0), _labels(4, 5, 1)[:, None]
    with pytest.raises(Exception):
        jloss.cross_entropy.pure_fn(jnp.asarray(x), jnp.asarray(y))
    with pytest.raises(ValueError):
        tops.cross_entropy(torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.parametrize("kw", [dict(), dict(ignore_index=1),
                                dict(return_softmax=True),
                                dict(label_shape="n1")], ids=str)
def test_softmax_with_cross_entropy(kw):
    kw = dict(kw)
    y = _labels(6, 4, 1)
    if kw.pop("label_shape", None):
        y = y[:, None]
    op_pair(jloss.softmax_with_cross_entropy.pure_fn,
            tops.softmax_with_cross_entropy, [rand((6, 4), 0)],
            others=(y,), **kw)


@pytest.mark.parametrize("kw", [dict(), dict(reduction="sum"),
                                dict(ignore_index=0), dict(weight=True)],
                         ids=str)
def test_nll_loss(kw):
    lp = np.log(np.abs(rand((6, 4), 0)) + 0.1).astype(np.float32)
    y = _labels(6, 4, 1)
    if kw.pop("weight", False):
        w = np.abs(rand((4,), 2))
        op_pair(lambda lp, w: jloss.nll_loss.pure_fn(lp, jnp.asarray(y),
                                                     weight=w),
                lambda lp, w: tops.nll_loss(lp, torch.from_numpy(y),
                                            weight=w), [lp, w])
        return
    op_pair(jloss.nll_loss.pure_fn, tops.nll_loss, [lp], others=(y,), **kw)


@pytest.mark.parametrize("name,kw", [
    ("mse_loss", {}), ("mse_loss", dict(reduction="none")),
    ("l1_loss", dict(reduction="sum")), ("smooth_l1_loss", dict(delta=0.5)),
    ("kl_div", {}), ("kl_div", dict(reduction="batchmean")),
    ("binary_cross_entropy_with_logits", {}),
], ids=str)
def test_pointwise_loss(name, kw):
    a, b = rand((4, 6), 0), rand((4, 6), 1)
    if name == "kl_div":
        b = np.abs(b)
    op_pair(getattr(jloss, name).pure_fn, getattr(tops, name), [a, b], **kw)


def test_bce_and_weighted_losses():
    p = 1 / (1 + np.exp(-rand((4, 6), 0)))
    y = (rand((4, 6), 1) > 0).astype(np.float32)
    w, pw = np.abs(rand((6,), 2)), np.abs(rand((6,), 3)) + 0.5
    op_pair(jloss.binary_cross_entropy.pure_fn, tops.binary_cross_entropy,
            [p.astype(np.float32), y, w])
    op_pair(lambda x, y, w, pw: jloss.binary_cross_entropy_with_logits
            .pure_fn(x, y, w, pos_weight=pw),
            lambda x, y, w, pw: tops.binary_cross_entropy_with_logits(
                x, y, w, pos_weight=pw), [rand((4, 6), 4), y, w, pw])


def test_ranking_losses():
    a, b = rand((8,), 0), rand((8,), 1)
    s = np.sign(rand((8,), 2)).astype(np.float32)
    op_pair(jloss.margin_ranking_loss.pure_fn, tops.margin_ranking_loss,
            [a, b, s], margin=0.3)
    op_pair(jloss.hinge_embedding_loss.pure_fn, tops.hinge_embedding_loss,
            [a, s], margin=0.5)


@pytest.mark.parametrize("shapes", [((3, 4), (4, 5)), ((2, 3, 4), (4, 6)),
                                    ((2, 3, 4), (2, 4, 5))])
def test_matmul(shapes):
    op_pair(jlin.matmul.pure_fn, tops.matmul,
            [rand(shapes[0], 0), rand(shapes[1], 1)])
    op_pair(jlin.matmul.pure_fn, tops.matmul,
            [rand(shapes[0][:-2] + shapes[0][:-3:-1], 0),
             rand(shapes[1], 1)], transpose_x=True)


def test_matmul_half_input_casts_back():
    x = torch.randn(3, 4).bfloat16()
    y = torch.randn(4, 2)
    assert tops.matmul(x, y).dtype == torch.bfloat16
    assert tops.matmul(y.T, x.T.float()).dtype == torch.float32


# ----------------------------------------------------------------- dropout

def test_dropout_properties():
    x = torch.ones(200, 500)
    tpaddle.seed(7)
    a = tops.dropout(x, p=0.3)
    tpaddle.seed(7)
    b = tops.dropout(x, p=0.3)
    assert torch.equal(a, b)                         # same seed, same mask
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    np.testing.assert_allclose(a[kept].numpy(), 1 / 0.7, rtol=1e-6)
    assert torch.equal(tops.dropout(x, p=0.3, training=False), x)
    assert torch.equal(tops.dropout(x, p=0.0), x)
    down = tops.dropout(x, p=0.3, mode="downscale_in_infer")
    assert set(torch.unique(down).tolist()) <= {0.0, 1.0}
    np.testing.assert_allclose(
        tops.dropout(x, 0.3, training=False,
                     mode="downscale_in_infer").numpy(), 0.7, rtol=1e-6)
    layer = tnn.Dropout(0.5)
    layer.eval()
    assert torch.equal(layer(x), x)


# ------------------------------------------------------------------ layers

LAYERS = [
    ("Conv2D", lambda m: m.Conv2D(3, 4, 3, stride=2, padding=1), (2, 3, 9, 9)),
    ("Conv2D_nobias_groups", lambda m: m.Conv2D(4, 6, 3, padding="SAME",
                                                groups=2, bias_attr=False),
     (2, 4, 7, 7)),
    ("Conv1D", lambda m: m.Conv1D(3, 4, 3, padding=1), (2, 3, 10)),
    ("Conv3D", lambda m: m.Conv3D(2, 3, 3, padding=1), (1, 2, 4, 5, 5)),
    ("Conv2DTranspose", lambda m: m.Conv2DTranspose(4, 3, 3, stride=2,
                                                    padding=1,
                                                    output_padding=1),
     (2, 4, 5, 5)),
    ("BatchNorm1D", lambda m: m.BatchNorm1D(5), (6, 5)),
    ("BatchNorm2D", lambda m: m.BatchNorm2D(3, momentum=0.8), (4, 3, 5, 5)),
    ("BatchNorm3D", lambda m: m.BatchNorm3D(2), (2, 2, 3, 4, 4)),
    ("LayerNorm", lambda m: m.LayerNorm([4, 6]), (3, 4, 6)),
    ("GroupNorm", lambda m: m.GroupNorm(2, 4), (2, 4, 3, 3)),
    ("MaxPool2D", lambda m: m.MaxPool2D(3, 2, 1), (2, 3, 8, 8)),
    ("MaxPool2D_ceil", lambda m: m.MaxPool2D(3, 2, ceil_mode=True),
     (2, 3, 8, 8)),
    ("AvgPool2D", lambda m: m.AvgPool2D(3, 2, 1, exclusive=False),
     (2, 3, 8, 8)),
    ("AdaptiveAvgPool2D", lambda m: m.AdaptiveAvgPool2D((2, 2)),
     (2, 3, 8, 8)),
    ("AdaptiveMaxPool2D", lambda m: m.AdaptiveMaxPool2D(4), (2, 3, 8, 8)),
    ("Linear", lambda m: m.Linear(6, 5), (3, 4, 6)),
    ("Linear_nobias", lambda m: m.Linear(6, 5, bias_attr=False), (3, 6)),
    ("Flatten", lambda m: m.Flatten(), (2, 3, 4)),
    ("PReLU", lambda m: m.PReLU(3), (2, 3, 4)),
    ("Sequential", lambda m: m.Sequential(m.Linear(4, 8), m.GELU(),
                                          m.Linear(8, 3), m.Softmax()),
     (5, 4)),
] + [(name, (lambda n: lambda m: getattr(m, n)())(name), (3, 8))
     for name in ["ReLU", "ReLU6", "LeakyReLU", "ELU", "SELU", "CELU",
                  "GELU", "Silu", "Swish", "Hardswish", "Hardsigmoid",
                  "Hardtanh", "Hardshrink", "Softshrink", "Tanhshrink",
                  "ThresholdedReLU", "LogSigmoid", "Softmax", "LogSoftmax",
                  "Softplus", "Softsign", "Mish", "Sigmoid", "Tanh", "GLU"]] + [
    ("Maxout", lambda m: m.Maxout(2), (2, 4, 3))]


@pytest.mark.parametrize("name,ctor,shape", LAYERS, ids=[l[0] for l in LAYERS])
@pytest.mark.parametrize("train", [True, False])
def test_layer(name, ctor, shape, train):
    jl, tl = pair(lambda: ctor(jnn), lambda: ctor(tnn))
    x = rand(shape, 3, 2.0)
    assert_vjp_close(jax_vjp(jl, x, train=train),
                     torch_vjp(tl, x, train=train), **TOL)


LOSSES = [
    ("CrossEntropyLoss", lambda m: m.CrossEntropyLoss(), "class"),
    ("CrossEntropyLoss_ignore", lambda m: m.CrossEntropyLoss(
        ignore_index=1, reduction="sum"), "class"),
    ("NLLLoss", lambda m: m.NLLLoss(), "class"),
    ("MSELoss", lambda m: m.MSELoss(), "float"),
    ("L1Loss", lambda m: m.L1Loss(reduction="sum"), "float"),
    ("SmoothL1Loss", lambda m: m.SmoothL1Loss(delta=0.5), "float"),
    ("KLDivLoss", lambda m: m.KLDivLoss(), "prob"),
    ("BCELoss", lambda m: m.BCELoss(), "binary_prob"),
    ("BCEWithLogitsLoss", lambda m: m.BCEWithLogitsLoss(), "binary"),
    ("HingeEmbeddingLoss", lambda m: m.HingeEmbeddingLoss(), "sign"),
]


@pytest.mark.parametrize("name,ctor,kind", LOSSES, ids=[l[0] for l in LOSSES])
def test_loss_layer(name, ctor, kind):
    x = rand((6, 4), 0, 2.0)
    y = {"class": _labels(6, 4, 1),
         "float": rand((6, 4), 1),
         "prob": np.abs(rand((6, 4), 1)),
         "binary": (rand((6, 4), 1) > 0).astype(np.float32),
         "binary_prob": (rand((6, 4), 1) > 0).astype(np.float32),
         "sign": np.sign(rand((6, 4), 1)).astype(np.float32)}[kind]
    if kind == "binary_prob":
        x = (1 / (1 + np.exp(-x))).astype(np.float32)
    jl, tl = ctor(jnn), ctor(tnn)
    jout = jax.jit(lambda a: jl(jpaddle.Tensor(a), jpaddle.Tensor(
        jnp.asarray(y))).data)
    jv, jg = jax.value_and_grad(jout)(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tv = tl(tx, torch.from_numpy(y))
    (tg,) = torch.autograd.grad(tv, [tx])
    np.testing.assert_allclose(tv.item(), float(jv), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


def test_margin_ranking_loss_layer():
    a, b, s = rand((8,), 0), rand((8,), 1), np.sign(rand((8,), 2))
    jv = jnn.MarginRankingLoss(0.2)(*[jpaddle.Tensor(jnp.asarray(v))
                                      for v in (a, b, s)])
    tv = tnn.MarginRankingLoss(0.2)(*map(torch.from_numpy, (a, b, s)))
    np.testing.assert_allclose(tv.item(), float(jv.data), **TOL)


# ------------------------------------------------------------ Layer surface

class _Net:
    """One small net in both packages: a buffer that is not persistable
    and nested sublayers."""

    @staticmethod
    def build(m):
        class Net(m.Layer):
            def __init__(self):
                super().__init__()
                self.body = m.Sequential(m.Conv2D(2, 3, 3), m.BatchNorm2D(3))
                self.head = m.LayerList([m.Linear(3, 4), m.Linear(4, 2)])
                self.register_buffer("scratch", np.zeros(3, np.float32),
                                     persistable=False)

            def forward(self, x):
                x = self.body(x).mean(axis=(2, 3)) if hasattr(
                    x, "data") else self.body(x).mean(dim=(2, 3))
                for layer in self.head:
                    x = layer(x)
                return x

        return Net()


def test_state_dict_names_and_order_equal_jax():
    jl, tl = _Net.build(jnn), _Net.build(tnn)
    assert list(tl.state_dict()) == list(jl.state_dict())
    assert [k for k, _ in tl.named_parameters()] == \
        [k for k, _ in jl.named_parameters()]
    assert "scratch" not in tl.state_dict()
    assert [k for k, _ in tl.named_buffers()] == \
        [k for k, _ in jl.named_buffers()]
    assert list(tl.state_dict(structured_name_prefix="net")) == \
        list(jl.state_dict(structured_name_prefix="net"))


def test_set_state_dict_takes_numpy_and_tensors():
    jl, tl = _Net.build(jnn), _Net.build(tnn)
    state = jax_state(jl)
    missing, unexpected = tl.set_state_dict({**state, "extra": np.zeros(1)})
    assert missing == [] and unexpected == ["extra"]
    for k, v in tl.state_dict().items():
        np.testing.assert_array_equal(v.detach().numpy(), state[k])
    other = _Net.build(tnn)
    other.set_state_dict(tl.state_dict())
    for k, v in other.state_dict().items():
        assert torch.equal(v, tl.state_dict()[k])
    with pytest.raises(ValueError):
        other.set_state_dict({"head.0.weight": np.zeros((2, 2))})


def test_parameters_sublayers_and_modes():
    tl = _Net.build(tnn)
    assert isinstance(tl.parameters(), list) and len(tl.parameters()) == 8
    assert len(tl.parameters(include_sublayers=False)) == 0
    assert len(tl.sublayers()) == 6 and tl.sublayers(True)[0] is tl
    assert all(isinstance(p, tnn.Parameter) for p in tl.parameters())
    tl.eval()
    assert not any(m.training for m in tl.sublayers(include_self=True))
    tl.train()
    assert all(m.training for m in tl.sublayers(include_self=True))


def test_forward_hooks():
    layer = tnn.Linear(3, 2)
    seen = []
    h1 = layer.register_forward_pre_hook(lambda lay, args: (args[0] * 2,))
    h2 = layer.register_forward_post_hook(
        lambda lay, args, out: seen.append(out.shape) or out + 1)
    x = torch.ones(1, 3)
    want = x * 2 @ layer.weight + layer.bias + 1
    assert torch.allclose(layer(x), want) and seen == [(1, 2)]
    h1.remove()
    h2.remove()
    assert torch.allclose(layer(x), x @ layer.weight + layer.bias)


def test_create_parameter_attrs_and_defaults():
    attr = tnn.ParamAttr(name="w0", learning_rate=0.5,
                         initializer=tnn.initializer.Constant(3.0))
    layer = tnn.Linear(4, 2, weight_attr=attr,
                       bias_attr=tnn.ParamAttr(trainable=False))
    assert layer.weight.name == "w0"
    assert layer.weight.optimize_attr["learning_rate"] == 0.5
    assert torch.all(layer.weight == 3.0)
    assert not layer.bias.requires_grad and torch.all(layer.bias == 0)
    import copy

    clone = copy.deepcopy(layer)
    assert clone.weight.name == "w0"
    assert clone.weight.optimize_attr["learning_rate"] == 0.5


@pytest.mark.parametrize("init,check", [
    ("XavierUniform", lambda t, fi, fo: np.abs(t).max()
     <= np.sqrt(6 / (fi + fo))),
    ("XavierNormal", lambda t, fi, fo: abs(t.std() - np.sqrt(2 / (fi + fo)))
     < 0.05 * np.sqrt(2 / (fi + fo))),
    ("KaimingUniform", lambda t, fi, fo: np.abs(t).max() <= np.sqrt(6 / fi)),
    ("KaimingNormal", lambda t, fi, fo: abs(t.std() - np.sqrt(2 / fi))
     < 0.05 * np.sqrt(2 / fi)),
    ("TruncatedNormal", lambda t, fi, fo: np.abs(t).max() <= 2.0),
    ("Uniform", lambda t, fi, fo: np.abs(t).max() <= 1.0),
])
def test_initializer_distributions(init, check):
    """The JAX package's fans and ranges: conv weights OIHW, fan_in =
    I·k·k, fan_out = O·k·k."""
    tpaddle.seed(0)
    shape = [64, 32, 3, 3]
    t = getattr(tnn.initializer, init)()(shape, "float32", "cpu")
    assert tuple(t.shape) == tuple(shape)
    assert check(t.numpy(), 32 * 9, 64 * 9)


def test_initializer_draws_follow_the_seed():
    tpaddle.seed(3)
    a = tnn.Conv2D(3, 4, 3).weight.detach().clone()
    tpaddle.seed(3)
    b = tnn.Conv2D(3, 4, 3).weight.detach().clone()
    assert torch.equal(a, b)
    limit = np.sqrt(2.0) * np.sqrt(3.0 / 27)             # KaimingUniform
    assert float(a.abs().max()) <= limit


def test_functional_namespace():
    import paddle_tpu_torch.nn.functional as F

    for name in ["conv2d", "max_pool2d", "batch_norm_train", "relu",
                 "cross_entropy", "matmul", "scaled_dot_product_attention",
                 "dropout", "layer_norm", "adaptive_avg_pool2d"]:
        assert callable(getattr(F, name)), name
