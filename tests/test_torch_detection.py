"""The port's box and detection ops (``vision/ops.py``,
``vision/detection_ops.py``) against the JAX package's on the same
seeded numpy inputs.

``nms`` must keep exactly JAX's indices in JAX's order (a stable
descending sort of the scores, ties in index order), category-aware and
truncated alike; the float ops are held at fp32 1e-5, ``yolo_box``'s
pixel coordinates (up to ~600) at rtol 1e-6 on top; ``roi_align``'s
gradient with respect to the feature map is held to ``jax.vjp``'s at
the same tolerance."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.vision.detection_ops as jdet
import paddle_tpu.vision.ops as jops

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.vision.detection_ops as tdet
import paddle_tpu_torch.vision.ops as tops

tpaddle.set_device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)


def boxes(n, seed, span=100.0, size=30.0):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2).astype(np.float32) * span
    wh = rng.rand(n, 2).astype(np.float32) * size + 1
    return np.concatenate([xy, xy + wh], 1)


def T(a):
    return torch.as_tensor(a)


def test_box_area_and_iou_match_jax():
    a, b = boxes(13, 0), boxes(7, 1)
    np.testing.assert_allclose(tops.box_area(T(a)).numpy(),
                               np.asarray(jops.box_area(a)), **TOL)
    np.testing.assert_allclose(tops.box_iou(T(a), T(b)).numpy(),
                               np.asarray(jops.box_iou(a, b)), **TOL)


NMS_CASES = {
    "default_scores": dict(n=200, thr=0.3),
    "scores": dict(n=300, thr=0.5, scores=True),
    "tied_scores": dict(n=120, thr=0.3, scores="ties"),
    "categories": dict(n=300, thr=0.3, scores=True, cats=4),
    "top_k": dict(n=300, thr=0.4, scores=True, top_k=17),
    "cats_top_k": dict(n=250, thr=0.2, scores=True, cats=3, top_k=40),
    "dense_overlap": dict(n=150, thr=0.7, scores=True, span=20.0),
    "nothing_suppressed": dict(n=40, thr=1.0, scores=True),
    "single": dict(n=1, thr=0.5, scores=True),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_indices_equal_jax(case):
    c = NMS_CASES[case]
    n = c["n"]
    b = boxes(n, 2, span=c.get("span", 100.0))
    rng = np.random.RandomState(3)
    kw_j, kw_t = {}, {}
    if c.get("scores") == "ties":
        s = np.round(rng.rand(n) * 5).astype(np.float32) / 5
        kw_j["scores"], kw_t["scores"] = s, T(s)
    elif c.get("scores"):
        s = rng.rand(n).astype(np.float32)
        kw_j["scores"], kw_t["scores"] = s, T(s)
    if c.get("cats"):
        cats = rng.randint(0, c["cats"], n)
        kw_j["category_idxs"], kw_t["category_idxs"] = cats, T(cats)
    if c.get("top_k"):
        kw_j["top_k"] = kw_t["top_k"] = c["top_k"]
    want = np.asarray(jops.nms(b, c["thr"], **kw_j))
    got = tops.nms(T(b), c["thr"], **kw_t)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def _roi_inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 5, 12, 14).astype(np.float32)
    bx = np.array([[1, 1, 8, 9], [0, 0, 13, 11], [3.5, 2.2, 4, 5],
                   [-2, -1, 20, 20], [6.3, 0.7, 11.9, 6.1]], np.float32)
    return x, bx


ROI_CASES = [
    dict(output_size=3, spatial_scale=0.8, sampling_ratio=2, aligned=True,
         boxes_num=[2, 3]),
    dict(output_size=(2, 4), spatial_scale=1.0, sampling_ratio=3,
         aligned=False, boxes_num=[4, 1]),
    dict(output_size=7, spatial_scale=0.5, sampling_ratio=-1, aligned=True,
         boxes_num=None),
    dict(output_size=1, spatial_scale=1.25, sampling_ratio=1, aligned=False,
         boxes_num=[0, 5]),
]


@pytest.mark.parametrize("i", range(len(ROI_CASES)))
def test_roi_align_and_its_gradient_match_jax(i):
    c = dict(ROI_CASES[i])
    bn = c.pop("boxes_num")
    x, bx = _roi_inputs(i)

    def jf(xx):
        return jdet.roi_align(xx, bx, None if bn is None else np.array(bn),
                              **c)

    want, vjp = jax.vjp(jf, jnp.asarray(x))
    ct = np.random.RandomState(9).randn(*want.shape).astype(np.float32)
    (gwant,) = vjp(jnp.asarray(ct))
    tx = torch.tensor(x, requires_grad=True)
    got = tdet.roi_align(tx, T(bx), None if bn is None else T(np.array(bn)),
                         **c)
    (ggot,) = torch.autograd.grad((got * T(ct)).sum(), tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ggot.numpy(), np.asarray(gwant), **TOL)


@pytest.mark.parametrize("kw", [
    dict(conf_thresh=0.3),
    dict(conf_thresh=0.005, clip_bbox=False, scale_x_y=1.05),
    dict(conf_thresh=0.6, downsample_ratio=16),
], ids=["clip", "noclip_scaled", "stride16"])
def test_yolo_box_matches_jax(kw):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3 * (5 + 4), 5, 6).astype(np.float32)
    im = np.array([[320, 400], [200, 300]], np.float32)
    anchors = [10, 13, 16, 30, 33, 23]
    jb, js = jdet.yolo_box(x, im, anchors, 4, **kw)
    tb, ts = tdet.yolo_box(T(x), T(im), anchors, 4, **kw)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[30, 60], max_sizes=[60, 111], aspect_ratios=(2., 3.),
         flip=True, clip=True),
    dict(min_sizes=[21.0], max_sizes=[45.0], aspect_ratios=(2.,),
         flip=True, min_max_aspect_ratios_order=True),
    dict(min_sizes=[16], steps=(8.0, 8.0), offset=0.25),
])
def test_prior_box_matches_jax(kw):
    jb, jv = jdet.prior_box((5, 6), (300, 300), **kw)
    tb, tv = tdet.prior_box((5, 6), (300, 300), device="cpu", **kw)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _priors():
    return np.asarray(jdet.prior_box((4, 5), (300, 300), [30, 60],
                                     aspect_ratios=(2.,))[0]).reshape(-1, 4)


@pytest.mark.parametrize("var", [None, "vector", "per_prior"])
@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_encode_matches_jax(var, normalized):
    pb = _priors()[:20]
    tgt = boxes(7, 6) / 100
    v = {None: None, "vector": [0.1, 0.1, 0.2, 0.2],
         "per_prior": np.random.RandomState(0).rand(20, 4)
         .astype(np.float32) + 0.1}[var]
    want = jdet.box_coder(pb, tgt, v, box_normalized=normalized)
    got = tdet.box_coder(T(pb), T(tgt), v if not isinstance(v, np.ndarray)
                         else T(v), box_normalized=normalized)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("two_d", [False, True])
def test_box_coder_decode_matches_jax(axis, two_d):
    pb = _priors()[:20]
    rng = np.random.RandomState(axis)
    shape = (20, 4) if two_d else ((20, 7, 4) if axis == 0 else (7, 20, 4))
    if two_d and axis == 1:
        shape = (7, 4)
        pb = pb[:1]
    d = rng.randn(*shape).astype(np.float32) * 0.1
    want = jdet.box_coder(pb, d, [0.1, 0.1, 0.2, 0.2],
                          code_type="decode_center_size", axis=axis)
    got = tdet.box_coder(T(pb), T(d), [0.1, 0.1, 0.2, 0.2],
                         code_type="decode_center_size", axis=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_box_coder_rejects_what_jax_rejects():
    pb = _priors()[:4]
    with pytest.raises(ValueError, match="axis"):
        tdet.box_coder(T(pb), T(pb), code_type="decode", axis=2)
    with pytest.raises(ValueError, match="code_type"):
        tdet.box_coder(T(pb), T(pb), code_type="bogus")
