"""Detection operators (the port of ``paddle_tpu/vision/detection_ops.py``):
the op subset that expresses the PP-YOLOE / SSD-class configs.

Reference parity:
  roi_align  — paddle/fluid/operators/detection/roi_align_op.cc (bilinear
               pooling over RoI bins, `aligned` half-pixel semantics)
  yolo_box   — paddle/fluid/operators/detection/yolo_box_op.cc (decode
               YOLO head predictions into boxes + scores)
  prior_box  — paddle/fluid/operators/detection/prior_box_op.cc (SSD
               anchor generation)
  box_coder  — paddle/fluid/operators/detection/box_coder_op.cc (SSD
               encode/decode between priors and targets)

Each op is a vectorised torch program on the device of its input (no
per-RoI Python loop): ``roi_align`` gathers its sampling grid's four
corners from a channels-last view of the feature map, so autograd's
backward is one scatter-add into it.  As in the JAX package, adaptive
sampling (``sampling_ratio <= 0``) maps to the fixed 2-sample grid the
detection configs use; pass an explicit ``sampling_ratio`` to override.
``prior_box`` takes no tensor: its result lies on ``device``, by default
that of ``set_device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.place import current_device

__all__ = ["roi_align", "yolo_box", "prior_box", "box_coder"]


def _t(x, dtype=torch.float32, device=None):
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if device is not None:
        t = t.to(device)
    return t.to(dtype) if dtype is not None else t


def roi_align(x, boxes, boxes_num=None, output_size=7, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """RoI Align (reference roi_align_op.cc; torchvision semantics).

    x: [N, C, H, W]; boxes: [R, 4] (x1, y1, x2, y2) in input-image
    coords; boxes_num: [N] rois per image (defaults to all on image 0).
    Returns [R, C, output_size, output_size]."""
    x = _t(x)
    boxes = _t(boxes, device=x.device)
    N, C, H, W = x.shape
    R = boxes.shape[0]
    ph, pw = ((output_size, output_size) if isinstance(output_size, int)
              else output_size)
    s = int(sampling_ratio) if sampling_ratio and sampling_ratio > 0 else 2
    dev = x.device
    if boxes_num is None:
        batch_idx = torch.zeros((R,), dtype=torch.int64, device=dev)
    else:
        bn = _t(boxes_num, torch.int64, device=dev)
        batch_idx = torch.repeat_interleave(
            torch.arange(N, device=dev), bn, output_size=R)

    offset = 0.5 if aligned else 0.0
    bx = boxes * spatial_scale - offset
    x1, y1, x2, y2 = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
    rw = x2 - x1
    rh = y2 - y1
    if not aligned:                      # legacy: clamp to >= 1
        rw = torch.clamp(rw, min=1.0)
        rh = torch.clamp(rh, min=1.0)
    bin_h = rh / ph
    bin_w = rw / pw
    sub = (torch.arange(s, device=dev, dtype=torch.float32) + 0.5) / s
    iy = torch.arange(ph, device=dev)[None, :, None] + sub[None, None, :]
    ix = torch.arange(pw, device=dev)[None, :, None] + sub[None, None, :]
    ys = y1[:, None, None] + iy * bin_h[:, None, None]      # [R, ph, s]
    xs = x1[:, None, None] + ix * bin_w[:, None, None]      # [R, pw, s]
    y = ys[:, :, None, :, None].expand(R, ph, pw, s, s)
    xg = xs[:, None, :, None, :].expand(R, ph, pw, s, s)

    valid = (y >= -1.0) & (y <= H) & (xg >= -1.0) & (xg <= W)
    y = y.clamp(0.0, H - 1)
    xg = xg.clamp(0.0, W - 1)
    y0f = torch.floor(y)
    x0f = torch.floor(xg)
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)
    y1i = torch.clamp(y0 + 1, max=H - 1)
    x1i = torch.clamp(x0 + 1, max=W - 1)
    ly, lx = y - y0f, xg - x0f
    hy, hx = 1.0 - ly, 1.0 - lx
    # channels-last rows: one gather of C values per corner sample
    rows = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    base = (batch_idx * (H * W))[:, None, None, None, None]

    def g(yy, xx):
        return rows[(base + yy * W + xx).reshape(-1)].view(
            R, ph, pw, s, s, C)

    val = (g(y0, x0) * (hy * hx)[..., None]
           + g(y0, x1i) * (hy * lx)[..., None]
           + g(y1i, x0) * (ly * hx)[..., None]
           + g(y1i, x1i) * (ly * lx)[..., None])
    val = val * valid[..., None].to(val.dtype)
    return val.mean(dim=(3, 4)).permute(0, 3, 1, 2)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.005,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """Decode a YOLO detection head (reference yolo_box_op.cc).

    x: [N, A*(5+class_num), H, W]; img_size: [N, 2] (h, w); anchors: flat
    list [a0w, a0h, a1w, ...].  Returns (boxes [N, A*H*W, 4] in (x1, y1,
    x2, y2), scores [N, A*H*W, class_num]); predictions whose objectness
    is below conf_thresh are zeroed (the op's LoD-free contract)."""
    x = _t(x)
    dev = x.device
    img_size = _t(img_size, device=dev)
    N, _, H, W = x.shape
    A = len(anchors) // 2
    an = torch.as_tensor(np.asarray(anchors, np.float32),
                         device=dev).reshape(A, 2)          # (w, h)
    pred = x.reshape(N, A, 5 + class_num, H, W)
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    gy = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
    cx = (torch.sigmoid(pred[:, :, 0]) * alpha + beta + gx) / W
    cy = (torch.sigmoid(pred[:, :, 1]) * alpha + beta + gy) / H
    tw = torch.exp(torch.clamp(pred[:, :, 2], -10.0, 10.0))
    th = torch.exp(torch.clamp(pred[:, :, 3], -10.0, 10.0))
    input_h = downsample_ratio * H
    input_w = downsample_ratio * W
    bw = tw * an[None, :, 0, None, None] / input_w
    bh = th * an[None, :, 1, None, None] / input_h

    obj = torch.sigmoid(pred[:, :, 4])
    cls = torch.sigmoid(pred[:, :, 5:])                     # [N,A,cls,H,W]
    keep = (obj >= conf_thresh).to(x.dtype)
    scores = (cls * (obj * keep)[:, :, None]).permute(0, 1, 3, 4, 2)

    imh = img_size[:, 0][:, None, None, None]
    imw = img_size[:, 1][:, None, None, None]
    x1 = (cx - bw / 2) * imw
    y1 = (cy - bh / 2) * imh
    x2 = (cx + bw / 2) * imw
    y2 = (cy + bh / 2) * imh
    if clip_bbox:
        zero = torch.zeros((), device=dev)
        x1 = torch.clamp(x1, zero, imw - 1)
        y1 = torch.clamp(y1, zero, imh - 1)
        x2 = torch.clamp(x2, zero, imw - 1)
        y2 = torch.clamp(y2, zero, imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1) * keep[..., None]
    return (boxes.reshape(N, A * H * W, 4),
            scores.reshape(N, A * H * W, class_num))


def prior_box(input_hw, image_hw, min_sizes, max_sizes=None,
              aspect_ratios=(1.0,), variances=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, device=None):
    """SSD prior (anchor) boxes (reference prior_box_op.cc).

    input_hw: (H, W) of the feature map; image_hw: (h, w) of the image.
    Returns (boxes [H, W, P, 4] normalized (x1, y1, x2, y2), variances
    [H, W, P, 4]), on ``device`` (default: that of ``set_device``)."""
    dev = current_device() if device is None else torch.device(device)
    H, W = int(input_hw[0]), int(input_hw[1])
    img_h, img_w = float(image_hw[0]), float(image_hw[1])
    step_h = steps[0] or img_h / H
    step_w = steps[1] or img_w / W

    # expand aspect ratios like the reference (1.0 first, optional flip)
    ars = [1.0]
    for ar in aspect_ratios:
        if any(abs(ar - a) < 1e-6 for a in ars):
            continue
        ars.append(float(ar))
        if flip:
            ars.append(1.0 / float(ar))

    whs = []       # per-prior (half_w, half_h) in pixels
    for k, ms in enumerate(min_sizes):
        ms = float(ms)
        if min_max_aspect_ratios_order:
            whs.append((ms / 2, ms / 2))
            if max_sizes:
                big = np.sqrt(ms * float(max_sizes[k]))
                whs.append((big / 2, big / 2))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * np.sqrt(ar) / 2, ms / np.sqrt(ar) / 2))
        else:
            for ar in ars:
                whs.append((ms * np.sqrt(ar) / 2, ms / np.sqrt(ar) / 2))
            if max_sizes:
                big = np.sqrt(ms * float(max_sizes[k]))
                whs.append((big / 2, big / 2))
    wh = torch.as_tensor(np.asarray(whs, np.float32), device=dev)  # [P, 2]
    P = wh.shape[0]

    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offset) * step_w
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offset) * step_h
    cxg = cx[None, :, None].expand(H, W, P)
    cyg = cy[:, None, None].expand(H, W, P)
    hw_ = wh[None, None, :, 0].expand(H, W, P)
    hh_ = wh[None, None, :, 1].expand(H, W, P)
    boxes = torch.stack([(cxg - hw_) / img_w, (cyg - hh_) / img_h,
                         (cxg + hw_) / img_w, (cyg + hh_) / img_h], -1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    var = torch.as_tensor(np.asarray(variances, np.float32),
                          device=dev).expand(H, W, P, 4)
    return boxes, var


def box_coder(prior_box_, target_box, prior_box_var=None,
              code_type="encode_center_size", box_normalized=True,
              axis=0):
    """SSD box encode/decode (reference box_coder_op.cc).

    encode: target [T, 4] against priors [P, 4] -> [T, P, 4] deltas.
    decode: deltas [T, P, 4] (or [T, 4]) -> absolute boxes.
    prior_box_var: [P, 4] or a 4-vector; None = unit variance."""
    pb = _t(prior_box_)
    dev = pb.device
    tb = _t(target_box, device=dev)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw / 2
    pcy = pb[:, 1] + ph / 2
    if prior_box_var is None:
        var = torch.ones((pb.shape[0], 4), dtype=torch.float32, device=dev)
    else:
        v = _t(prior_box_var, device=dev)
        var = v.expand(pb.shape[0], 4) if v.ndim == 1 else v

    if code_type in ("encode_center_size", "encode"):
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw / 2
        tcy = tb[:, 1] + th / 2
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(torch.abs(tw[:, None] / pw[None, :]))
        dh = torch.log(torch.abs(th[:, None] / ph[None, :]))
        return torch.stack([dx, dy, dw, dh], -1) / var[None]
    if code_type in ("decode_center_size", "decode"):
        if axis not in (0, 1):
            raise ValueError(f"box_coder: axis must be 0 or 1, got {axis}")
        if tb.ndim == 2:
            tb = tb[:, None, :]
        if axis == 0:
            # priors align with dim 0 of the deltas (reference
            # box_coder_op.cc axis semantics): run in the axis=1 layout
            # and transpose both ways
            tb = tb.permute(1, 0, 2)
        d = tb * var[None]
        cx = d[..., 0] * pw[None, :] + pcx[None, :]
        cy = d[..., 1] * ph[None, :] + pcy[None, :]
        w = torch.exp(d[..., 2]) * pw[None, :]
        h = torch.exp(d[..., 3]) * ph[None, :]
        out = torch.stack([cx - w / 2, cy - h / 2,
                           cx + w / 2 - norm, cy + h / 2 - norm], -1)
        return out.permute(1, 0, 2) if axis == 0 else out
    raise ValueError(f"box_coder: unknown code_type {code_type!r}")
