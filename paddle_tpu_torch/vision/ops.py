"""``paddle.vision.ops`` — the detection primitives of
``paddle_tpu/vision/ops.py`` in PyTorch (reference:
``python/paddle/vision/ops.py``).

Each function keeps the JAX package's contract: the static output shapes
(``nms`` with ``top_k`` returns exactly ``top_k`` indices padded with -1;
``matrix_nms`` and ``generate_proposals`` pad to fixed row counts), its
conventions (the +1-pixel ``norm`` of un-normalized boxes, RoI Align's
fixed two samples a bin side when ``sampling_ratio`` <= 0) and its
arithmetic order. The bodies are plain torch, as the reference's are
jnp: RoI Align, the RoI pools and the deformable convolution are
gathers and masked reductions over every roi at once; the NMS
suppression scan runs over the ranked boxes in score order (each box is
suppressed by any higher-ranked kept box over the threshold). Sorts are
stable, so tied scores order as ``jnp.argsort`` and ``lax.top_k`` order
them (the lower index first).

The float32 computations of the reference run here in the input's type
when it is wider (float64), so a float64 call is exact where the
reference, with 64-bit types off, never sees float64.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops._op import op

__all__ = ["nms", "box_iou", "box_area", "roi_align", "roi_pool",
           "box_coder", "distribute_fpn_proposals", "prior_box",
           "yolo_box", "deform_conv2d", "psroi_pool", "matrix_nms",
           "generate_proposals"]


def _clip(x, lo=None, hi=None):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, whose gradient at a
    bound splits between the tied operands (``torch.clamp``'s passes it
    whole)."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device))
    return x


def _iou_matrix(boxes_a, boxes_b, norm=0.0):
    """Pairwise IoU over the last two axes (``[..., N, 4]`` against
    ``[..., M, 4]``); ``norm=1.0`` is the reference's un-normalized
    (integer pixel) convention where spans are end - start + 1."""
    area_a = ((boxes_a[..., 2] - boxes_a[..., 0] + norm) *
              (boxes_a[..., 3] - boxes_a[..., 1] + norm))
    area_b = ((boxes_b[..., 2] - boxes_b[..., 0] + norm) *
              (boxes_b[..., 3] - boxes_b[..., 1] + norm))
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = _clip(rb - lt + norm, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / _clip(area_a[..., :, None] + area_b[..., None, :]
                         - inter, 1e-9)


def _wide(dtype):
    """The type the reference's float32 internals run in here: float32,
    or the input's own type when it is wider."""
    return torch.promote_types(dtype, torch.float32)


def _stable_desc(x, k=None):
    """``(values, indices)`` of the ``k`` largest of ``x`` along its last
    axis, ties lower index first (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    if k is not None:
        vals, idx = vals[..., :k], idx[..., :k]
    return vals, idx


def _image_of(boxes_num, R, device):
    """The image of each of ``R`` rois from the per-image counts
    (``jnp.repeat(..., total_repeat_length=R)``: a short total is
    padded with the last image, a long one cut)."""
    counts = torch.as_tensor(boxes_num, device=device).long().reshape(-1)
    img = torch.repeat_interleave(
        torch.arange(counts.numel(), device=device), counts)
    if img.numel() < R:
        img = torch.cat([img, img.new_full((R - img.numel(),),
                                           counts.numel() - 1)])
    return img[:R]


@op
def box_iou(boxes1, boxes2, name=None):
    with torch.no_grad():
        return _iou_matrix(boxes1, boxes2)


@op
def box_area(boxes, name=None):
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def _suppress(iou, iou_threshold):
    """The fixed-order suppression scan over boxes in rank order: box i
    is kept unless a higher-ranked kept box overlaps it over the
    threshold. Returns the keep mask (host numpy)."""
    over = (iou > iou_threshold).cpu().numpy()
    n = over.shape[0]
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            later = over[i, i + 1:]
            keep[i + 1:] &= ~later
    return keep


@op
def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None, _norm=0.0):
    """Hard NMS (reference paddle.vision.ops.nms): kept box indices
    sorted by descending score; multiclass (``category_idxs``)
    suppression only within a category. With ``top_k`` exactly ``top_k``
    indices padded with -1 (also when ``top_k`` > n); without it the -1
    tail is trimmed. ``_norm=1.0`` switches the IoU to the +1-pixel span
    convention (generate_proposals' pixel_offset)."""
    with torch.no_grad():
        n = boxes.shape[0]
        dev = boxes.device
        if scores is None:
            order = torch.arange(n, device=dev)
        else:
            order = torch.argsort(-scores, stable=True)
        sorted_boxes = boxes[order]
        iou = _iou_matrix(sorted_boxes, sorted_boxes, norm=_norm)
        if category_idxs is not None:
            cats = category_idxs[order]
            same = cats[:, None] == cats[None, :]
            iou = torch.where(same, iou, torch.zeros((), dtype=iou.dtype,
                                                     device=dev))
        keep = torch.from_numpy(_suppress(iou, iou_threshold)).to(dev)
        idx = order[keep]                  # kept boxes in score order
        if top_k is not None:
            pad = max(int(top_k) - idx.numel(), 0)
            idx = torch.cat([idx, idx.new_full((pad,), -1)])
            return idx[:top_k]
        return idx


@op
def roi_align(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign (reference roi_align): x [N,C,H,W], boxes [R,4] in
    (x1,y1,x2,y2); boxes_num [N] maps rois to images. Bilinear sampling
    at output_size^2 cells x sampling_ratio^2 points (2 x 2 when
    ``sampling_ratio`` <= 0)."""
    if isinstance(output_size, int):
        oh = ow = output_size
    else:
        oh, ow = output_size
    N, C, H, W = x.shape
    R = boxes.shape[0]
    dev = x.device
    if boxes_num is None:
        if N != 1:
            raise ValueError(
                f"roi_align: boxes_num is required when the batch has "
                f"{N} images (otherwise every roi would read image 0)")
        img_of = torch.zeros(R, dtype=torch.long, device=dev)
    else:
        img_of = _image_of(boxes_num, R, dev)
    offset = 0.5 if aligned else 0.0
    sr = sampling_ratio if sampling_ratio > 0 else 2
    b = boxes * spatial_scale - offset
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    rw = _clip(x2 - x1, 1e-3)
    rh = _clip(y2 - y1, 1e-3)
    bin_w, bin_h = rw / ow, rh / oh
    sub = (torch.arange(sr, device=dev, dtype=b.dtype)[None, :] + 0.5) / sr
    cy = torch.arange(oh, device=dev, dtype=b.dtype)[:, None] + sub
    cx = torch.arange(ow, device=dev, dtype=b.dtype)[:, None] + sub
    gy = (y1[:, None, None] + cy[None] * bin_h[:, None, None]).reshape(R, -1)
    gx = (x1[:, None, None] + cx[None] * bin_w[:, None, None]).reshape(R, -1)
    y0 = torch.clamp(torch.floor(gy), 0, H - 1)
    x0 = torch.clamp(torch.floor(gx), 0, W - 1)
    y1i = torch.clamp(y0 + 1, 0, H - 1).long()
    x1i = torch.clamp(x0 + 1, 0, W - 1).long()
    y0i, x0i = y0.long(), x0.long()
    ly = _clip(gy - y0, 0, 1)[:, :, None, None]           # [R, Y, 1, 1]
    lx = _clip(gx - x0, 0, 1)[:, None, :, None]           # [R, 1, X, 1]
    img = img_of[:, None, None]

    def at(yi, xi):                                       # [R, Y, X, C]
        return x[img, :, yi[:, :, None], xi[:, None, :]]

    val = (at(y0i, x0i) * (1 - ly) * (1 - lx) + at(y0i, x1i) * (1 - ly) * lx
           + at(y1i, x0i) * ly * (1 - lx) + at(y1i, x1i) * ly * lx)
    val = val.reshape(R, oh, sr, ow, sr, C).mean(dim=(2, 4))
    return val.permute(0, 3, 1, 2)                        # [R, C, oh, ow]


@op
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Encode/decode boxes against priors (reference box_coder, the SSD/
    Faster-RCNN transform). 2-D target_box aligned 1:1 with priors only;
    the reference's 3-D [N,M,4] + axis broadcast is not implemented."""
    if target_box.dim() != 2 or axis != 0:
        raise NotImplementedError(
            "box_coder: only 2-D target_box with axis=0 is supported")
    norm = 0.0 if box_normalized else 1.0
    pw = prior_box[:, 2] - prior_box[:, 0] + norm
    ph = prior_box[:, 3] - prior_box[:, 1] + norm
    pcx = prior_box[:, 0] + pw * 0.5
    pcy = prior_box[:, 1] + ph * 0.5
    var = (torch.as_tensor(prior_box_var, dtype=prior_box.dtype,
                           device=prior_box.device)
           if prior_box_var is not None else
           torch.ones(4, dtype=prior_box.dtype, device=prior_box.device))
    if code_type == "encode_center_size":
        tw = target_box[:, 2] - target_box[:, 0] + norm
        th = target_box[:, 3] - target_box[:, 1] + norm
        tcx = target_box[:, 0] + tw * 0.5
        tcy = target_box[:, 1] + th * 0.5
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log(tw / pw), torch.log(th / ph)], dim=-1)
        return out / var
    return _decode_center_size(target_box, var, pw, ph, pcx, pcy, norm)


def _decode_center_size(deltas, var, pw, ph, pcx, pcy, norm, clip=None):
    """Inverse of encode_center_size (shared by box_coder's decode branch
    and generate_proposals); ``clip`` caps the w/h log-deltas (the RPN
    kernel's kBBoxClipDefault)."""
    t = deltas * var
    tw, th = t[..., 2], t[..., 3]
    if clip is not None:
        tw = _clip(tw, hi=clip)
        th = _clip(th, hi=clip)
    cx = t[..., 0] * pw + pcx
    cy = t[..., 1] * ph + pcy
    w = torch.exp(tw) * pw
    h = torch.exp(th) * ph
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5 - norm, cy + h * 0.5 - norm], dim=-1)


@op
def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, name=None):
    """FPN level assignment (reference distribute_fpn_proposals): the
    target level per roi (the static-shape variant of the scatter)."""
    with torch.no_grad():
        off = 1.0 if pixel_offset else 0.0
        w = fpn_rois[:, 2] - fpn_rois[:, 0] + off
        h = fpn_rois[:, 3] - fpn_rois[:, 1] + off
        scale = torch.sqrt(torch.clamp(w * h, min=1e-9))
        lvl = torch.floor(torch.log2(scale / refer_scale + 1e-9)) \
            + refer_level
        return torch.clamp(lvl, min_level, max_level).to(torch.int32)


def roi_pool(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
             name=None):
    """RoIPool (reference roi_pool): max pooling over quantized roi bins —
    the pre-RoIAlign detector op. x [N,C,H,W], boxes [R,4] (x1,y1,x2,y2).

    Reference quantization: rounded roi corners, roi span end-start+1,
    per-cell [floor(i*bin), ceil((i+1)*bin)) ranges clamped to the
    feature map (cells can OVERLAP), empty cells output 0."""
    if isinstance(output_size, int):
        oh = ow = output_size
    else:
        oh, ow = output_size
    if boxes_num is None and x.shape[0] != 1:
        raise ValueError(
            f"roi_pool: boxes_num is required when the batch has "
            f"{x.shape[0]} images (otherwise every roi would read image 0)")
    return _roi_pool_impl(x, boxes, boxes_num, oh, ow, float(spatial_scale))


def _bin_masks(y0, ye, x0, xe, H, W):
    """Each roi's bin masks over the map's rows ``[R, oh, H]`` and
    columns ``[R, ow, W]``: row h is in bin i when y0[i] <= h < ye[i]."""
    ys = torch.arange(H, device=y0.device)
    xs = torch.arange(W, device=x0.device)
    my = (ys[None, None, :] >= y0[:, :, None]) & \
        (ys[None, None, :] < ye[:, :, None])
    mx = (xs[None, None, :] >= x0[:, :, None]) & \
        (xs[None, None, :] < xe[:, :, None])
    return my, mx


@op
def _roi_pool_impl(x, boxes, boxes_num, oh, ow, spatial_scale):
    N, C, H, W = x.shape
    R = boxes.shape[0]
    dev = x.device
    img_of = (torch.zeros(R, dtype=torch.long, device=dev)
              if boxes_num is None else _image_of(boxes_num, R, dev))
    wt = _wide(x.dtype)
    with torch.no_grad():
        c = torch.round(boxes.to(torch.float32) * spatial_scale).to(
            torch.int32)
        x1, y1, x2, y2 = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
        roi_h = torch.clamp(y2 - y1 + 1, min=1).to(torch.float32)
        roi_w = torch.clamp(x2 - x1 + 1, min=1).to(torch.float32)
        bin_h, bin_w = roi_h / oh, roi_w / ow
        iy = torch.arange(oh, dtype=torch.float32, device=dev)
        ix = torch.arange(ow, dtype=torch.float32, device=dev)
        y0 = torch.clamp(y1[:, None] + torch.floor(
            iy[None] * bin_h[:, None]).to(torch.int32), 0, H)
        ye = torch.clamp(y1[:, None] + torch.ceil(
            (iy[None] + 1) * bin_h[:, None]).to(torch.int32), 0, H)
        x0 = torch.clamp(x1[:, None] + torch.floor(
            ix[None] * bin_w[:, None]).to(torch.int32), 0, W)
        xe = torch.clamp(x1[:, None] + torch.ceil(
            (ix[None] + 1) * bin_w[:, None]).to(torch.int32), 0, W)
        my, mx = _bin_masks(y0, ye, x0, xe, H, W)
    neg = torch.tensor(-3.4e38, dtype=wt, device=dev)
    feat = x[img_of].to(wt)                                # [R, C, H, W]
    # separable masked max: rows first ([R, C, oh, W]), then columns
    rows = torch.amax(torch.where(my[:, None, :, :, None],
                                  feat[:, :, None], neg), dim=3)
    out = torch.amax(torch.where(mx[:, None, None], rows[:, :, :, None],
                                 neg), dim=4)
    return torch.where(out <= neg / 2, torch.zeros((), dtype=wt,
                                                   device=dev),
                       out).to(x.dtype)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD prior (anchor) boxes (reference prior_box): one box per
    (feature cell, size/aspect combo), normalized (x1,y1,x2,y2) + per-box
    variances, float32 on ``input``'s device."""
    fh, fw = (int(input.shape[2]), int(input.shape[3]))
    ih, iw = (int(image.shape[2]), int(image.shape[3]))
    step_h = steps[1] or ih / fh
    step_w = steps[0] or iw / fw
    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    boxes = []
    for s, ms in enumerate(min_sizes):
        whs = []
        for ar in ars:
            whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        if max_sizes:
            big = np.sqrt(ms * max_sizes[s])
            if min_max_aspect_ratios_order:
                whs.insert(1, (big, big))   # Caffe order: [min, max, ars]
            else:
                whs.append((big, big))      # default: [min, ars..., max]
        boxes.append(whs)
    cy = (np.arange(fh) + offset) * step_h
    cx = (np.arange(fw) + offset) * step_w
    out = []
    for y in cy:
        row = []
        for x_ in cx:
            cell = []
            for whs in boxes:
                for (w, h) in whs:
                    cell.append([(x_ - w / 2) / iw, (y - h / 2) / ih,
                                 (x_ + w / 2) / iw, (y + h / 2) / ih])
            row.append(cell)
        out.append(row)
    arr = np.asarray(out, np.float32)  # [fh, fw, P, 4]
    if clip:
        arr = np.clip(arr, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          arr.shape).copy()
    dev = input.device
    return torch.from_numpy(arr).to(dev), torch.from_numpy(var).to(dev)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5, name=None):
    """YOLOv3 head decode (reference yolo_box): raw feature map
    [N, A*(5+C), H, W] -> boxes [N, H*W*A, 4] + scores [N, H*W*A, C]."""
    if iou_aware:
        raise NotImplementedError(
            "yolo_box iou_aware=True (the [N, A*(6+C), H, W] layout) is "
            "not implemented")
    return _yolo_box_impl(x, img_size, tuple(anchors), int(class_num),
                          float(conf_thresh), int(downsample_ratio),
                          bool(clip_bbox), float(scale_x_y))


@op
def _yolo_box_impl(x, img_size, anchors, class_num, conf_thresh,
                   downsample_ratio, clip_bbox, scale_x_y):
    N, _, H, W = x.shape
    A = len(anchors) // 2
    dt, dev = x.dtype, x.device
    an = torch.tensor(anchors, dtype=torch.float32).to(dt).to(
        dev).reshape(A, 2)
    v = x.reshape(N, A, 5 + class_num, H, W)
    gx = torch.arange(W, dtype=dt, device=dev)[None, None, None, :]
    gy = torch.arange(H, dtype=dt, device=dev)[None, None, :, None]
    sig = torch.sigmoid
    bx = (gx + sig(v[:, :, 0]) * scale_x_y
          - (scale_x_y - 1.0) / 2.0) / W
    by = (gy + sig(v[:, :, 1]) * scale_x_y
          - (scale_x_y - 1.0) / 2.0) / H
    bw = torch.exp(v[:, :, 2]) * an[None, :, 0, None, None] \
        / (downsample_ratio * W)
    bh = torch.exp(v[:, :, 3]) * an[None, :, 1, None, None] \
        / (downsample_ratio * H)
    conf = sig(v[:, :, 4])
    probs = sig(v[:, :, 5:]) * conf[:, :, None]
    # to absolute pixel corners against per-image (h, w)
    imh = img_size[:, 0].to(dt)[:, None, None, None]
    imw = img_size[:, 1].to(dt)[:, None, None, None]
    x1 = (bx - bw / 2) * imw
    y1 = (by - bh / 2) * imh
    x2 = (bx + bw / 2) * imw
    y2 = (by + bh / 2) * imh
    if clip_bbox:
        zero = torch.zeros((), dtype=dt, device=dev)
        x1 = torch.minimum(torch.maximum(x1, zero), imw - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), imh - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), imw - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), imh - 1)
    keep = conf > conf_thresh
    zero = torch.zeros((), dtype=dt, device=dev)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    boxes = torch.where(keep[..., None], boxes, zero)
    probs = torch.where(keep[..., None], torch.movedim(probs, 2, -1), zero)
    boxes = boxes.reshape(N, A * H * W, 4)
    scores = probs.reshape(N, A * H * W, class_num)
    return boxes, scores


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1/v2 (reference deform_conv2d over the
    deformable_conv CUDA kernel): the per-tap bilinear sampling is four
    flat gathers, and the convolution itself one contraction over
    (in-channel, tap), accumulated in float32.

    x [B,Cin,H,W]; offset [B, 2*dg*kh*kw, Ho, Wo] laid out (group, tap,
    (dy,dx)); mask [B, dg*kh*kw, Ho, Wo] enables the v2 modulated path."""
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    dh, dw = (dilation, dilation) if isinstance(dilation, int) else dilation
    return _deform_conv2d_impl(x, offset, weight, bias, mask,
                               sh, sw, ph, pw, dh, dw,
                               int(deformable_groups), int(groups))


@op
def _deform_conv2d_impl(x, offset, weight, bias, mask, sh, sw, ph, pw,
                        dh, dw, dg, groups):
    B, Cin, H, W = x.shape
    Cout, Cg, kh, kw = weight.shape
    T = kh * kw
    dev, dt = x.device, x.dtype
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    off = offset.reshape(B, dg, T, 2, Ho, Wo)
    # sampling positions per (batch, dgroup, tap, out-pixel)
    tap_dy = (torch.arange(kh, device=dev) * dh)[:, None].repeat(
        1, kw).reshape(T)
    tap_dx = (torch.arange(kw, device=dev) * dw)[None, :].repeat(
        kh, 1).reshape(T)
    base_y = (torch.arange(Ho, device=dev) * sh - ph)[:, None]
    base_x = (torch.arange(Wo, device=dev) * sw - pw)[None, :]
    py = (base_y[None, None, None] + tap_dy[None, None, :, None, None]
          ).to(off.dtype) + off[:, :, :, 0]
    px = (base_x[None, None, None] + tap_dx[None, None, :, None, None]
          ).to(off.dtype) + off[:, :, :, 1]     # [B, dg, T, Ho, Wo]

    Cd = Cin // dg
    L = T * Ho * Wo
    xg = x.reshape(B, dg, Cd, H * W)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    zero = torch.zeros((), dtype=py.dtype, device=dev)
    out = 0.0
    for cy, wy in ((y0, 1.0 - (py - y0)), (y0 + 1, py - y0)):
        for cx, wx in ((x0, 1.0 - (px - x0)), (x0 + 1, px - x0)):
            valid = (cy >= 0) & (cy < H) & (cx >= 0) & (cx < W)
            idx = (torch.clamp(cy, 0, H - 1) * W
                   + torch.clamp(cx, 0, W - 1)).long()
            g = torch.gather(xg, 3, idx.reshape(B, dg, 1, L).expand(
                B, dg, Cd, L))
            w = torch.where(valid, wy * wx, zero).reshape(B, dg, 1, L)
            out = out + g * w.to(dt)
    sampled = out.reshape(B, dg, Cd, T, Ho, Wo)
    if mask is not None:  # v2 modulation, one scalar per (dgroup, tap)
        sampled = sampled * mask.reshape(B, dg, 1, T, Ho, Wo).to(dt)
    sampled = sampled.reshape(B, groups, Cin // groups, T, Ho, Wo)
    wg = weight.reshape(groups, Cout // groups, Cg, T)
    acc = _wide(dt)
    res = torch.einsum("goct,bgcthw->bgohw", wg.to(acc), sampled.to(acc))
    res = res.reshape(B, Cout, Ho, Wo).to(dt)
    if bias is not None:
        res = res + bias.reshape(1, Cout, 1, 1)
    return res


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling (reference psroi_pool — the R-FCN
    head): input channel (c_out, i, j) average-pools bin (i, j) of each
    roi; the same masks as ``roi_pool``, a masked mean."""
    if isinstance(output_size, int):
        oh = ow = output_size
    else:
        oh, ow = output_size
    if x.shape[1] % (oh * ow):
        raise ValueError(
            f"psroi_pool: channels {x.shape[1]} not divisible by "
            f"output_size^2 {oh * ow}")
    return _psroi_pool_impl(x, boxes, boxes_num, oh, ow,
                            float(spatial_scale))


@op
def _psroi_pool_impl(x, boxes, boxes_num, oh, ow, spatial_scale):
    N, C, H, W = x.shape
    Co = C // (oh * ow)
    R = boxes.shape[0]
    dev = x.device
    img_of = _image_of(boxes_num, R, dev)
    wt = _wide(x.dtype)
    with torch.no_grad():
        b = boxes.to(torch.float32)
        # reference: rounded corners, end exclusive at x2+1, min span 0.1
        x1 = torch.round(b[:, 0]) * spatial_scale
        y1 = torch.round(b[:, 1]) * spatial_scale
        x2 = torch.round(b[:, 2] + 1.0) * spatial_scale
        y2 = torch.round(b[:, 3] + 1.0) * spatial_scale
        rh = torch.clamp(y2 - y1, min=0.1)
        rw = torch.clamp(x2 - x1, min=0.1)
        bin_h, bin_w = rh / oh, rw / ow
        iy = torch.arange(oh, dtype=torch.float32, device=dev)[None]
        ix = torch.arange(ow, dtype=torch.float32, device=dev)[None]
        y0 = torch.clamp(torch.floor(y1[:, None] + iy * bin_h[:, None]),
                         0, H).to(torch.int32)
        ye = torch.clamp(torch.ceil(y1[:, None] + (iy + 1)
                                    * bin_h[:, None]), 0, H).to(torch.int32)
        x0 = torch.clamp(torch.floor(x1[:, None] + ix * bin_w[:, None]),
                         0, W).to(torch.int32)
        xe = torch.clamp(torch.ceil(x1[:, None] + (ix + 1)
                                    * bin_w[:, None]), 0, W).to(torch.int32)
        my, mx = _bin_masks(y0, ye, x0, xe, H, W)
        m = (my[:, None, :, None, :, None].to(wt)
             * mx[:, None, None, :, None, :].to(wt))   # [R,1,oh,ow,H,W]
    feat = x[img_of].reshape(R, Co, oh, ow, H, W).to(wt)
    # bin (i,j) reads channel slice (c, i, j): mask both spatial dims
    s = torch.sum(feat * m, dim=(4, 5))
    cnt = torch.clamp(torch.sum(m, dim=(4, 5)), min=1e-9)
    return (s / cnt).to(x.dtype)                          # [R, Co, oh, ow]


@op
def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (reference matrix_nms, the SOLOv2 parallel soft-NMS):
    per class, every box's score decays by min_j f(iou_ij)/f(iou_max_j)
    over higher-scored boxes j — one IoU matrix instead of the greedy
    suppression loop.

    Static-shape contract (as ``nms``): per image the top
    ``kk = min(keep_top_k, C * nms_top_k)`` rows (all candidates when
    keep_top_k = -1) come back as [label, score, x1, y1, x2, y2] with
    label = -1 on padding rows; out [N, kk, 6], index [N, kk] (flat
    class*M+box, -1 pad), rois_num [N]."""
    with torch.no_grad():
        N, M, _ = bboxes.shape
        C = scores.shape[1]
        dev, dt = bboxes.device, bboxes.dtype
        k = min(int(nms_top_k), M) if nms_top_k > 0 else M
        kk = min(int(keep_top_k), C * k) if keep_top_k > 0 else C * k
        iou_norm = 0.0 if normalized else 1.0
        higher = torch.tril(torch.ones(k, k, dtype=torch.bool, device=dev),
                            -1)                       # j above i
        one = torch.ones((), dtype=dt, device=dev)
        neg1 = -one
        outs, idxs, nums = [], [], []
        for box, sc in zip(bboxes, scores):           # [M,4], [C,M]
            vals, order = _stable_desc(sc, k)         # [C,k]
            sel = box[order]                          # [C,k,4]
            iou = _iou_matrix(sel, sel, norm=iou_norm)
            iou = torch.where(higher, iou, 0 * one)
            iou_max = torch.amax(iou, dim=2)          # compensation per j
            if use_gaussian:
                # reference kernel (SOLOv2): exp(-sigma*iou^2) /
                # exp(-sigma*comp^2) — sigma MULTIPLIES the exponent
                decay = torch.exp((iou_max[:, None, :] ** 2 - iou ** 2)
                                  * gaussian_sigma)
            else:
                decay = (1.0 - iou) / torch.clamp(
                    1.0 - iou_max[:, None, :], min=1e-10)
            decay = torch.amin(torch.where(higher, decay, one), dim=2)
            cs = torch.where(vals > score_threshold, vals * decay, neg1)
            cs = torch.where(cs > post_threshold, cs, neg1)
            cls_valid = torch.arange(C, device=dev) != background_label
            cs = torch.where(cls_valid[:, None], cs, neg1)
            top_s, top_i = _stable_desc(cs.reshape(-1), kk)
            cls_of = torch.div(top_i, k, rounding_mode="floor")
            box_of = order.reshape(-1)[top_i]
            good = top_s > 0
            outs.append(torch.cat(
                [torch.where(good, cls_of.to(dt), neg1)[:, None],
                 top_s[:, None],
                 torch.where(good[:, None], box[box_of], 0 * one)], dim=1))
            idxs.append(torch.where(good, cls_of * M + box_of,
                                    torch.full_like(box_of, -1)))
            nums.append(good.sum().to(torch.int32))
        out = torch.stack(outs)
        res = [out]
        if return_index:
            res.append(torch.stack(idxs))
        if return_rois_num:
            res.append(torch.stack(nums))
        return tuple(res) if len(res) > 1 else out


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False,
                       name=None):
    """RPN proposal generation (reference generate_proposals_v2):
    per image, decode anchor deltas -> clip to the image -> drop
    sub-min_size boxes -> top pre_nms_top_n by score -> hard NMS ->
    top post_nms_top_n.

    Static-shape contract: rois/roi_probs come back [N, post_nms_top_n,
    4]/[N, post_nms_top_n] zero-padded, rois_num [N] giving the valid
    count per image (the reference's LoD boundary)."""
    if eta < 1.0:
        raise NotImplementedError(
            "generate_proposals: adaptive-NMS (eta < 1) is not "
            "implemented — the static-shape schedule runs hard NMS; "
            "pass eta=1.0")
    return _generate_proposals_impl(
        scores, bbox_deltas, img_size, anchors, variances,
        int(pre_nms_top_n), int(post_nms_top_n), float(nms_thresh),
        # reference FilterBoxes floors min_size at 1 pixel
        max(float(min_size), 1.0), 1.0 if pixel_offset else 0.0,
        return_rois_num)


@op
def _generate_proposals_impl(scores, bbox_deltas, img_size, anchors,
                             variances, pre_n, post_n, nms_thresh, min_size,
                             offset, return_rois_num):
    with torch.no_grad():
        N, A, H, W = scores.shape
        M = A * H * W
        anc = anchors.reshape(M, 4)
        var = variances.reshape(M, 4)
        pre_n = min(pre_n, M)
        rois, probs, nums = [], [], []
        for sc, deltas, imsz in zip(scores, bbox_deltas, img_size):
            s = sc.reshape(A, H, W).permute(1, 2, 0).reshape(M)
            d = deltas.reshape(A, 4, H, W).permute(2, 3, 0, 1).reshape(M, 4)
            top_s, top_i = _stable_desc(s, pre_n)
            a = anc[top_i]
            v = var[top_i]
            dd = d[top_i]
            aw = a[:, 2] - a[:, 0] + offset
            ah = a[:, 3] - a[:, 1] + offset
            acx = a[:, 0] + aw * 0.5
            acy = a[:, 1] + ah * 0.5
            # shared center-size decode; w/h log-deltas capped at the RPN
            # kernel's kBBoxClipDefault = log(1000/16)
            dec = _decode_center_size(dd, v, aw, ah, acx, acy, offset,
                                      clip=math.log(1000.0 / 16.0))
            ih, iw = imsz[0].to(dec.dtype), imsz[1].to(dec.dtype)
            zero = torch.zeros((), dtype=dec.dtype, device=dec.device)
            x1 = torch.minimum(torch.maximum(dec[:, 0], zero), iw - offset)
            y1 = torch.minimum(torch.maximum(dec[:, 1], zero), ih - offset)
            x2 = torch.minimum(torch.maximum(dec[:, 2], zero), iw - offset)
            y2 = torch.minimum(torch.maximum(dec[:, 3], zero), ih - offset)
            boxes = torch.stack([x1, y1, x2, y2], dim=-1)
            ok = ((x2 - x1 + offset) >= min_size) & \
                ((y2 - y1 + offset) >= min_size)
            top_s = torch.where(ok, top_s, torch.full_like(top_s,
                                                           -math.inf))
            keep = nms.raw_fn(boxes, nms_thresh, scores=top_s, top_k=post_n,
                              _norm=offset)
            ki = torch.clamp(keep, 0, pre_n - 1)
            good = (keep >= 0) & (top_s[ki] > -math.inf)
            rois.append(torch.where(good[:, None], boxes[ki], zero))
            probs.append(torch.where(good, top_s[ki], zero))
            nums.append(good.sum().to(torch.int32))
        rois, probs, num = torch.stack(rois), torch.stack(probs), \
            torch.stack(nums)
        if return_rois_num:
            return rois, probs, num
        return rois, probs
