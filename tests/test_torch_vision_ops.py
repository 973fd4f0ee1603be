"""``paddle_tpu_torch.vision.ops`` against the JAX package's
``paddle_tpu.vision.ops`` on the CPU, on numpy-seeded inputs.

Every public function: forward values within 1e-5 of the reference's
largest magnitude (integer outputs and indices equal), and where the op
is differentiable the gradients of a seeded cotangent within 1e-4 of
their largest magnitude. The reference's bodies are called jitted
(``raw_fn`` under ``jax.jit``, its gradients by ``jax.grad``): op by op
each jnp call compiles anew. Covered besides: ``nms`` ties (ordered as
``jnp.argsort`` orders them), the -1 padding with ``top_k`` (also past
n), multiclass suppression and the trimmed result without ``top_k``;
the RoI pools' empty bins and rois past the map; ``deform_conv2d`` v1
and v2 with deformable groups and groups; ``matrix_nms`` and
``generate_proposals`` at their static output shapes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch.vision import ops as tops
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


def _close(got, want, tol=FWD_TOL, what=""):
    got, want = as_np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:
        return
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= tol * scale, (what, err, scale)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(True) if grad else t


def _boxes(rng, n, side=40.0, lo=2.0, hi=20.0):
    xy = rng.rand(n, 2) * side
    wh = rng.rand(n, 2) * (hi - lo) + lo
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _grads(jfn, targs, ref_args, diff, out_shape, seed=0, tfn=None):
    """Gradients of ``sum(out * cot)`` by the reference (``jax.grad`` over
    positions ``diff`` of ``ref_args``) and by the port (``tfn`` on
    ``targs``, whose positions ``diff`` require grad)."""
    cot = np.random.RandomState(seed).randn(*out_shape).astype(np.float32)

    def loss(*d):
        a = list(ref_args)
        for i, v in zip(diff, d):
            a[i] = v
        return jnp.sum(jfn(*a) * cot)

    want = jax.jit(jax.grad(loss, argnums=tuple(range(len(diff)))))(
        *[ref_args[i] for i in diff])
    out = tfn(*targs)
    (out * torch.from_numpy(cot)).sum().backward()
    for i, w in zip(diff, want):
        _close(targs[i].grad, w, GRAD_TOL, f"grad {i}")


# -------------------------------------------------------------- box ops
def test_box_iou_and_area_with_gradient():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    _close(tops.box_iou(_t(a), _t(b)),
           jax.jit(jops.box_iou.raw_fn)(a, b), what="iou")
    _close(tops.box_area(_t(b)), jops.box_area.raw_fn(b), what="area")
    tb = _t(b, grad=True)
    _grads(jops.box_area.raw_fn, [tb], [jnp.asarray(b)], [0], (5,),
           tfn=tops.box_area)


def _jnms(boxes, scores, thr, cats=None, top_k=None, norm=0.0):
    return np.asarray(jops.nms.raw_fn(
        jnp.asarray(boxes), thr,
        scores=None if scores is None else jnp.asarray(scores),
        category_idxs=None if cats is None else jnp.asarray(cats),
        top_k=top_k, _norm=norm))


@pytest.mark.parametrize("top_k", [None, 6, 45])
@pytest.mark.parametrize("multiclass", [False, True])
@pytest.mark.parametrize("thr", [0.0, 0.3, 0.7])
def test_nms_matches_reference(top_k, multiclass, thr):
    """40 boxes, scores on a 0.1 grid (many ties), with and without
    categories; ``top_k`` 6 and 45 (> n: padded with -1)."""
    rng = np.random.RandomState(int(thr * 10) + 3 * multiclass)
    boxes = _boxes(rng, 40)
    scores = np.round(rng.rand(40), 1).astype(np.float32)
    cats = rng.randint(0, 3, 40) if multiclass else None
    got = tops.nms(_t(boxes), thr, _t(scores),
                   category_idxs=None if cats is None else _t(cats),
                   top_k=top_k)
    want = _jnms(boxes, scores, thr, cats, top_k)
    np.testing.assert_array_equal(as_np(got), want)
    if top_k is not None:
        assert got.shape == (top_k,)
    else:
        assert (as_np(got) >= 0).all()


def test_nms_ties_order_as_a_stable_argsort():
    """Equal scores keep index order (``jnp.argsort`` is stable); a box
    suppressed only by a suppressed box stays; no scores: index order."""
    boxes = np.array([[0, 0, 10, 10], [1, 0, 11, 10], [2, 0, 12, 10],
                      [50, 50, 60, 60], [51, 50, 61, 60]], np.float32)
    scores = np.full(5, 0.5, np.float32)
    for s in (scores, None):
        got = as_np(tops.nms(_t(boxes), 0.75,
                             None if s is None else _t(s)))
        want = _jnms(boxes, s, 0.75)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, [0, 2, 3])
    got = as_np(tops.nms(_t(boxes), 0.75, _t(scores), top_k=8))
    np.testing.assert_array_equal(got, [0, 2, 3, -1, -1, -1, -1, -1])


# ------------------------------------------------------------- RoI align
@functools.lru_cache(maxsize=None)
def _jroi_align(out, scale, sr, aligned):
    return jax.jit(lambda x, b, n: jops.roi_align.raw_fn(
        x, b, n, out, scale, sr, aligned))


@pytest.mark.parametrize("sr,aligned", [(-1, True), (2, False), (3, True)])
def test_roi_align_forward_and_gradients(sr, aligned):
    rng = np.random.RandomState(sr + 5)
    x = rng.randn(2, 3, 12, 10).astype(np.float32)
    boxes = _boxes(rng, 5, side=14, lo=1, hi=12)
    boxes[4] = [-3, -2, 25, 30]                         # past the map
    num = np.array([3, 2], np.int32)
    jfn = _jroi_align((3, 2), 0.5, sr, aligned)
    want = jfn(x, boxes, num)
    tx, tb = _t(x, grad=True), _t(boxes, grad=True)

    def tfn(a, b):
        return tops.roi_align(a, b, boxes_num=_t(num), output_size=(3, 2),
                              spatial_scale=0.5, sampling_ratio=sr,
                              aligned=aligned)

    _close(tfn(tx, tb), want, what="roi_align")
    _grads(lambda a, b: jfn(a, b, num), [tx, tb],
           [jnp.asarray(x), jnp.asarray(boxes)], [0, 1], want.shape,
           tfn=tfn)


def test_roi_align_single_image_and_missing_boxes_num():
    rng = np.random.RandomState(11)
    x = rng.randn(1, 2, 9, 9).astype(np.float32)
    boxes = _boxes(rng, 3, side=6, lo=1, hi=4)
    want = jops.roi_align.raw_fn(jnp.asarray(x), jnp.asarray(boxes), None,
                                 2, 1.0, -1, True)
    _close(tops.roi_align(_t(x), _t(boxes), output_size=2), want)
    with pytest.raises(ValueError, match="boxes_num"):
        tops.roi_align(_t(np.zeros((2, 1, 4, 4), np.float32)), _t(boxes))


# ------------------------------------------------------------ box coder
@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("with_var", [True, False])
def test_box_coder_encode_decode(normalized, with_var):
    rng = np.random.RandomState(2 * normalized + with_var)
    priors = _boxes(rng, 6)
    targets = _boxes(rng, 6)
    var = (rng.rand(6, 4).astype(np.float32) + 0.1) if with_var else None
    deltas = (rng.randn(6, 4) * 0.3).astype(np.float32)
    for code, tgt in (("encode_center_size", targets),
                      ("decode_center_size", deltas)):
        want = jops.box_coder.raw_fn(priors, var, tgt, code, normalized)
        tt = _t(tgt, grad=True)

        def tfn(t, code=code):
            return tops.box_coder(_t(priors), None if var is None
                                  else _t(var), t, code_type=code,
                                  box_normalized=normalized)

        _close(tfn(tt), want, what=code)
        _grads(lambda t, code=code: jops.box_coder.raw_fn(
            priors, var, t, code, normalized), [tt], [jnp.asarray(tgt)],
            [0], want.shape, tfn=tfn)
    with pytest.raises(NotImplementedError):
        tops.box_coder(_t(priors), None, _t(targets[None]))


@pytest.mark.parametrize("pixel_offset", [False, True])
def test_distribute_fpn_proposals_levels(pixel_offset):
    rng = np.random.RandomState(4)
    rois = _boxes(rng, 30, side=400, lo=4, hi=600)
    got = tops.distribute_fpn_proposals(_t(rois), 2, 5, 4, 224,
                                        pixel_offset=pixel_offset)
    want = jops.distribute_fpn_proposals.raw_fn(rois, 2, 5, 4, 224,
                                                pixel_offset)
    np.testing.assert_array_equal(as_np(got), np.asarray(want))
    assert got.dtype == torch.int32


# ------------------------------------------------------------- RoI pools
def test_roi_pool_forward_gradient_and_guards():
    """Random rois, one past the map (clamped), one outside it (every bin
    empty: zeros), output 3 x 2; the hand-checked overlapping bins of the
    reference's test."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    boxes = np.concatenate([_boxes(rng, 3, side=6, lo=1, hi=5),
                            [[0, 0, 20, 20], [9, 9, 12, 12]]]).astype(
                                np.float32)
    num = np.array([2, 3], np.int32)
    jfn = jax.jit(lambda a: jops._roi_pool_impl.raw_fn(a, boxes, num, 3, 2,
                                                       1.0))
    want = jfn(x)
    tx = _t(x, grad=True)

    def tfn(a):
        return tops.roi_pool(a, _t(boxes), boxes_num=_t(num),
                             output_size=(3, 2))

    got = tfn(tx)
    _close(got, want, what="roi_pool")
    assert (as_np(got)[4] == 0).all()
    _grads(jfn, [tx], [jnp.asarray(x)], [0], want.shape, tfn=tfn)
    ramp = np.arange(64, dtype=np.float32).reshape(1, 1, 8, 8)
    out = tops.roi_pool(_t(ramp), _t(np.array([[0., 0., 4., 4.]],
                                              np.float32)), output_size=2)
    np.testing.assert_array_equal(as_np(out).reshape(2, 2),
                                  [[18., 20.], [34., 36.]])
    with pytest.raises(ValueError, match="boxes_num"):
        tops.roi_pool(_t(x), _t(boxes))


def test_psroi_pool_forward_and_gradient():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 2 * 9, 8, 8).astype(np.float32)
    boxes = np.concatenate([_boxes(rng, 3, side=6, lo=1, hi=5),
                            [[0, 0, 20, 20], [9, 9, 12, 12]]]).astype(
                                np.float32)
    num = np.array([3, 2], np.int32)
    jfn = jax.jit(lambda a: jops._psroi_pool_impl.raw_fn(a, boxes, num, 3,
                                                         3, 0.75))
    want = jfn(x)
    tx = _t(x, grad=True)

    def tfn(a):
        return tops.psroi_pool(a, _t(boxes), _t(num), 3, spatial_scale=0.75)

    _close(tfn(tx), want, what="psroi_pool")
    _grads(jfn, [tx], [jnp.asarray(x)], [0], want.shape, tfn=tfn)
    with pytest.raises(ValueError, match="divisible"):
        tops.psroi_pool(_t(x[:, :10]), _t(boxes), _t(num), 3)


# ------------------------------------------------------ anchors and YOLO
@pytest.mark.parametrize("kw", [
    dict(min_sizes=[8.0], aspect_ratios=[2.0], flip=True),
    dict(min_sizes=[6.0, 12.0], max_sizes=[10.0, 20.0],
         aspect_ratios=[2.0, 3.0], clip=True, steps=(6.0, 5.0)),
    dict(min_sizes=[6.0], max_sizes=[10.0], aspect_ratios=[1.0, 2.0],
         min_max_aspect_ratios_order=True, offset=0.25,
         variance=(0.1, 0.2, 0.3, 0.4)),
])
def test_prior_box_matches_reference(kw):
    import paddle_tpu as P
    feat = np.zeros((1, 3, 4, 5), np.float32)
    img = np.zeros((1, 3, 32, 40), np.float32)
    want = jops.prior_box(P.to_tensor(feat), P.to_tensor(img), **kw)
    got = tops.prior_box(_t(feat), _t(img), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(as_np(g), np.asarray(w.numpy()))


@pytest.mark.parametrize("clip,scale", [(True, 1.0), (False, 1.2)])
def test_yolo_box_forward_and_gradient(clip, scale):
    rng = np.random.RandomState(8)
    anchors = (10, 13, 16, 30, 33, 23)
    x = rng.randn(2, 3 * (5 + 4), 5, 6).astype(np.float32)
    img = np.array([[320, 400], [256, 300]], np.int32)
    jfn = jax.jit(lambda a: jops._yolo_box_impl.raw_fn(
        a, img, anchors, 4, 0.3, 32, clip, scale))
    want = jfn(x)
    tx = _t(x, grad=True)
    got = tops.yolo_box(tx, _t(img), list(anchors), 4, conf_thresh=0.3,
                        clip_bbox=clip, scale_x_y=scale)
    for g, w, what in zip(got, want, ("boxes", "scores")):
        _close(g, w, what=what)
    _grads(lambda a: jfn(a)[0], [tx], [jnp.asarray(x)], [0],
           want[0].shape, tfn=lambda a: tops.yolo_box(
               a, _t(img), list(anchors), 4, conf_thresh=0.3,
               clip_bbox=clip, scale_x_y=scale)[0])
    with pytest.raises(NotImplementedError, match="iou_aware"):
        tops.yolo_box(tx, _t(img), list(anchors), 4, iou_aware=True)


# --------------------------------------------------------- deform conv
@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("dg,groups,stride,pad,dil", [
    (1, 1, 1, 1, 1), (2, 2, 2, 1, 1), (2, 1, 1, 2, 2)])
def test_deform_conv2d_v1_v2(v2, dg, groups, stride, pad, dil):
    rng = np.random.RandomState(dg * 10 + groups + v2)
    B, Cin, H, W, Cout, k = 2, 4, 7, 6, 6, 3
    x = rng.randn(B, Cin, H, W).astype(np.float32)
    w = (rng.randn(Cout, Cin // groups, k, k) * 0.3).astype(np.float32)
    bias = rng.randn(Cout).astype(np.float32)
    Ho = (H + 2 * pad - (dil * (k - 1) + 1)) // stride + 1
    Wo = (W + 2 * pad - (dil * (k - 1) + 1)) // stride + 1
    off = (rng.randn(B, 2 * dg * k * k, Ho, Wo) * 1.5).astype(np.float32)
    mask = rng.rand(B, dg * k * k, Ho, Wo).astype(np.float32) if v2 \
        else None

    def jfn(a, o, wt, bi, m):
        return jops._deform_conv2d_impl.raw_fn(
            a, o, wt, bi, m, stride, stride, pad, pad, dil, dil, dg, groups)

    ref = [jnp.asarray(v) for v in (x, off, w, bias)] + \
        ([jnp.asarray(mask)] if v2 else [])
    jf = jax.jit(jfn if v2 else (lambda a, o, wt, bi: jfn(a, o, wt, bi,
                                                           None)))
    want = jf(*ref)
    targs = [_t(v, grad=True) for v in (x, off, w, bias)] + \
        ([_t(mask, grad=True)] if v2 else [])

    def tfn(a, o, wt, bi, m=None):
        return tops.deform_conv2d(a, o, wt, bi, stride=stride, padding=pad,
                                  dilation=dil, deformable_groups=dg,
                                  groups=groups, mask=m)

    _close(tfn(*targs), want, what="deform_conv2d")
    _grads(jf, targs, ref, list(range(len(ref))), want.shape, tfn=tfn)


# ---------------------------------------------------------- matrix NMS
@pytest.mark.parametrize("kw", [
    dict(score_threshold=0.1, nms_top_k=6, keep_top_k=5),
    dict(score_threshold=0.05, post_threshold=0.2, nms_top_k=-1,
         keep_top_k=-1, use_gaussian=True, gaussian_sigma=1.5,
         background_label=-1),
    dict(score_threshold=0.0, nms_top_k=8, keep_top_k=40,
         normalized=False, background_label=2),
])
def test_matrix_nms_matches_reference(kw):
    rng = np.random.RandomState(9)
    boxes = np.stack([_boxes(rng, 12, side=30, lo=4, hi=16)
                      for _ in range(2)])
    scores = rng.rand(2, 4, 12).astype(np.float32)
    scores[0, 1, :4] = 0.5                                 # ties
    want = jops.matrix_nms.raw_fn(boxes, scores, return_index=True,
                                  return_rois_num=True, **kw)
    got = tops.matrix_nms(_t(boxes), _t(scores), return_index=True,
                          return_rois_num=True, **kw)
    _close(got[0], want[0], what="out")
    np.testing.assert_array_equal(as_np(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(as_np(got[2]), np.asarray(want[2]))
    only = tops.matrix_nms(_t(boxes), _t(scores), return_rois_num=False,
                           **kw)
    _close(only, want[0])


# --------------------------------------------------- RPN proposals
@pytest.mark.parametrize("pixel_offset", [False, True])
def test_generate_proposals_matches_reference(pixel_offset):
    rng = np.random.RandomState(10)
    N, A, H, W = 2, 3, 4, 5
    scores = rng.rand(N, A, H, W).astype(np.float32)
    deltas = (rng.randn(N, 4 * A, H, W) * 0.5).astype(np.float32)
    anchors = _boxes(rng, H * W * A, side=50, lo=4, hi=30).reshape(
        H, W, A, 4)
    var = np.full((H, W, A, 4), 0.5, np.float32)
    img = np.array([[60, 70], [55, 65]], np.float32)
    want = jops._generate_proposals_impl.raw_fn(
        *map(jnp.asarray, (scores, deltas, img, anchors, var)), 30, 10, 0.5,
        1.0, 1.0 if pixel_offset else 0.0, True)
    got = tops.generate_proposals(
        _t(scores), _t(deltas), _t(img), _t(anchors), _t(var),
        pre_nms_top_n=30, post_nms_top_n=10, nms_thresh=0.5, min_size=0.1,
        pixel_offset=pixel_offset, return_rois_num=True)
    for g, w, what in zip(got, want, ("rois", "probs")):
        _close(g, w, what=what)
    np.testing.assert_array_equal(as_np(got[2]), np.asarray(want[2]))
    with pytest.raises(NotImplementedError, match="eta"):
        tops.generate_proposals(_t(scores), _t(deltas), _t(img),
                                _t(anchors), _t(var), eta=0.5)


def test_registry_names_match_the_reference():
    """The JAX registry's ops from ``vision/ops.py`` are in the port's
    registry under the same names (the AMP cast hook's keys)."""
    from paddle_tpu.ops._op import OP_REGISTRY as JREG
    from paddle_tpu_torch.ops import OP_REGISTRY as TREG
    want = {n for n, f in JREG.items()
            if getattr(getattr(f, "raw_fn", f), "__module__", "")
            == "paddle_tpu.vision.ops"}
    assert want and want <= set(TREG), sorted(want - set(TREG))
    assert paddle.vision.ops.nms is tops.nms
