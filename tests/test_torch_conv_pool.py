"""The port's convolutions and pools (``paddle_tpu_torch.nn.functional``)
against the JAX package's, on the CPU, on numpy inputs from a seed:

- conv 1-D/2-D/3-D with every padding form (an int, one int a dim, lo/hi
  pairs flat or paired, the full-tensor pair list in NCHW and NHWC
  order, XLA's ``SAME`` with its odd pixel on the high side at stride 2,
  ``VALID``), groups, dilation, NHWC, and the transposes (asymmetric
  pads, ``output_padding``, groups, dilation);
- max/avg pools 1-D/2-D/3-D at the ``ceil_mode`` edges (a last window
  that starts in the padding, which torch's own ceil mode drops),
  ``exclusive`` on and off, ``divisor_override``, string padding, NHWC,
  ``return_mask``; adaptive pools at sizes that do not divide; unpool;
  fractional pools (given ``u`` and drawn); lp pools.

Float outputs agree to 1e-5 of the reference's largest magnitude and
gradients to 1e-4 (``test_torch_nn_functional``'s bounds); the masks'
indices are equal. Each JAX reference runs as one jitted program with a
jitted VJP.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as TF
from test_torch_nn_functional import (FWD_TOL, GRAD_TOL, _inputs, _jax_jit,
                                      _jax_tape, _rel_err, _torch_side)
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401

R = np.random.RandomState(3)


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


def _g(*shape):
    return ("grad", R.randn(*shape).astype(np.float32))


def check(name, spec, kwargs=None, seed=None):
    """``name`` of both packages on ``spec``: float outputs and gradients
    within the bounds, integer outputs (masks) equal by value."""
    kwargs = kwargs or {}
    ins = _inputs(spec)
    tl, cots, tg = _torch_side(getattr(TF, name), ins, kwargs, seed)
    if seed is not None:
        jl, jg = _jax_tape(getattr(JF, name), ins, kwargs, seed, cots)
    else:
        jl, jg = _jax_jit(getattr(JF, name), ins, kwargs, cots)
    assert len(jl) == len(tl)
    for g, w in zip(tl, jl):
        if g.is_floating_point():
            # a ceil-mode window wholly in the padding is -inf on both
            g, w = as_np(g), np.asarray(as_np(w))
            np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
            fin = np.isfinite(w)
            assert _rel_err(np.where(fin, g, 0), np.where(fin, w, 0)) \
                <= FWD_TOL
        else:
            np.testing.assert_array_equal(as_np(g), np.asarray(as_np(w)))
    for g, w in zip(tg, jg):
        assert _rel_err(g, w) <= GRAD_TOL


# ------------------------------------------------------------------- conv
X4 = R.randn(2, 4, 9, 11).astype(np.float32)
CONV2D = [
    ("int", {"padding": 1}),
    ("per-dim", {"padding": [1, 2], "stride": 2}),
    ("lo-hi-flat", {"padding": [0, 2, 1, 0]}),
    ("pairs", {"padding": [[2, 1], [0, 1]]}),
    ("full-nchw", {"padding": [[0, 0], [0, 0], [1, 2], [2, 0]]}),
    ("same-s2", {"padding": "SAME", "stride": 2}),
    ("same-dil", {"padding": "same", "dilation": 2}),
    ("valid", {"padding": "VALID", "stride": (2, 1)}),
    ("groups", {"padding": 1, "groups": 2}),
    ("dilation", {"padding": 2, "dilation": (2, 1)}),
]


@pytest.mark.parametrize("case,kw", CONV2D, ids=[c for c, _ in CONV2D])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_conv2d(case, kw, bias):
    groups = kw.get("groups", 1)
    spec = [("grad", X4), _g(6, 4 // groups, 3, 3)] + \
        ([_g(6)] if bias else [])
    check("conv2d", spec, kw)


@pytest.mark.parametrize("padding", [1, "SAME", [[0, 0], [1, 0], [2, 1],
                                                 [0, 0]]],
                         ids=["int", "same", "full-nhwc"])
def test_conv2d_nhwc(padding):
    x = R.randn(2, 8, 7, 4).astype(np.float32)
    check("conv2d", [("grad", x), _g(5, 4, 3, 2), _g(5)],
          {"padding": padding, "stride": 2, "data_format": "NHWC"})


def test_conv_refuses_channel_padding():
    with pytest.raises(ValueError, match="batch/channel"):
        TF.conv2d(paddle.to_tensor(X4), paddle.to_tensor(
            np.zeros((2, 4, 3, 3), np.float32)),
            padding=[[0, 0], [1, 1], [1, 1], [1, 1]])


@pytest.mark.parametrize("kw", [{"padding": 2, "stride": 2},
                                {"padding": "SAME", "dilation": 3},
                                {"padding": [1, 3], "groups": 3},
                                {"padding": 1, "data_format": "NLC"}],
                         ids=["int", "same", "lohi-groups", "nlc"])
def test_conv1d(kw):
    x = R.randn(2, 6, 13).astype(np.float32)
    if kw.get("data_format") == "NLC":
        x = x.transpose(0, 2, 1).copy()
    check("conv1d", [("grad", x), _g(9, 6 // kw.get("groups", 1), 4),
                     _g(9)], kw)


@pytest.mark.parametrize("kw", [{"padding": 1},
                                {"padding": "SAME", "stride": 2},
                                {"padding": [1, 0, 0, 2, 1, 1], "groups": 2},
                                {"padding": 1, "data_format": "NDHWC"}],
                         ids=["int", "same", "lohi-groups", "ndhwc"])
def test_conv3d(kw):
    x = R.randn(2, 4, 5, 6, 7).astype(np.float32)
    if kw.get("data_format") == "NDHWC":
        x = x.transpose(0, 2, 3, 4, 1).copy()
    check("conv3d", [("grad", x), _g(6, 4 // kw.get("groups", 1), 3, 2, 3),
                     _g(6)], kw)


CONV_T = [
    ("plain", {}),
    ("stride-pad", {"stride": 2, "padding": 1}),
    ("output-padding", {"stride": 2, "padding": 1, "output_padding": 1}),
    ("asymmetric", {"stride": 2, "padding": [[1, 0], [0, 2]]}),
    ("big-pad", {"padding": 3}),
    ("groups", {"stride": 2, "groups": 2}),
    ("dilation", {"dilation": 2, "padding": 1}),
]


@pytest.mark.parametrize("case,kw", CONV_T, ids=[c for c, _ in CONV_T])
def test_conv2d_transpose(case, kw):
    g = kw.get("groups", 1)
    check("conv2d_transpose", [("grad", R.randn(2, 4, 5, 6).astype(
        np.float32)), _g(4, 6 // g, 3, 3), _g(6)], kw)


def test_conv2d_transpose_nhwc():
    check("conv2d_transpose", [("grad", R.randn(2, 5, 6, 4).astype(
        np.float32)), _g(4, 3, 3, 2), _g(3)],
        {"stride": 2, "padding": 1, "data_format": "NHWC"})


@pytest.mark.parametrize("kw", [{"stride": 2, "padding": 1},
                                {"stride": 3, "output_padding": 2}])
def test_conv1d_transpose(kw):
    check("conv1d_transpose", [("grad", R.randn(2, 4, 7).astype(
        np.float32)), _g(4, 5, 3), _g(5)], kw)


@pytest.mark.parametrize("kw", [{"stride": 2, "padding": 1},
                                {"padding": [[1, 0], [0, 1], [2, 1]],
                                 "groups": 2}])
def test_conv3d_transpose(kw):
    g = kw.get("groups", 1)
    check("conv3d_transpose", [("grad", R.randn(1, 4, 3, 4, 5).astype(
        np.float32)), _g(4, 6 // g, 2, 3, 2), _g(6)], kw)


# ------------------------------------------------------------------ pools
P4 = R.randn(2, 3, 10, 9).astype(np.float32)
POOL2D = [
    ("k3s2", {"kernel_size": 3, "stride": 2}),
    ("k3s2p1", {"kernel_size": 3, "stride": 2, "padding": 1}),
    ("ceil", {"kernel_size": 3, "stride": 2, "ceil_mode": True}),
    # the last ceil-mode window starts in the padding: torch drops it
    ("ceil-pad-window", {"kernel_size": 2, "stride": 2, "padding": 1,
                         "ceil_mode": True}),
    ("ceil-asym", {"kernel_size": (3, 2), "stride": (3, 2),
                   "padding": [0, 1, 1, 0], "ceil_mode": True}),
    ("same", {"kernel_size": 3, "stride": 2, "padding": "SAME"}),
    ("valid", {"kernel_size": (2, 3), "padding": "VALID"}),
    ("pairs", {"kernel_size": 3, "stride": 1,
               "padding": [[1, 0], [0, 1]]}),
]


@pytest.mark.parametrize("case,kw", POOL2D, ids=[c for c, _ in POOL2D])
def test_max_pool2d(case, kw):
    check("max_pool2d", [("grad", P4)], kw)


def _mask_brute(x, k, s, pads):
    """Each window's first maximum (window order) over the -inf-padded
    input, as a flat index into the unpadded spatial dims."""
    nd = len(k)
    xp = np.pad(x, [(0, 0), (0, 0)] + list(pads), constant_values=-np.inf)
    outs = [(xp.shape[2 + d] - k[d]) // s[d] + 1 for d in range(nd)]
    mask = np.zeros(x.shape[:2] + tuple(outs), np.int64)
    for o in np.ndindex(*outs):
        sl = tuple(slice(o[d] * s[d], o[d] * s[d] + k[d]) for d in range(nd))
        win = xp[(Ellipsis,) + sl].reshape(x.shape[:2] + (-1,))
        am = np.argmax(win, axis=-1)
        flat = np.zeros_like(am)
        for d in range(nd):
            c = (am // int(np.prod(k[d + 1:]))) % k[d]
            flat = flat * x.shape[2 + d] + o[d] * s[d] - pads[d][0] + c
        mask[(Ellipsis,) + o] = flat
    return mask


# The reference's mask takes each window's argmax over patches that
# conv_general_dilated_patches cuts from the -inf-padded input: a one-hot
# filter times -inf is NaN, so wherever a pool pads (padding, or ceil
# mode's extra), its border windows point into the padding (ROADMAP.md
# Queue C 10). Those cases are held to the windows' first maximum
# (``_mask_brute``), the unpadded ones to the reference.
MASK2D = [("k3s2", {"kernel_size": 3, "stride": 2}, None),
          ("k2", {"kernel_size": 2}, None),
          ("k3s2p1", {"kernel_size": 3, "stride": 2, "padding": 1},
           [(1, 1), (1, 1)]),
          ("ceil", {"kernel_size": 3, "stride": 2, "ceil_mode": True},
           [(0, 1), (0, 0)]),
          ("ceil-pad-window", {"kernel_size": 2, "stride": 2, "padding": 1,
                               "ceil_mode": True}, [(1, 1), (1, 2)]),
          ("pairs", {"kernel_size": 3, "stride": 1,
                     "padding": [[1, 0], [0, 1]]}, [(1, 0), (0, 1)])]


@pytest.mark.parametrize("case,kw,pads", MASK2D,
                         ids=[c for c, _, _ in MASK2D])
def test_max_pool2d_mask(case, kw, pads):
    kw = {**kw, "return_mask": True}
    if pads is None:
        check("max_pool2d", [("grad", P4)], kw)
        return
    out, mask = TF.max_pool2d(paddle.to_tensor(P4), **kw)
    k = (kw["kernel_size"],) * 2
    s = (kw.get("stride") or kw["kernel_size"],) * 2
    np.testing.assert_array_equal(as_np(mask), _mask_brute(P4, k, s, pads))
    want = JF.max_pool2d(P.to_tensor(P4), **kw)[0]
    np.testing.assert_array_equal(as_np(out), np.asarray(want.value))


@pytest.mark.parametrize("case,kw", POOL2D, ids=[c for c, _ in POOL2D])
@pytest.mark.parametrize("exclusive", [True, False],
                         ids=["exclusive", "inclusive"])
def test_avg_pool2d(case, kw, exclusive):
    check("avg_pool2d", [("grad", P4)], {**kw, "exclusive": exclusive})


def test_avg_pool2d_divisor_override_and_nhwc():
    check("avg_pool2d", [("grad", P4)], {"kernel_size": 3, "padding": 1,
                                         "ceil_mode": True,
                                         "divisor_override": 5})
    x = P4.transpose(0, 2, 3, 1).copy()
    for name in ("avg_pool2d", "max_pool2d"):
        check(name, [("grad", x)], {"kernel_size": 3, "stride": 2,
                                    "padding": 1, "data_format": "NHWC"})
    check("max_pool2d", [("grad", x)], {"kernel_size": 2, "stride": 2,
                                        "return_mask": True,
                                        "data_format": "NHWC"})


def test_ceil_mode_output_sizes_are_the_references():
    """A last window starting in the padding stays (torch's ceil mode
    drops it): 9 columns, k 2, s 2, p 1 -> 6 columns, not 5."""
    x = paddle.to_tensor(P4)
    out = TF.max_pool2d(x, 2, 2, 1, ceil_mode=True)
    assert tuple(out.shape) == (2, 3, 6, 6)
    import torch
    assert tuple(torch.nn.functional.max_pool2d(
        x, 2, 2, 1, ceil_mode=True).shape) == (2, 3, 6, 5)


P5 = R.randn(1, 2, 7, 6, 5).astype(np.float32)
POOL3D = [({"kernel_size": 2}), ({"kernel_size": 3, "stride": 2,
                                  "padding": 1, "ceil_mode": True}),
          ({"kernel_size": (2, 3, 2), "padding": "SAME"})]


@pytest.mark.parametrize("kw", POOL3D, ids=["k2", "ceil", "same"])
@pytest.mark.parametrize("name", ["max_pool3d", "avg_pool3d"])
def test_pool3d(name, kw):
    check(name, [("grad", P5)], kw)


def test_max_pool3d_mask_and_ndhwc():
    check("max_pool3d", [("grad", P5)], {"kernel_size": 2, "stride": 2,
                                         "return_mask": True})
    _, mask = TF.max_pool3d(paddle.to_tensor(P5), 3, 2, 1, return_mask=True)
    np.testing.assert_array_equal(
        as_np(mask), _mask_brute(P5, (3,) * 3, (2,) * 3, [(1, 1)] * 3))
    check("avg_pool3d", [("grad", P5.transpose(0, 2, 3, 4, 1).copy())],
          {"kernel_size": 2, "data_format": "NDHWC"})


@pytest.mark.parametrize("name,kw", [
    ("max_pool1d", {"kernel_size": 3, "stride": 2, "padding": 1,
                    "ceil_mode": True}),
    ("max_pool1d", {"kernel_size": 2, "return_mask": True}),
    ("avg_pool1d", {"kernel_size": 3, "stride": 2, "padding": 1,
                    "exclusive": False}),
    ("avg_pool1d", {"kernel_size": 3, "stride": 2, "ceil_mode": True}),
    ("lp_pool1d", {"norm_type": 2, "kernel_size": 3, "stride": 2}),
], ids=["max-ceil", "max-mask", "avg", "avg-ceil-ignored", "lp"])
def test_pool1d(name, kw):
    check(name, [("grad", R.randn(2, 3, 11).astype(np.float32))], kw)


@pytest.mark.parametrize("kw", [{"norm_type": 2, "kernel_size": 3},
                                {"norm_type": 3.0, "kernel_size": 2,
                                 "stride": 2, "padding": 1,
                                 "ceil_mode": True},
                                {"norm_type": float("inf"),
                                 "kernel_size": 2}],
                         ids=["p2", "p3-ceil", "inf"])
def test_lp_pool2d(kw):
    check("lp_pool2d", [("grad", P4)], kw)


@pytest.mark.parametrize("size", [1, (3, 4), (4, 3), (5, 9), (10, 9)],
                         ids=["1", "3x4", "4x3-divides", "5x9", "same"])
@pytest.mark.parametrize("name", ["adaptive_avg_pool2d",
                                  "adaptive_max_pool2d"])
def test_adaptive_pool2d(name, size):
    check(name, [("grad", P4)], {"output_size": size})


@pytest.mark.parametrize("size", [(3, 4), (2, 3)])
def test_adaptive_max_pool2d_mask(size):
    check("adaptive_max_pool2d", [("grad", P4)],
          {"output_size": size, "return_mask": True})


@pytest.mark.parametrize("name,kw", [
    ("adaptive_avg_pool3d", {"output_size": (3, 4, 2)}),
    ("adaptive_avg_pool3d", {"output_size": 1}),
    ("adaptive_max_pool3d", {"output_size": (3, 4, 2)}),
    ("adaptive_max_pool3d", {"output_size": (2, 3, 5),
                             "return_mask": True}),
    ("adaptive_avg_pool1d", {"output_size": 4}),
    ("adaptive_max_pool1d", {"output_size": 4, "return_mask": True}),
], ids=["avg3d", "avg3d-1", "max3d", "max3d-mask", "avg1d", "max1d-mask"])
def test_adaptive_pool_other_ranks(name, kw):
    x = P5 if "3d" in name else R.randn(2, 3, 11).astype(np.float32)
    check(name, [("grad", x)], kw)


def _masked(x, k, s, p):
    out, mask = TF.max_pool2d(paddle.to_tensor(x), k, s, p,
                              return_mask=True)
    return as_np(out), as_np(mask)


# windows that do not overlap: where two windows share their maximum the
# scatter has a duplicate index, which the reference resolves to one write
# (one gradient) and torch to both
@pytest.mark.parametrize("kw", [{"kernel_size": 2},
                                {"kernel_size": 3, "stride": 3,
                                 "padding": 1}],
                         ids=["k2", "k3s3p1"])
def test_max_unpool2d(kw):
    out, mask = _masked(P4, kw["kernel_size"], kw.get("stride"),
                        kw.get("padding", 0))
    check("max_unpool2d", [("grad", out), mask.astype(np.int32)],
          {**kw, "output_size": (10, 9)})


def test_max_unpool1d_and_3d():
    x = R.randn(2, 3, 8).astype(np.float32)
    out, mask = TF.max_pool1d(paddle.to_tensor(x), 2, return_mask=True)
    check("max_unpool1d", [("grad", as_np(out)), as_np(mask).astype(
        np.int32)], {"kernel_size": 2})
    out, mask = TF.max_pool3d(paddle.to_tensor(P5), 2, return_mask=True)
    check("max_unpool3d", [("grad", as_np(out)), as_np(mask).astype(
        np.int32)], {"kernel_size": 2, "output_size": (7, 6, 5)})


@pytest.mark.parametrize("kw", [
    {"output_size": (4, 5), "random_u": 0.3},
    {"output_size": 3, "kernel_size": 2, "random_u": 0.7},
    {"output_size": (4, 5), "random_u": 0.5, "return_mask": True},
], ids=["u", "kernel", "mask"])
def test_fractional_max_pool2d(kw):
    check("fractional_max_pool2d", [("grad", P4)], kw)


def test_fractional_max_pool_draws_u_from_the_key_walk():
    check("fractional_max_pool2d", [("grad", P4)], {"output_size": (4, 5)},
          seed=11)
    check("fractional_max_pool3d", [("grad", P5)],
          {"output_size": (3, 3, 2), "return_mask": True}, seed=12)
