"""The port's new layers and ``nn.utils`` against the JAX package's, on
the CPU: the conv layers (Kaiming-uniform weights and uniform biases bit
for bit after the same seed), the pooling layers, the spatial norms
(``GroupNorm``, the instance norms, ``LocalResponseNorm``,
``SyncBatchNorm`` on one rank, the batch norms' momentum and
``use_global_stats``), the common layers (resampling in every mode,
shuffles, pads, patches, distances, ``Softmax2D``, the channel and alpha
dropouts with their masks), ``F.normalize`` and ``F.interpolate``, and
``nn.utils``. Each layer takes the JAX layer's weights by
``set_state_dict``; outputs agree to 1e-5 and gradients to 1e-4 of the
reference's largest magnitude (``test_torch_nn_layer``'s bounds).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from test_torch_nn_functional import check
from test_torch_nn_layer import (FWD_TOL, _forward_backward, _jstate, _pair,
                                 _rel)
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401

R = np.random.RandomState(5)
X4 = R.randn(2, 6, 8, 10).astype(np.float32)
X3 = R.randn(2, 6, 12).astype(np.float32)
X5 = R.randn(2, 4, 5, 6, 3).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


# ------------------------------------------------------------------ conv
CONV_LAYERS = [
    ("Conv2D", (6, 4, 3), {"padding": 1, "stride": 2}, X4),
    ("Conv2D", (6, 8, (3, 2)), {"groups": 2, "bias_attr": False}, X4),
    ("Conv2D", (6, 4, 3), {"padding": "SAME", "dilation": 2}, X4),
    ("Conv1D", (6, 5, 3), {"padding": 1}, X3),
    ("Conv3D", (4, 3, 2), {"padding": 1}, X5),
    ("Conv2DTranspose", (6, 4, 3), {"stride": 2, "padding": 1}, X4),
    ("Conv2DTranspose", (6, 4, 3), {"stride": 2, "groups": 2,
                                    "output_padding": 1}, X4),
    ("Conv1DTranspose", (6, 3, 4), {"stride": 2}, X3),
    ("Conv3DTranspose", (4, 2, 2), {"stride": 2}, X5),
]


@pytest.mark.parametrize("case", CONV_LAYERS,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(CONV_LAYERS)])
def test_conv_layer_init_bit_for_bit_and_parity(case):
    name, args, kw, x = case
    jl, tl = _pair(lambda: getattr(jnn, name)(*args, **kw),
                   lambda: getattr(tnn, name)(*args, **kw), seed=8)
    assert list(tl.state_dict()) == list(jl.state_dict())
    for (k, v), w in zip(tl.state_dict().items(), _jstate(jl).values()):
        np.testing.assert_array_equal(as_np(v), w, err_msg=k)
    _forward_backward(jl, tl, x)


# ------------------------------------------------------------------ pools
POOL_LAYERS = [
    ("MaxPool2D", (3, 2, 1), {}, X4),
    ("MaxPool2D", (2,), {"ceil_mode": True}, X4[..., :7]),
    ("AvgPool2D", (3, 2, 1), {"ceil_mode": True}, X4),
    ("AvgPool2D", (3,), {"exclusive": False, "divisor_override": 4}, X4),
    ("MaxPool1D", (3, 2), {}, X3),
    ("AvgPool1D", (3, 2, 1), {"exclusive": False}, X3),
    ("MaxPool3D", (2,), {}, X5),
    ("AvgPool3D", (3, 2, 1), {"ceil_mode": True}, X5),
    ("AdaptiveAvgPool2D", ((3, 4),), {}, X4),
    ("AdaptiveAvgPool2D", (1,), {}, X4),
    ("AdaptiveMaxPool2D", ((3, 3),), {}, X4),
    ("AdaptiveAvgPool1D", (5,), {}, X3),
    ("AdaptiveMaxPool1D", (5,), {}, X3),
    ("AdaptiveAvgPool3D", ((2, 4, 2),), {}, X5),
    ("FractionalMaxPool2D", ((4, 5),), {"random_u": 0.4}, X4),
    ("FractionalMaxPool3D", ((3, 4, 2),), {"random_u": 0.6}, X5),
]


@pytest.mark.parametrize("case", POOL_LAYERS,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(POOL_LAYERS)])
def test_pool_layer(case):
    name, args, kw, x = case
    jl, tl = _pair(lambda: getattr(jnn, name)(*args, **kw),
                   lambda: getattr(tnn, name)(*args, **kw))
    _forward_backward(jl, tl, np.ascontiguousarray(x))


def test_unpool_layers_invert_the_masked_pool():
    x = paddle.to_tensor(X4)
    out, mask = TF.max_pool2d(x, 2, return_mask=True)
    up = tnn.MaxUnPool2D(2)(out, mask)
    jup = jnn.MaxUnPool2D(2)(P.to_tensor(as_np(out)),
                             P.to_tensor(as_np(mask).astype(np.int32)))
    np.testing.assert_array_equal(as_np(up), np.asarray(jup.value))
    kept = as_np(up) != 0
    np.testing.assert_array_equal(as_np(up)[kept], X4[kept])
    out, mask = TF.max_pool1d(paddle.to_tensor(X3), 3, return_mask=True)
    assert tuple(tnn.MaxUnPool1D(3)(out, mask).shape) == (2, 6, 12)
    out, mask = TF.max_pool3d(paddle.to_tensor(X5[..., :2]), 2,
                              return_mask=True)
    assert tuple(tnn.MaxUnPool3D(2)(out, mask).shape) == (2, 4, 4, 6, 2)


# ------------------------------------------------------------------ norms
NORM_LAYERS = [
    ("GroupNorm", (3, 6), {}, X4),
    ("GroupNorm", (2, 6), {"data_format": "NHWC"},
     X4.transpose(0, 2, 3, 1).copy()),
    ("InstanceNorm1D", (6,), {}, X3),
    ("InstanceNorm2D", (6,), {}, X4),
    ("InstanceNorm3D", (4,), {}, X5),
    ("LocalResponseNorm", (3,), {}, X4),
    ("LocalResponseNorm", (4,), {"alpha": 1e-2, "beta": 0.5, "k": 2.0}, X4),
    ("SyncBatchNorm", (6,), {}, X4),
    ("BatchNorm2D", (6,), {"momentum": 0.8}, X4),
    ("BatchNorm2D", (6,), {"use_global_stats": True}, X4),
    ("BatchNorm2D", (6,), {"data_format": "NHWC"},
     X4.transpose(0, 2, 3, 1).copy()),
]


@pytest.mark.parametrize("case", NORM_LAYERS,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(NORM_LAYERS)])
def test_norm_layer(case):
    name, args, kw, x = case
    jl, tl = _pair(lambda: getattr(jnn, name)(*args, **kw),
                   lambda: getattr(tnn, name)(*args, **kw))
    assert list(tl.state_dict()) == list(jl.state_dict())
    _forward_backward(jl, tl, x)
    jb = dict(jl.named_buffers())
    for n, b in tl.named_buffers():
        assert _rel(b, jb[n]) <= FWD_TOL, n


def test_batch_norm_running_stats_follow_paddle_momentum():
    """``running = 0.9 running + 0.1 batch`` with the biased variance, two
    steps; then eval mode reads them."""
    bn = tnn.BatchNorm2D(6)
    x = paddle.to_tensor(X4)
    for _ in range(2):
        bn(x)
    mean = X4.mean(axis=(0, 2, 3))
    var = X4.var(axis=(0, 2, 3))
    np.testing.assert_allclose(as_np(bn._mean), 0.19 * mean, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(as_np(bn._variance), 0.81 + 0.19 * var,
                               rtol=1e-5, atol=1e-6)
    bn.eval()
    want = (X4 - as_np(bn._mean)[None, :, None, None]) / np.sqrt(
        as_np(bn._variance)[None, :, None, None] + 1e-5)
    np.testing.assert_allclose(as_np(bn(x)), want, rtol=1e-4, atol=1e-5)


def test_sync_batch_norm_converts_a_model():
    m = tnn.Sequential(tnn.Conv2D(6, 6, 1), tnn.BatchNorm2D(6))
    old = m[1]
    old(paddle.to_tensor(X4))
    conv = tnn.SyncBatchNorm.convert_sync_batchnorm(m)
    assert isinstance(conv[1], tnn.SyncBatchNorm) and conv[0] is m[0]
    for name in ("weight", "bias", "_mean", "_variance"):
        assert torch.equal(getattr(conv[1], name), getattr(old, name))
    x = paddle.to_tensor(X4)
    assert torch.equal(conv[1](x), old(x))


def test_spectral_norm_layer_raises_as_the_reference():
    for mod in (jnn, tnn):
        with pytest.raises(NotImplementedError, match="SpectralNorm"):
            mod.SpectralNorm([4, 4])


# ----------------------------------------------------------------- common
COMMON_LAYERS = [
    ("Upsample", (), {"scale_factor": 2}, X4),
    ("Upsample", (), {"size": (5, 7), "mode": "bilinear"}, X4),
    ("Upsample", (), {"size": (13, 17), "mode": "bilinear"}, X4),
    ("Upsample", (), {"size": (11, 6), "mode": "bicubic"}, X4),
    ("Upsample", (), {"scale_factor": 1.5, "mode": "nearest",
                      "align_corners": True}, X4),
    ("Upsample", (), {"size": (5, 5), "mode": "area"}, X4),
    ("Upsample", (), {"size": (4, 6), "mode": "bilinear",
                      "data_format": "NHWC"},
     X4.transpose(0, 2, 3, 1).copy()),
    ("Upsample", (), {"size": 7, "mode": "linear", "data_format": "NCW"},
     X3),
    ("Upsample", (), {"size": (3, 4, 5), "mode": "trilinear"}, X5),
    ("UpsamplingNearest2D", (), {"scale_factor": 2}, X4),
    ("UpsamplingBilinear2D", (), {"size": (12, 7)}, X4),
    ("PixelShuffle", (2,), {}, R.randn(2, 8, 3, 4).astype(np.float32)),
    ("PixelUnshuffle", (2,), {}, X4),
    ("PixelUnshuffle", (2,), {"data_format": "NHWC"},
     X4.transpose(0, 2, 3, 1).copy()),
    ("ChannelShuffle", (3,), {}, X4),
    ("ChannelShuffle", (2,), {"data_format": "NHWC"},
     X4.transpose(0, 2, 3, 1).copy()),
    ("Pad1D", ((1, 2),), {"mode": "reflect"}, X3),
    ("Pad2D", ((1, 2, 0, 3),), {"value": 0.5}, X4),
    ("Pad2D", (2,), {"mode": "replicate"}, X4),
    ("Pad3D", ((1, 0, 2, 1, 0, 1),), {}, X5),
    ("ZeroPad2D", ((1, 2, 3, 0),), {}, X4),
    ("Unfold", ((3, 2),), {"strides": 2, "paddings": 1, "dilations": 1},
     X4),
    ("Fold", ((6, 7), 2), {"strides": 1},
     R.randn(2, 12, 30).astype(np.float32)),
    ("Maxout", (2,), {}, X4),
    ("Maxout", (3,), {"axis": -1}, R.randn(2, 4, 6).astype(np.float32)),
    ("Softmax2D", (), {}, X4),
    ("Dropout2D", (0.0,), {}, X4),
]


@pytest.mark.parametrize("case", COMMON_LAYERS,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(COMMON_LAYERS)])
def test_common_layer(case):
    name, args, kw, x = case
    jl, tl = _pair(lambda: getattr(jnn, name)(*args, **kw),
                   lambda: getattr(tnn, name)(*args, **kw))
    _forward_backward(jl, tl, x)


def test_two_input_layers():
    a = R.randn(4, 5).astype(np.float32)
    b = R.randn(4, 3).astype(np.float32)
    jl, tl = _pair(lambda: jnn.Bilinear(5, 3, 2), lambda: tnn.Bilinear(5, 3,
                                                                       2))
    assert list(tl.state_dict()) == list(jl.state_dict())
    for v, w in zip(tl.state_dict().values(), _jstate(jl).values()):
        np.testing.assert_array_equal(as_np(v), w)
    _forward_backward(jl, tl, a, b)
    c = R.randn(4, 5).astype(np.float32)
    for mk in (lambda m: m.CosineSimilarity(axis=1),
               lambda m: m.PairwiseDistance(p=3.0, keepdim=True)):
        jl, tl = _pair(lambda: mk(jnn), lambda: mk(tnn))
        _forward_backward(jl, tl, a, c)


@pytest.mark.parametrize("name,args,x", [
    ("Dropout2D", (0.4,), X4), ("Dropout3D", (0.4,), X5),
    ("AlphaDropout", (0.3,), X4), ("FeatureAlphaDropout", (0.3,), X4),
])
def test_dropout_layers_draw_the_reference_masks(name, args, x):
    jl, tl = _pair(lambda: getattr(jnn, name)(*args),
                   lambda: getattr(tnn, name)(*args))
    P.seed(9)
    jo = np.asarray(jl(P.to_tensor(x)).value)
    paddle.seed(9)
    to = as_np(tl(paddle.to_tensor(x)))
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-6)
    tl.eval()
    np.testing.assert_array_equal(as_np(tl(paddle.to_tensor(x))), x)


@pytest.mark.parametrize("kw", [{"p": 2, "axis": 1}, {"p": 1, "axis": -1},
                                {"p": 3.0, "axis": 2}])
def test_normalize(kw):
    check(JF.normalize, TF.normalize, [("grad", X4)], kw)


@pytest.mark.parametrize("kw", [
    {"size": (4, 4), "mode": "bilinear"},
    {"size": (3, 13), "mode": "bilinear"},
    {"scale_factor": 0.5, "mode": "nearest"},
    {"size": (9, 9), "mode": "bilinear", "align_corners": True},
    {"size": (6, 14), "mode": "bicubic"},
    {"size": (3, 3), "mode": "area"},
], ids=["down", "mixed", "nearest-half", "align", "bicubic", "area"])
def test_interpolate(kw):
    check(JF.interpolate, TF.interpolate, [("grad", X4)], kw)


# ------------------------------------------------------------------ utils
def _linear_pair(seed=3):
    return _pair(lambda: jnn.Linear(4, 5), lambda: tnn.Linear(4, 5), seed)


def test_parameters_to_vector_and_back():
    jl, tl = _linear_pair()
    jv = np.asarray(jnn.utils.parameters_to_vector(jl.parameters()).value)
    tv = tnn.utils.parameters_to_vector(tl.parameters())
    np.testing.assert_array_equal(as_np(tv), jv)
    tnn.utils.vector_to_parameters(tv * 2, tl.parameters())
    np.testing.assert_array_equal(as_np(tl.weight), 2 * _jstate(jl)["weight"])


def test_clip_grad_value_():
    jl, tl = _linear_pair()
    x = R.randn(3, 4).astype(np.float32) * 5
    (jl(P.to_tensor(x)) ** 2).sum().backward()
    (tl(paddle.to_tensor(x)) ** 2).sum().backward()
    jnn.utils.clip_grad_value_(jl.parameters(), 0.5)
    tnn.utils.clip_grad_value_(tl.parameters(), 0.5)
    for (n, p), q in zip(tl.named_parameters(), jl.parameters()):
        np.testing.assert_allclose(as_np(p.grad), np.asarray(q.grad.value),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_and_its_removal(dim):
    jl, tl = _linear_pair()
    jnn.utils.weight_norm(jl, dim=dim)
    tnn.utils.weight_norm(tl, dim=dim)
    assert list(tl.state_dict()) == list(jl.state_dict())
    for v, w in zip(tl.state_dict().values(), _jstate(jl).values()):
        np.testing.assert_allclose(as_np(v), w, rtol=1e-6, atol=1e-7)
    _forward_backward(jl, tl, R.randn(3, 4).astype(np.float32))
    w_before = as_np(tl(paddle.to_tensor(np.eye(4, dtype=np.float32))))
    tnn.utils.remove_weight_norm(tl)
    assert list(tl.state_dict()) == ["bias", "weight"]
    np.testing.assert_allclose(
        as_np(tl(paddle.to_tensor(np.eye(4, dtype=np.float32)))), w_before,
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dim,iters", [(0, 1), (1, 3)])
def test_spectral_norm(dim, iters):
    jl, tl = _linear_pair()
    jnn.utils.spectral_norm(jl, n_power_iterations=iters, dim=dim)
    tnn.utils.spectral_norm(tl, n_power_iterations=iters, dim=dim)
    assert list(tl.state_dict()) == list(jl.state_dict())
    _forward_backward(jl, tl, R.randn(3, 4).astype(np.float32))
    # the persistent u advances each forward
    x = R.randn(3, 4).astype(np.float32)
    assert _rel(tl(paddle.to_tensor(x)), jl(P.to_tensor(x))) <= FWD_TOL
