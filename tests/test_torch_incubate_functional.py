"""The port's ``incubate.nn.functional`` against the JAX package's, on the
CPU: every function, at small shapes. The same numpy inputs go through
both; outputs within 1e-5 of the reference's largest magnitude, the float
inputs' gradients (of ``sum(out * c)``) within 1e-4.

Dropout (``fused_bias_dropout_residual_layer_norm``,
``fused_dropout_add``, the attention and feed-forward blocks) runs at
p = 0.5 after one ``seed`` on both sides: one mask element apart would
move an output by O(1), far past the bound, and ``fused_dropout_add``'s
zeros are compared exactly; after each call the two key walks are in the
same place. The flash entries and ``swiglu`` are ``nn.functional``'s own
functions (one implementation), held to the JAX incubate functions.
``masked_multihead_attention`` writes the caller's cache in place and
returns it: the returned cache equals the JAX op's returned cache. The
raises are kept.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu.core import random as jrandom
from paddle_tpu_torch.core import random as trandom
from test_torch_nn_layer import _rel
from test_torch_ops import as_np
from test_torch_rnn import _flat
from torch_threads import one_torch_thread  # noqa: F401

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
JF = P.incubate.nn.functional
TF = paddle.incubate.nn.functional
B, S, H, D = 2, 6, 4, 8
E = H * D


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run(call, floats, seed=None, grad=True):
    """``call(lib, F, *tensors)`` on both sides (``lib`` the package,
    ``F`` its incubate functional) on the ``floats`` arrays; outputs (a
    tuple's non-None entries) within FWD_TOL, the inputs' gradients
    within GRAD_TOL. ``seed`` is set on both sides just before the call;
    the key walks must end in step. Returns the port's outputs."""
    j = [P.to_tensor(a, stop_gradient=not grad) for a in floats]
    t = [paddle.to_tensor(a, stop_gradient=not grad) for a in floats]
    if seed is not None:
        P.seed(seed)
    jo = [o for o in _flat(call(P, JF, *j)) if o is not None]
    if seed is not None:
        paddle.seed(seed)
    to = [o for o in _flat(call(paddle, TF, *t)) if o is not None]
    if seed is not None:
        np.testing.assert_array_equal(
            np.asarray(jrandom.next_key()),
            trandom.next_key().numpy().astype(np.uint32))
    assert len(jo) == len(to)
    for a, b in zip(to, jo):
        assert tuple(a.shape) == tuple(b.shape)
        assert _rel(a, b) <= FWD_TOL
    if grad:
        jl = tl = 0
        for i, (a, b) in enumerate(zip(to, jo)):
            c = _r(100 + i, *tuple(b.shape))
            jl = (b * P.to_tensor(c)).sum() + jl
            tl = (a * paddle.to_tensor(c)).sum() + tl
        jl.backward()
        tl.backward()
        for a, b in zip(t, j):
            assert (a.grad is None) == (b.grad is None)
            if a.grad is not None:
                assert _rel(a.grad, b.grad) <= GRAD_TOL
    return to


# ------------------------------------------------------------------ RoPE
@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("n_in", [1, 2, 3])
def test_rope_built_tables(neox, n_in):
    arrays = [_r(i, B, S, H, D) for i in range(n_in)]
    out = _run(lambda lib, F, *x: F.fused_rotary_position_embedding(
        *x, use_neox_rotary_style=neox), arrays)
    assert len(out) == n_in
    got = TF.fused_rotary_position_embedding(
        *[paddle.to_tensor(a) for a in arrays],
        use_neox_rotary_style=neox)
    assert len(got) == 3 and all(g is None for g in got[n_in:])


@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("tables", ["2d", "4d", "position_ids"])
def test_rope_given_tables(neox, tables):
    ang = np.random.RandomState(3).rand(S, D).astype(np.float32) * 3
    sin, cos = np.sin(ang), np.cos(ang)
    if tables == "4d":
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    pid = np.array([[5, 4, 3, 2, 1, 0], [0, 2, 4, 1, 3, 5]])

    def call(lib, F, q, k):
        kw = {}
        if tables == "position_ids":
            kw["position_ids"] = lib.to_tensor(pid)
        return F.fused_rotary_position_embedding(
            q, k, sin=lib.to_tensor(sin), cos=lib.to_tensor(cos),
            use_neox_rotary_style=neox, **kw)
    _run(call, [_r(1, B, S, H, D), _r(2, B, S, H, D)])


# ------------------------------------------------ the fused epilogue
@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_bias_dropout_residual_layer_norm(training, with_bias):
    arrays = [_r(1, B, S, E), _r(2, B, S, E), _r(3, E) + 1, _r(4, E)]
    if with_bias:
        arrays.append(_r(5, E))

    def call(lib, F, x, res, scale, shift, *bias):
        return F.fused_bias_dropout_residual_layer_norm(
            x, res, bias[0] if bias else None, scale, shift,
            dropout_rate=0.5, ln_epsilon=1e-5, training=training)
    _run(call, arrays, seed=7)


def test_norms():
    x, w, b = _r(1, B, S, E), _r(2, E) + 1, _r(3, E)
    _run(lambda lib, F, x, w, b: F.fused_rms_norm(x, w, b, 1e-6), [x, w, b])
    _run(lambda lib, F, x, w: F.fused_rms_norm(x, w, None, 1e-6), [x, w])
    _run(lambda lib, F, x, w, b: F.fused_layer_norm(x, w, b, 1e-5, 2),
         [x, w, b])
    w2, b2 = _r(4, S, E) + 1, _r(5, S, E)
    _run(lambda lib, F, x, w, b: F.fused_layer_norm(x, w, b, 1e-5, 1),
         [x, w2, b2])


# ---------------------------------------------------------- linears
@pytest.mark.parametrize("transpose", [False, True])
def test_linears(transpose):
    x, b = _r(1, B, S, E), _r(2, 24)
    w = _r(3, 24, E) if transpose else _r(3, E, 24)
    _run(lambda lib, F, x, w, b: F.fused_linear(x, w, b, transpose),
         [x, w, b])
    _run(lambda lib, F, x, w: F.fused_linear(x, w, None, transpose), [x, w])
    _run(lambda lib, F, x, w, b: F.fused_matmul_bias(
        x, w, b, transpose_y=transpose), [x, w, b])
    _run(lambda lib, F, x, w: F.fused_matmul_bias(
        x, w, transpose_y=transpose), [x, w])
    for act in ("gelu", "relu"):
        _run(lambda lib, F, x, w, b: F.fused_linear_activation(
            x, w, b, trans_y=transpose, activation=act), [x, w, b])
    xt = _r(4, E, 5)
    _run(lambda lib, F, x, w, b: F.fused_matmul_bias(
        x, w, b, transpose_x=True, transpose_y=transpose),
         [xt, w, b])


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_add(training, mode):
    x, y = _r(1, B, S, E), _r(2, B, S, E)
    out = _run(lambda lib, F, x, y: F.fused_dropout_add(
        x, y, p=0.5, training=training, mode=mode), [x, y], seed=9)
    P.seed(9)
    want = as_np(JF.fused_dropout_add(P.to_tensor(x), P.to_tensor(y),
                                      p=0.5, training=training, mode=mode))
    np.testing.assert_array_equal(as_np(out[0]) == y, want == y)


def test_swiglu_is_one_implementation():
    assert TF.swiglu is paddle.nn.functional.swiglu
    x, y = _r(1, B, S, E), _r(2, B, S, E)
    _run(lambda lib, F, x, y: F.swiglu(x, y), [x, y])
    _run(lambda lib, F, x: F.swiglu(x), [x])


# --------------------------------------------------------- attention
def test_flash_entries_are_one_implementation():
    for name in ("flash_attention", "flash_attn_qkvpacked",
                 "flash_attn_unpadded"):
        assert getattr(TF, name) is getattr(paddle.nn.functional, name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention(causal):
    q, k, v = (_r(i, B, 16, H, D) for i in range(3))
    _run(lambda lib, F, q, k, v: F.flash_attention(q, k, v, causal=causal),
         [q, k, v])
    qkv = _r(4, B, 16, 3, H, D)
    _run(lambda lib, F, x: F.flash_attn_qkvpacked(x, causal=causal), [qkv])


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_unpadded(causal):
    cu = np.array([0, 5, 12, 16], np.int32)
    q, k, v = (_r(i, 16, H, D) for i in range(3))
    _run(lambda lib, F, q, k, v: F.flash_attn_unpadded(
        q, k, v, lib.to_tensor(cu), lib.to_tensor(cu), 7, 7,
        causal=causal), [q, k, v])


def _pad_mask():
    lens = np.array([S, 4])
    return np.where(np.arange(S)[None, :] < lens[:, None], 0.0, -1e9) \
        .astype(np.float32)[:, None, None, :]


@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_fused_multi_head_attention(pre_ln, training):
    arrays = [_r(1, B, S, E), _r(2, 3, H, D, E) * 0.3, _r(3, E, E) * 0.3,
              _r(4, E) + 1, _r(5, E), _r(6, E) + 1, _r(7, E),
              _r(8, 3, H, D), _r(9, E)]
    mask = _pad_mask()

    def call(lib, F, x, qkvw, lw, pls, plb, ls, lb, qkvb, linb):
        return F.fused_multi_head_attention(
            x, qkvw, lw, pre_layer_norm=pre_ln, pre_ln_scale=pls,
            pre_ln_bias=plb, ln_scale=ls, ln_bias=lb, qkv_bias=qkvb,
            linear_bias=linb, attn_mask=lib.to_tensor(mask),
            dropout_rate=0.5, attn_dropout_rate=0.5, training=training)
    _run(call, arrays, seed=11)


def test_fused_multi_head_attention_cache_raises():
    x = paddle.to_tensor(_r(1, B, S, E))
    with pytest.raises(NotImplementedError, match="cache_kv"):
        TF.fused_multi_head_attention(x, x, x, cache_kv=x)


@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_fused_feedforward(pre_ln, activation):
    arrays = [_r(1, B, S, E), _r(2, E, 48) * 0.3, _r(3, 48, E) * 0.3,
              _r(4, 48), _r(5, E), _r(6, E) + 1, _r(7, E), _r(8, E) + 1,
              _r(9, E)]

    def call(lib, F, x, w1, w2, b1, b2, s1, c1, s2, c2):
        return F.fused_feedforward(
            x, w1, w2, b1, b2, s1, c1, s2, c2, dropout1_rate=0.5,
            dropout2_rate=0.5, activation=activation, pre_layer_norm=pre_ln,
            training=True)
    _run(call, arrays, seed=13)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lens_2d", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_variable_length_attention(causal, lens_2d, with_mask):
    q, k, v = (_r(i, B, H, S, D) for i in range(3))
    qlen, klen = np.array([S, 3]), np.array([S, 4])
    if lens_2d:
        qlen, klen = qlen[:, None], klen[:, None]
    mask = _r(4, B, 1, S, S) if with_mask else None

    def call(lib, F, q, k, v):
        return F.variable_length_memory_efficient_attention(
            q, k, v, lib.to_tensor(qlen), lib.to_tensor(klen),
            mask=None if mask is None else lib.to_tensor(mask),
            scale=0.3 if with_mask else None, causal=causal)
    out = _run(call, [q, k, v])
    assert not as_np(out[0])[1, :, 3:].any()     # padded query rows


def _mmha_inputs(seed, S_max=10):
    r = np.random.RandomState(seed)
    x = r.randn(B, 3 * H * D).astype(np.float32)
    cache = r.randn(2, B, H, S_max, D).astype(np.float32)
    return x, cache, np.array([3, 7])


@pytest.mark.parametrize("lens_2d", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_masked_multihead_attention(lens_2d, with_mask):
    x, cache, lens = _mmha_inputs(1)
    if lens_2d:
        lens = lens[:, None]
    mask = _r(2, B, 1, 1, 10) if with_mask else None
    jx = P.to_tensor(x, stop_gradient=False)
    tx = paddle.to_tensor(x, stop_gradient=False)
    tc = paddle.to_tensor(cache)
    jo, jc = JF.masked_multihead_attention(
        jx, P.to_tensor(cache), src_mask=None if mask is None
        else P.to_tensor(mask), sequence_lengths=P.to_tensor(lens))
    to, rc = TF.masked_multihead_attention(
        tx, tc, src_mask=None if mask is None else paddle.to_tensor(mask),
        sequence_lengths=paddle.to_tensor(lens))
    # the caller's cache, written in place, is the one returned
    assert rc is tc
    np.testing.assert_array_equal(as_np(rc), as_np(jc))
    assert not np.array_equal(as_np(rc), cache)
    assert _rel(to, jo) <= FWD_TOL
    c = _r(3, *tuple(jo.shape))
    (jo * P.to_tensor(c)).sum().backward()
    (to * paddle.to_tensor(c)).sum().backward()
    assert _rel(tx.grad, jx.grad) <= GRAD_TOL


def test_masked_multihead_attention_steps():
    """Three decode steps into one cache, row lengths apart: the cache
    and outputs track the JAX op's step by step."""
    x0, cache, lens = _mmha_inputs(2)
    jc, tc = P.to_tensor(cache), paddle.to_tensor(cache)
    for step in range(3):
        x = _r(10 + step, B, 3 * H * D)
        jo, jc = JF.masked_multihead_attention(
            P.to_tensor(x), jc, sequence_lengths=P.to_tensor(lens + step))
        to, tc = TF.masked_multihead_attention(
            paddle.to_tensor(x), tc,
            sequence_lengths=paddle.to_tensor(lens + step))
        np.testing.assert_array_equal(as_np(tc), as_np(jc))
        assert _rel(to, jo) <= FWD_TOL


def test_masked_multihead_attention_raises():
    x, cache, lens = (paddle.to_tensor(a) for a in _mmha_inputs(3))
    with pytest.raises(NotImplementedError, match="out_scale"):
        TF.masked_multihead_attention(x, cache, sequence_lengths=lens,
                                      out_scale=1.0)
    with pytest.raises(ValueError, match="sequence_lengths"):
        TF.masked_multihead_attention(x, cache)
    with pytest.raises(NotImplementedError, match="rotary"):
        TF.masked_multihead_attention(x, cache, sequence_lengths=lens,
                                      rotary_emb_dims=1)
