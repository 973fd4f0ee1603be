"""The port's ``nn.functional`` against the JAX package's, on the CPU:
every ported function — activations, ``linear``, ``embedding``, dropout,
the norms, the losses, ``scaled_dot_product_attention`` and
``flash_attention`` (causal and not, GQA, ``Sq != Sk``, the dropout
route) — on the same numpy inputs (from a seed). Forward outputs agree to
1e-5 of the reference's largest magnitude, gradients (of the sum of the
outputs against a seeded cotangent, through each side's autograd) to
1e-4 of each gradient's largest magnitude. Random masks are drawn after
the same ``seed``: dropout outputs, and so their masks, are held to the
same bound, and the masks themselves compared bit for bit. On the CPU
the JAX ``flash_attention`` is its ``_ref_attention`` (no Pallas kernel
runs off a TPU) and the port's runs the flash kernels' plain versions;
the kernels themselves are held to the plain versions on a card by
``tests/test_torch_substrate_on_card.py`` and ``chip_smoke.py``'s
``substrate`` phase.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.core.tensor import Tensor as JTensor
import paddle_tpu_torch as paddle
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as TF
from test_torch_ops import as_np, leaves
from torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


def _rel_err(g, w):
    g, w = as_np(g).astype(np.float64), as_np(w).astype(np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.max(np.abs(g - w), initial=0.0)) / max(
        float(np.max(np.abs(w), initial=0.0)), 1e-30)


def _inputs(spec):
    """numpy inputs from a spec: arrays, or ("grad", array) for an input
    whose gradient is compared."""
    return [(a[1], True) if isinstance(a, tuple) and len(a) == 2
            and a[0] == "grad" else (a, False) for a in spec]


def _diff(ins):
    return [i for i, (_, g) in enumerate(ins) if g]


def _torch_side(fn_t, ins, kwargs, seed):
    tx = [paddle.to_tensor(a, stop_gradient=not g)
          if isinstance(a, np.ndarray) else a for a, g in ins]
    if seed is not None:
        paddle.seed(seed)
    outs = [o for o in leaves(fn_t(*tx, **kwargs)) if o is not None]
    floats = [o for o in outs if o.is_floating_point()]
    r = np.random.RandomState(7)
    cots = [np.asarray(r.randn(*o.shape), np.float32) for o in floats]
    grads = []
    if _diff(ins):
        loss = sum((o * paddle.to_tensor(c)).sum()
                   for o, c in zip(floats, cots))
        loss.backward()
        grads = [tx[i].grad for i in _diff(ins)]
    return outs, cots, grads


def _jax_tape(fn_j, ins, kwargs, seed, cots):
    """The JAX eager tape (random draws from the global key walk)."""
    jx = [P.to_tensor(a, stop_gradient=not g) if isinstance(a, np.ndarray)
          else a for a, g in ins]
    if seed is not None:
        P.seed(seed)
    outs = [o for o in leaves(fn_j(*jx, **kwargs)) if o is not None]
    grads = []
    if _diff(ins):
        floats = [o for o in outs
                  if np.issubdtype(np.dtype(o.dtype), np.floating)]
        loss = None
        for o, c in zip(floats, cots):
            t = (o * P.to_tensor(c)).sum()
            loss = t if loss is None else loss + t
        loss.backward()
        grads = [jx[i].grad for i in _diff(ins)]
    return outs, grads


def _jax_jit(fn_j, ins, kwargs, cots):
    """The same JAX function as one jitted program and its jitted VJP
    (op by op, the tape compiles every op anew)."""
    idx = _diff(ins)

    def pure(*d):
        vals = [a for a, _ in ins]
        for i, x in zip(idx, d):
            vals[i] = x
        args = [JTensor(jnp.asarray(v)) if isinstance(v, (np.ndarray,
                                                          jax.Array))
                else v for v in vals]
        with P.no_grad():
            out = fn_j(*args, **kwargs)
        return [o.value for o in leaves(out) if o is not None]

    diffs = [ins[i][0] for i in idx]
    outs = jax.jit(pure)(*diffs)
    grads = []
    if idx:
        def floats(*d):
            return [o for o in pure(*d) if jnp.issubdtype(o.dtype,
                                                          jnp.floating)]
        n = len(diffs)
        grads = jax.jit(lambda *a: jax.vjp(floats, *a[:n])[1](
            list(a[n:])))(*diffs, *cots)
    return outs, grads


def check(fn_j, fn_t, spec, kwargs=None, seed=None, tape=False):
    """Forward and gradients of ``fn_t`` against ``fn_j``. A seeded call
    (random draws) or ``tape`` (the JAX function mutates state) runs the
    JAX tape; the rest runs the JAX function jitted."""
    kwargs = kwargs or {}
    ins = _inputs(spec)
    tl, cots, tg = _torch_side(fn_t, ins, kwargs, seed)
    if seed is not None or tape:
        jl, jg = _jax_tape(fn_j, ins, kwargs, seed, cots)
    else:
        jl, jg = _jax_jit(fn_j, ins, kwargs, cots)
    assert len(jl) == len(tl)
    for g, w in zip(tl, jl):
        assert _rel_err(g, w) <= FWD_TOL
        assert str(g.dtype).split(".")[-1] == np.dtype(w.dtype).name
    for g, w in zip(tg, jg):
        assert _rel_err(g, w) <= GRAD_TOL


R = np.random.RandomState(0)
X = R.randn(4, 6).astype(np.float32)
X4 = R.randn(2, 3, 4, 5).astype(np.float32)
G = ("grad", X)
ACTS = [("relu", {}), ("relu6", {}), ("gelu", {}),
        ("gelu", {"approximate": True}), ("sigmoid", {}), ("silu", {}),
        ("swish", {}), ("tanh", {}), ("softplus", {"beta": 2.0}),
        ("softsign", {}), ("leaky_relu", {"negative_slope": 0.1}),
        ("elu", {"alpha": 0.7}), ("selu", {}), ("celu", {"alpha": 1.3}),
        ("hardswish", {}), ("hardsigmoid", {}), ("hardtanh", {}),
        ("hardshrink", {}), ("softshrink", {}), ("tanhshrink", {}),
        ("mish", {}), ("glu", {}), ("softmax", {"axis": 0}),
        ("log_softmax", {}), ("thresholded_relu", {"threshold": 0.3}),
        ("log_sigmoid", {}), ("rrelu", {"training": False})]


@pytest.mark.parametrize("name,kw", ACTS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(ACTS)])
def test_activation(name, kw):
    check(getattr(JF, name), getattr(TF, name), [G], kw)


def test_rrelu_training_draw():
    check(JF.rrelu, TF.rrelu, [G], {"training": True}, seed=4)


def test_prelu():
    w = R.rand(3).astype(np.float32)
    check(JF.prelu, TF.prelu, [("grad", X4), ("grad", w)])


def test_swiglu():
    check(JIF.swiglu, TF.swiglu, [G, ("grad", R.randn(4, 6)
                                      .astype(np.float32))])
    check(JIF.swiglu, TF.swiglu, [G])


def test_linear_and_embedding():
    w = R.randn(6, 5).astype(np.float32)
    b = R.randn(5).astype(np.float32)
    check(JF.linear, TF.linear, [G, ("grad", w), ("grad", b)])
    check(JF.linear, TF.linear, [G, ("grad", w)])
    ids = R.randint(0, 7, (3, 5))
    emb = R.randn(7, 4).astype(np.float32)
    check(JF.embedding, TF.embedding, [ids, ("grad", emb)],
          {"padding_idx": 2})


def test_one_hot():
    check(JF.one_hot, TF.one_hot, [R.randint(0, 5, (3, 4))],
          {"num_classes": 5})


@pytest.mark.parametrize("fn,kw", [
    ("dropout", {"p": 0.3}), ("dropout", {"p": 0.3, "axis": 1}),
    ("dropout", {"p": 0.5, "mode": "downscale_in_infer"}),
    ("dropout", {"p": 0.5, "training": False,
                 "mode": "downscale_in_infer"}),
    ("dropout2d", {"p": 0.4}), ("dropout3d", {"p": 0.4})])
def test_dropout(fn, kw):
    x = ("grad", R.randn(2, 3, 4, 5, 2).astype(np.float32)) \
        if fn == "dropout3d" else ("grad", X4)
    check(getattr(JF, fn), getattr(TF, fn), [x], kw, seed=11)


def test_dropout_mask_bits():
    """The mask of one dropout call, from the same seed, bit for bit."""
    ones = np.ones((8, 16, 33), np.float32)
    P.seed(5)
    jm = as_np(JF.dropout(P.to_tensor(ones), p=0.1)) != 0
    paddle.seed(5)
    tm = as_np(TF.dropout(paddle.to_tensor(ones), p=0.1)) != 0
    np.testing.assert_array_equal(tm, jm)
    assert 0.85 < tm.mean() < 0.95


def test_norms():
    w = R.rand(6).astype(np.float32) + 0.5
    b = R.randn(6).astype(np.float32)
    check(JF.layer_norm, TF.layer_norm, [G, 6, ("grad", w), ("grad", b)])
    check(JF.layer_norm, TF.layer_norm, [("grad", X4), [4, 5]])
    check(JF.rms_norm, TF.rms_norm, [G, ("grad", w)])


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm(training):
    x = R.randn(4, 3, 5).astype(np.float32)
    mean, var = R.randn(3).astype(np.float32), R.rand(3).astype(np.float32)
    w, b = R.rand(3).astype(np.float32), R.randn(3).astype(np.float32)
    jm, jv = P.to_tensor(mean), P.to_tensor(var)
    tm, tv = paddle.to_tensor(mean), paddle.to_tensor(var)
    check(lambda x, w, b: JF.batch_norm(x, jm, jv, w, b, training=training),
          lambda x, w, b: TF.batch_norm(x, tm, tv, w, b, training=training),
          [("grad", x), ("grad", w), ("grad", b)], tape=True)
    assert _rel_err(tm, jm) <= FWD_TOL and _rel_err(tv, jv) <= FWD_TOL


LOGITS = R.randn(6, 5).astype(np.float32)
LABEL = np.array([0, 3, -100, 4, 1, 2])
SOFT = np.abs(R.randn(6, 5)).astype(np.float32)
SOFT /= SOFT.sum(-1, keepdims=True)
CW = R.rand(5).astype(np.float32) + 0.5
LOSSES = [
    ("cross_entropy", [("grad", LOGITS), LABEL], {}),
    ("cross_entropy", [("grad", LOGITS), LABEL], {"weight": None,
                                                  "reduction": "sum"}),
    ("cross_entropy", [("grad", LOGITS), LABEL[:, None]],
     {"reduction": "none"}),
    ("cross_entropy", [("grad", LOGITS), np.where(LABEL < 0, 1, LABEL)],
     {"label_smoothing": 0.1}),
    ("cross_entropy", [("grad", LOGITS), SOFT], {"soft_label": True}),
    ("nll_loss", [("grad", LOGITS), LABEL], {}),
    ("mse_loss", [("grad", X), X[::-1].copy()], {}),
    ("l1_loss", [("grad", X), X[::-1].copy()], {"reduction": "sum"}),
    ("smooth_l1_loss", [("grad", X), X[::-1].copy()], {"delta": 0.5}),
    ("binary_cross_entropy", [("grad", SOFT), (SOFT > 0.2)
                              .astype(np.float32)], {}),
    ("binary_cross_entropy_with_logits", [("grad", LOGITS),
                                          (SOFT > 0.2).astype(np.float32)],
     {"pos_weight": None}),
    ("kl_div", [("grad", np.log(SOFT)), SOFT[::-1].copy()], {}),
    ("softmax_with_cross_entropy", [("grad", LOGITS), LABEL[:, None]], {}),
]


@pytest.mark.parametrize("name,spec,kw", LOSSES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(LOSSES)])
def test_loss(name, spec, kw):
    check(getattr(JF, name), getattr(TF, name), spec, kw)


def test_loss_class_weights():
    wj, wt = P.to_tensor(CW), paddle.to_tensor(CW)
    check(lambda x, y: JF.cross_entropy(x, y, weight=wj),
          lambda x, y: TF.cross_entropy(x, y, weight=wt),
          [("grad", LOGITS), LABEL])
    check(lambda x, y: JF.nll_loss(x, y, weight=wj),
          lambda x, y: TF.nll_loss(x, y, weight=wt),
          [("grad", LOGITS), LABEL])
    pw = np.full(5, 2.0, np.float32)
    check(lambda x, y: JF.binary_cross_entropy_with_logits(
        x, y, pos_weight=P.to_tensor(pw)),
        lambda x, y: TF.binary_cross_entropy_with_logits(
            x, y, pos_weight=paddle.to_tensor(pw)),
        [("grad", LOGITS), (SOFT > 0.2).astype(np.float32)])


def _qkv(B, Sq, Sk, H, Hk, D, seed):
    r = np.random.RandomState(seed)
    return [("grad", r.randn(B, s, h, D).astype(np.float32))
            for s, h in ((Sq, H), (Sk, Hk), (Sk, Hk))]


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa(causal):
    spec = _qkv(2, 9, 9, 3, 3, 8, 1)
    check(JF.scaled_dot_product_attention, TF.scaled_dot_product_attention,
          spec, {"is_causal": causal})
    mask = R.rand(9, 9) > 0.3
    np.fill_diagonal(mask, True)
    check(lambda q, k, v: JF.scaled_dot_product_attention(
        q, k, v, attn_mask=P.to_tensor(mask)),
        lambda q, k, v: TF.scaled_dot_product_attention(
            q, k, v, attn_mask=paddle.to_tensor(mask)), spec)
    add = R.randn(9, 9).astype(np.float32)
    check(lambda q, k, v: JF.scaled_dot_product_attention(
        q, k, v, attn_mask=P.to_tensor(add), is_causal=causal),
        lambda q, k, v: TF.scaled_dot_product_attention(
            q, k, v, attn_mask=paddle.to_tensor(add), is_causal=causal),
        spec)
    check(JF.scaled_dot_product_attention, TF.scaled_dot_product_attention,
          spec, {"is_causal": causal, "dropout_p": 0.2}, seed=9)


FLASH = [("mha", (2, 33, 33, 4, 4, 16)), ("gqa", (2, 40, 40, 4, 2, 16)),
         ("sq_ne_sk", (2, 7, 20, 4, 4, 8)), ("mqa", (1, 64, 64, 4, 1, 32))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tag,shape", FLASH, ids=[t for t, _ in FLASH])
def test_flash_attention(tag, shape, causal):
    check(JF.flash_attention, TF.flash_attention, _qkv(*shape, seed=3),
          {"causal": causal})


def test_flash_attention_dropout_routes_to_sdpa():
    check(JF.flash_attention, TF.flash_attention,
          _qkv(2, 16, 16, 2, 2, 8, 5), {"causal": True, "dropout": 0.25},
          seed=13)


def test_flash_attn_qkvpacked():
    qkv = R.randn(2, 12, 3, 2, 8).astype(np.float32)
    check(JF.flash_attn_qkvpacked, TF.flash_attn_qkvpacked,
          [("grad", qkv)], {"causal": False})


def test_flash_attention_sq_ne_sk_launches_nothing():
    """``Sq != Sk`` takes the plain attention by a shape rule."""
    calls = []
    orig = TF._ref_attention
    try:
        TF._ref_attention = lambda *a: calls.append(a) or orig(*a)
        q = torch.randn(1, 3, 2, 8)
        k = torch.randn(1, 5, 2, 8)
        TF.flash_attention(q, k, k, causal=True)
    finally:
        TF._ref_attention = orig
    assert len(calls) == 1
