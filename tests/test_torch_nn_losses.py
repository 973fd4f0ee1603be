"""The rest of the port's ``nn.functional`` — the remaining losses, the
sequence, sampling and geometry functions, ``relu_`` and
``flash_attn_unpadded`` — and the loss layers against the JAX package's,
on the CPU, through ``test_torch_nn_functional.py``'s ``check``: the same
numpy inputs (from a seed), forward outputs within 1e-5 of the
reference's largest magnitude, gradients (of the outputs against a seeded
cotangent) within 1e-4 of each gradient's largest magnitude, in every
reduction mode. ``ctc_loss`` and ``rnnt_loss`` run the JAX package's
recursions (``rnnt_loss``'s FastEmit gradient included); random draws
(``gumbel_softmax``, ``class_center_sample``) follow one ``seed`` on
both sides. Integer outputs (``sequence_mask``, ``gather_tree``,
``class_center_sample``) are compared by value. ``flash_attn_unpadded``
is held at three packings, causal or not.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as TF
from test_torch_nn_functional import check
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


R = np.random.RandomState(1)
N, C = 6, 5
X = R.randn(N, C).astype(np.float32)
Y = R.randn(N, C).astype(np.float32)
Z = R.randn(N, C).astype(np.float32)
PROB = (R.rand(N, C) * 0.9 + 0.05).astype(np.float32)
BIN = (R.rand(N, C) > 0.5).astype(np.float32)
SIGN = np.where(R.rand(N) > 0.5, 1.0, -1.0).astype(np.float32)
SIGN2 = np.where(R.rand(N, C) > 0.5, 1.0, -1.0).astype(np.float32)
CLS = R.randint(0, C, (N,)).astype(np.int64)
COUNTS = R.poisson(2.0, (N, C)).astype(np.float32)
REDUCTIONS = ("mean", "sum", "none")


def g(a):
    return ("grad", a)


def _case(fn, spec, kw=None, **opts):
    return (fn, spec, kw or {}, opts)


def _reduced(fn, spec, kw=None, **opts):
    return [_case(fn, spec, dict(kw or {}, reduction=r), **opts)
            for r in REDUCTIONS]


CASES = [
    _case("square_error_cost", [g(X), Y]),
    _case("log_loss", [g(PROB), BIN]),
    *_reduced("soft_margin_loss", [g(X), SIGN2]),
    *_reduced("poisson_nll_loss", [g(X), COUNTS]),
    *_reduced("poisson_nll_loss", [g(PROB + 0.5), COUNTS],
              {"log_input": False, "full": True}),
    *_reduced("gaussian_nll_loss", [g(X), Y, g(PROB)]),
    _case("gaussian_nll_loss", [g(X), Y, g(PROB)], {"full": True}),
    *_reduced("cosine_embedding_loss", [g(X), g(Y), SIGN],
              {"margin": 0.2}),
    *_reduced("triplet_margin_loss", [g(X), g(Y), g(Z)]),
    _case("triplet_margin_loss", [g(X), g(Y), g(Z)],
          {"p": 1.0, "swap": True, "margin": 0.5}),
    *_reduced("triplet_margin_with_distance_loss", [g(X), g(Y), g(Z)],
              {"swap": True}),
    *_reduced("multi_label_soft_margin_loss", [g(X), BIN]),
    _case("multi_label_soft_margin_loss", [g(X), BIN, PROB[0]]),
    *_reduced("multi_margin_loss", [g(X), CLS]),
    _case("multi_margin_loss", [g(X), CLS, 2, 0.5, PROB[0]]),
    _case("dice_loss", [g(np.abs(R.rand(N, 4, C)).astype(np.float32)),
                        R.randint(0, C, (N, 4, 1))]),
    *_reduced("sigmoid_focal_loss", [g(X), BIN]),
    _case("sigmoid_focal_loss", [g(X), BIN, np.float32(3.0)],
          {"gamma": 1.5, "alpha": 0.4}),
    _case("npair_loss", [g(X), g(Y), np.array([0, 1, 2, 0, 1, 3])]),
    *_reduced("margin_ranking_loss", [g(X), g(Y), SIGN2], {"margin": 0.1}),
    *_reduced("hinge_embedding_loss", [g(X), SIGN2], {"margin": 0.5}),
    *_reduced("margin_cross_entropy", [g(np.tanh(X)), CLS]),
    _case("margin_cross_entropy", [g(np.tanh(X)), CLS[:, None]],
          {"return_softmax": True, "margin1": 0.9, "margin3": 0.1,
           "scale": 16.0}),
    _case("label_smooth", [g(np.eye(C, dtype=np.float32)[CLS])]),
    _case("label_smooth", [g(np.eye(C, dtype=np.float32)[CLS]),
                           PROB[:1] / PROB[:1].sum()], {"epsilon": 0.2}),
    _case("temporal_shift", [g(R.randn(6, 8, 2, 3).astype(np.float32)), 3]),
    _case("affine_grid", [g(R.randn(2, 2, 3).astype(np.float32)),
                          [2, 3, 4, 5]]),
    _case("affine_grid", [g(R.randn(2, 2, 3).astype(np.float32)),
                          [2, 3, 4, 5]], {"align_corners": False}),
]

T_CTC, B_CTC, C_CTC, L_CTC = 9, 3, 6, 4
CTC_LOGITS = R.randn(T_CTC, B_CTC, C_CTC).astype(np.float32)
CTC_LAB = R.randint(1, C_CTC - 1, (B_CTC, L_CTC))
CTC_LAB[1, 1] = CTC_LAB[1, 0]            # a repeat: no skip there
CTC_IN = np.array([9, 7, 8])
CTC_LEN = np.array([4, 2, 0])
CASES += [
    *_reduced("ctc_loss", [g(CTC_LOGITS), CTC_LAB, CTC_IN, CTC_LEN]),
    _case("ctc_loss", [g(CTC_LOGITS), CTC_LAB, CTC_IN, CTC_LEN],
          {"norm_by_times": True, "reduction": "sum"}),
    _case("ctc_loss", [g(CTC_LOGITS), np.where(CTC_LAB == C_CTC - 1, 0,
                                               CTC_LAB),
                       CTC_IN, CTC_LEN], {"blank": C_CTC - 1}),
]

B_RT, T_RT, U_RT, V_RT = 2, 5, 3, 4
RT_LOGITS = R.randn(B_RT, T_RT, U_RT + 1, V_RT).astype(np.float32)
RT_LAB = R.randint(1, V_RT, (B_RT, U_RT))
RT_IN = np.array([5, 3])
RT_LEN = np.array([3, 2])
CASES += [
    *_reduced("rnnt_loss", [g(RT_LOGITS), RT_LAB, RT_IN, RT_LEN]),
    _case("rnnt_loss", [g(RT_LOGITS), RT_LAB, RT_IN, RT_LEN],
          {"fastemit_lambda": 0.0, "blank": 0}),
    _case("rnnt_loss", [g(RT_LOGITS), np.where(RT_LAB == V_RT - 1, 1,
                                               RT_LAB), RT_IN, RT_LEN],
          {"fastemit_lambda": 0.01, "blank": V_RT - 1, "reduction": "sum"}),
]

B_SA, H_SA, S_SA, D_SA = 2, 2, 5, 4
SA_OFF = np.array([[[0, 2, 3, 3, 5, 7], [0, 1, 2, 4, 6, 8]],
                   [[0, 5, 5, 6, 8, 9], [0, 2, 4, 5, 7, 9]]], np.int32)
SA_COLS = np.array([[[0, 2, 1, 1, 4, 0, 3, 0, 0],
                     [0, 1, 0, 2, 3, 4, 1, 4, 0]],
                    [[0, 1, 2, 3, 4, 2, 0, 4, 1],
                     [0, 1, 1, 2, 3, 0, 4, 2, 3]]], np.int32)
SA_Q = [g(R.randn(B_SA, H_SA, S_SA, D_SA).astype(np.float32))
        for _ in range(3)]
CASES += [
    _case("sparse_attention", [*SA_Q, SA_OFF, SA_COLS]),
    _case("sparse_attention", [*SA_Q, SA_OFF, SA_COLS,
                               np.array([[1, 1, 1, 0, 1], [1, 1, 1, 1, 0]],
                                        np.float32),
                               np.tril(np.ones((S_SA, S_SA), np.float32))]),
]

GRID_X = R.randn(2, 3, 4, 5).astype(np.float32)
GRID = (R.rand(2, 3, 6, 2) * 2.4 - 1.2).astype(np.float32)
# nearest sampling: the grid's gradient is zero in the reference (a
# rounded index); only the input's is compared
CASES += [
    _case("grid_sample", [g(GRID_X), g(GRID) if m == "bilinear" else GRID],
          {"mode": m, "padding_mode": p, "align_corners": a})
    for m in ("bilinear", "nearest") for p in ("zeros", "border")
    for a in (True, False)
]


@pytest.mark.parametrize("name,spec,kw,opts", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_functional(name, spec, kw, opts):
    check(getattr(JF, name), getattr(TF, name), spec, kw, **opts)


def test_triplet_margin_with_a_distance_function():
    """Forward only: with a distance function the JAX package rebuilds
    the loss from its value (``_T(_reduce(l.value, ...))``), a tensor with
    no gradient; the port's keeps its graph."""
    def dist(a, b):
        return ((a - b) ** 2).sum(-1)
    for r in REDUCTIONS:
        check(JF.triplet_margin_with_distance_loss,
              TF.triplet_margin_with_distance_loss, [X, Y, Z],
              {"distance_function": dist, "margin": 0.3, "reduction": r},
              tape=True)


def _adaptive(F):
    def fn(x, label, head, w1a, w2a, w1b, w2b, head_bias=None):
        return F.adaptive_log_softmax_with_loss(
            x, label, head, [(w1a, w2a), (w1b, w2b)], [4, 7],
            head_bias=head_bias)
    return fn


def test_adaptive_log_softmax_with_loss():
    H = 6
    spec = [g(R.randn(8, H).astype(np.float32)),
            np.array([0, 3, 4, 6, 7, 11, 9, 2]),
            g(R.randn(H, 6).astype(np.float32)),
            g(R.randn(H, 3).astype(np.float32)),
            g(R.randn(3, 3).astype(np.float32)),
            g(R.randn(H, 2).astype(np.float32)),
            g(R.randn(2, 5).astype(np.float32))]
    check(_adaptive(JF), _adaptive(TF), spec)
    check(_adaptive(JF), _adaptive(TF),
          spec + [g(R.randn(6).astype(np.float32))])


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_draws_the_reference_noise(hard):
    check(JF.gumbel_softmax, TF.gumbel_softmax, [g(X)],
          {"temperature": 0.7, "hard": hard}, seed=5)


def test_sequence_mask_and_gather_tree_values():
    lengths = np.array([[3, 0], [5, 1]])
    for kw in ({}, {"maxlen": 6, "dtype": "float32"}):
        got = TF.sequence_mask(paddle.to_tensor(lengths), **kw)
        want = JF.sequence_mask(P.to_tensor(lengths), **kw)
        np.testing.assert_array_equal(as_np(got), as_np(want))
    ids = R.randint(0, 9, (5, 2, 3))
    parents = R.randint(0, 3, (5, 2, 3))
    got = TF.gather_tree(paddle.to_tensor(ids), paddle.to_tensor(parents))
    want = JF.gather_tree(P.to_tensor(ids), P.to_tensor(parents))
    np.testing.assert_array_equal(as_np(got), as_np(want))


def test_class_center_sample_follows_the_key_walk():
    label = np.array([3, 17, 3, 40, 8, 17])
    P.seed(9)
    want = JF.class_center_sample(P.to_tensor(label), 50, 12)
    paddle.seed(9)
    got = TF.class_center_sample(paddle.to_tensor(label), 50, 12)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(as_np(a), as_np(b))
    with pytest.raises(ValueError):
        TF.class_center_sample(paddle.to_tensor(label), 50, 2)


def test_relu_in_place():
    x = paddle.to_tensor(X)
    out = TF.relu_(x)
    jx = P.to_tensor(X)
    JF.relu_(jx)
    assert out is x
    np.testing.assert_array_equal(as_np(x), as_np(jx))


PACKINGS = [[0, 5, 12, 16], [0, 16], [0, 1, 2, 9, 10, 16]]


@pytest.mark.parametrize("cu", PACKINGS)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_unpadded(cu, causal):
    total, H, D = 16, 2, 8
    q, k, v = (R.randn(total, H, D).astype(np.float32) for _ in range(3))
    cu = np.array(cu, np.int32)
    m = int(np.max(np.diff(cu)))

    def fn(F):
        def f(q, k, v, cq, ck):
            return F.flash_attn_unpadded(q, k, v, cq, ck, m, m,
                                         causal=causal)[0]
        return f

    check(fn(JF), fn(TF), [g(q), g(k), g(v), cu, cu], tape=True)


LAYERS = [
    ("MarginRankingLoss", {"margin": 0.2}, [g(X), g(Y), SIGN2]),
    ("CTCLoss", {"blank": 0, "reduction": "sum"},
     [g(CTC_LOGITS), CTC_LAB, CTC_IN, CTC_LEN]),
    ("CosineEmbeddingLoss", {"margin": 0.1}, [g(X), g(Y), SIGN]),
    ("TripletMarginLoss", {"swap": True}, [g(X), g(Y), g(Z)]),
    ("TripletMarginWithDistanceLoss", {"margin": 0.7},
     [g(X), g(Y), g(Z)]),
    ("SoftMarginLoss", {"reduction": "sum"}, [g(X), SIGN2]),
    ("PoissonNLLLoss", {"full": True}, [g(X), COUNTS]),
    ("GaussianNLLLoss", {"full": True}, [g(X), Y, g(PROB)]),
    ("MultiLabelSoftMarginLoss", {"reduction": "none"}, [g(X), BIN]),
    ("MultiMarginLoss", {"p": 2, "margin": 0.5}, [g(X), CLS]),
    ("HingeEmbeddingLoss", {"margin": 0.3}, [g(X), SIGN2]),
]


@pytest.mark.parametrize("name,kw,spec", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_loss_layer(name, kw, spec):
    jl = getattr(P.nn, name)(**kw)
    tl = getattr(paddle.nn, name)(**kw)
    check(lambda *a: jl(*a), lambda *a: tl(*a), spec)
