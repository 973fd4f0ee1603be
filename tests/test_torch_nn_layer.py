"""The port's ``nn.Layer`` and layers, initializers, clips, autograd,
dtype and device surface against the JAX package's, on the CPU.

Layers are built after the same ``seed`` on both sides: weights drawn by
the uniform initializers (Xavier-uniform, the default, included) are the
JAX package's bit for bit, the normal-based ones within 1e-5 relative
(``torch.erfinv`` and XLA's differ in the last place). Each layer then
takes the JAX layer's weights through ``set_state_dict`` (numpy arrays,
the JAX keys) and its output and gradients on the same numpy input are
held to 1e-5 and 1e-4 of the reference's largest magnitude. The
``Layer`` surface (parameter order, state-dict keys and order,
``apply``'s order, hooks, containers, ``to``) is compared name by name.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
NORMAL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


def _rel(g, w):
    g, w = as_np(g).astype(np.float64), as_np(w).astype(np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.max(np.abs(g - w), initial=0.0)) / max(
        float(np.max(np.abs(w), initial=0.0)), 1e-30)


def _pair(make_j, make_t, seed=0):
    P.seed(seed)
    jl = make_j()
    paddle.seed(seed)
    tl = make_t()
    return jl, tl


def _jstate(layer):
    return {k: np.asarray(v.value) for k, v in layer.state_dict().items()}


def _forward_backward(jl, tl, *arrays, train=True):
    """Forward and gradients (input and parameters) of both layers on the
    same inputs; the port's layer first takes the JAX weights."""
    missing, unexpected = tl.set_state_dict(_jstate(jl))
    assert not missing and not unexpected
    for m in (jl, tl):
        m.train() if train else m.eval()
    jx = [P.to_tensor(a, stop_gradient=not np.issubdtype(a.dtype,
                                                         np.floating))
          for a in arrays]
    tx = [paddle.to_tensor(a, stop_gradient=not np.issubdtype(a.dtype,
                                                              np.floating))
          for a in arrays]
    jo, to = jl(*jx), tl(*tx)
    assert _rel(to, jo) <= FWD_TOL
    cot = np.asarray(np.random.RandomState(3).randn(*tuple(to.shape)),
                     np.float32)
    (jo * P.to_tensor(cot)).sum().backward()
    (to * paddle.to_tensor(cot)).sum().backward()
    for j, t in zip(jx, tx):
        if t.requires_grad:
            assert _rel(t.grad, j.grad) <= GRAD_TOL
    jp = dict(jl.named_parameters())
    for name, p in tl.named_parameters():
        assert _rel(p.grad, jp[name].grad) <= GRAD_TOL, name


R = np.random.RandomState(0)
X = R.randn(3, 5, 8).astype(np.float32)


# ------------------------------------------------------------- initializers
UNIFORM_INITS = [("Uniform", (-0.3, 0.7)), ("XavierUniform", ()),
                 ("KaimingUniform", ()), ("Constant", (0.25,)),
                 ("Dirac", ()), ("Bilinear", ())]
NORMAL_INITS = [("Normal", (0.1, 2.0)), ("TruncatedNormal", (0.0, 0.5)),
                ("XavierNormal", ()), ("KaimingNormal", ()),
                ("Orthogonal", (1.5,))]


@pytest.mark.parametrize("name,args", UNIFORM_INITS + NORMAL_INITS,
                         ids=[n for n, _ in UNIFORM_INITS + NORMAL_INITS])
def test_initializer(name, args):
    shape = [4, 3, 3, 3] if name in ("Dirac", "Bilinear") else [6, 10]
    P.seed(2)
    want = np.asarray(getattr(jnn.initializer, name)(*args)(shape,
                                                           "float32"))
    paddle.seed(2)
    got = as_np(getattr(tnn.initializer, name)(*args)(shape, "float32"))
    if (name, args) in UNIFORM_INITS:
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) <= NORMAL_TOL


def test_assign_initializer_and_globals():
    v = R.randn(2, 3).astype(np.float32)
    np.testing.assert_array_equal(
        as_np(tnn.initializer.Assign(v)([3, 2], "float32")),
        np.asarray(jnn.initializer.Assign(v)([3, 2], "float32")))
    for nl in ("relu", "leaky_relu", "tanh", "selu", "linear"):
        assert tnn.initializer.calculate_gain(nl) == \
            jnn.initializer.calculate_gain(nl)
    tnn.initializer.set_global_initializer(tnn.initializer.Constant(0.5),
                                           tnn.initializer.Constant(0.1))
    try:
        lin = tnn.Linear(2, 3)
        assert torch.all(lin.weight == 0.5) and torch.all(lin.bias == 0.1)
    finally:
        tnn.initializer.set_global_initializer(None, None)


def test_xavier_uniform_default_weights_bit_for_bit():
    jl, tl = _pair(lambda: jnn.Linear(16, 24), lambda: tnn.Linear(16, 24),
                   seed=9)
    for k, v in _jstate(jl).items():
        np.testing.assert_array_equal(as_np(tl.state_dict()[k]), v)


# ------------------------------------------------------------------ layers
LAYERS = [
    ("Linear", (8, 6), X),
    ("Linear", (8, 6), X, {"bias_attr": False}),
    ("LayerNorm", (8,), X),
    ("LayerNorm", ([5, 8],), X, {"epsilon": 1e-3}),
    ("RMSNorm", (8,), X),
    ("BatchNorm1D", (5,), X),
    ("BatchNorm2D", (3,), R.randn(2, 3, 4, 5).astype(np.float32)),
    ("BatchNorm3D", (3,), R.randn(2, 3, 2, 2, 3).astype(np.float32)),
    ("BatchNorm", (5,), X),
    ("Identity", (), X), ("Flatten", (), X),
    ("Dropout", (0.0,), X), ("PReLU", (5, 0.2), X),
] + [(n, (), X) for n in (
    "ReLU", "ReLU6", "Sigmoid", "Tanh", "Silu", "Swish", "Mish", "Hardswish",
    "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink", "Tanhshrink",
    "Softsign", "Softplus", "LeakyReLU", "ELU", "SELU", "CELU", "GELU",
    "Softmax", "LogSoftmax", "GLU", "RReLU", "ThresholdedReLU",
    "LogSigmoid")]


@pytest.mark.parametrize("case", LAYERS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LAYERS)])
def test_layer(case):
    name, args, x = case[:3]
    kw = case[3] if len(case) > 3 else {}
    jl, tl = _pair(lambda: getattr(jnn, name)(*args, **kw),
                   lambda: getattr(tnn, name)(*args, **kw))
    assert list(tl.state_dict()) == list(jl.state_dict())
    # RReLU draws in training: compare its deterministic eval form
    _forward_backward(jl, tl, x, train=name != "RReLU")
    if name.startswith("BatchNorm"):
        jb = {n: b for n, b in jl.named_buffers()}
        for n, b in tl.named_buffers():
            assert _rel(b, jb[n]) <= FWD_TOL, n


def test_embedding_and_padding_row():
    jl, tl = _pair(lambda: jnn.Embedding(11, 6, padding_idx=3),
                   lambda: tnn.Embedding(11, 6, padding_idx=3), seed=4)
    assert _rel(tl.weight, jl.weight) <= NORMAL_TOL
    assert torch.all(tl.weight[3] == 0)
    ids = R.randint(0, 11, (2, 7))
    tl.set_state_dict(_jstate(jl))
    jo, to = jl(P.to_tensor(ids)), tl(paddle.to_tensor(ids))
    assert _rel(to, jo) <= FWD_TOL
    to.sum().backward()
    assert torch.all(tl.weight.grad[3] == 0)


def test_dropout_layer_masks_match():
    jl, tl = _pair(lambda: jnn.Dropout(0.3), lambda: tnn.Dropout(0.3))
    P.seed(6)
    jo = jl(P.to_tensor(X))
    paddle.seed(6)
    to = tl(paddle.to_tensor(X))
    np.testing.assert_array_equal(as_np(to) != 0, as_np(jo) != 0)
    tl.eval()
    assert tl(paddle.to_tensor(X)) is not None and not tl.training


LOSS_LAYERS = [("CrossEntropyLoss", {}), ("NLLLoss", {}),
               ("MSELoss", {}), ("L1Loss", {}), ("SmoothL1Loss", {}),
               ("BCELoss", {}), ("BCEWithLogitsLoss", {}), ("KLDivLoss", {})]


@pytest.mark.parametrize("name,kw", LOSS_LAYERS,
                         ids=[n for n, _ in LOSS_LAYERS])
def test_loss_layer(name, kw):
    logits = R.randn(6, 5).astype(np.float32)
    if name in ("CrossEntropyLoss", "NLLLoss"):
        label = np.array([0, 3, -100, 4, 1, 2])
        x = logits
    elif name == "BCELoss":
        x, label = 1 / (1 + np.exp(-logits)), (logits > 0).astype(
            np.float32)
    elif name == "KLDivLoss":
        x, label = logits, np.abs(R.randn(6, 5)).astype(np.float32)
    else:
        x, label = logits, R.randn(6, 5).astype(np.float32)
    jl, tl = getattr(jnn, name)(**kw), getattr(tnn, name)(**kw)
    jx, tx = P.to_tensor(x, stop_gradient=False), paddle.to_tensor(
        x, stop_gradient=False)
    jo = jl(jx, P.to_tensor(label))
    to = tl(tx, paddle.to_tensor(label))
    assert _rel(to, jo) <= FWD_TOL
    jo.backward()
    to.backward()
    assert _rel(tx.grad, jx.grad) <= GRAD_TOL


# ------------------------------------------------------------ the surface
class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(4, 3, weight_attr=jnn.ParamAttr(
            name="fc_w", learning_rate=0.5,
            initializer=jnn.initializer.Uniform(-0.6, 0.6)))
        self.seq = jnn.Sequential(jnn.Linear(3, 3), jnn.ReLU(),
                                  jnn.LayerNorm(3))
        self.blocks = jnn.LayerList([jnn.Linear(3, 2), jnn.Linear(2, 2)])
        self.extra = jnn.ParameterList([self.create_parameter([2])])
        self.register_buffer("kept", P.to_tensor(np.ones(2, np.float32)))
        self.register_buffer("scratch", P.to_tensor(np.zeros(2, np.float32)),
                             persistable=False)

    def forward(self, x):
        x = self.seq(self.fc(x))
        for b in self.blocks:
            x = b(x)
        return x + self.extra[0]


class _TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(4, 3, weight_attr=paddle.framework.ParamAttr(
            name="fc_w", learning_rate=0.5,
            initializer=tnn.initializer.Uniform(-0.6, 0.6)))
        self.seq = tnn.Sequential(tnn.Linear(3, 3), tnn.ReLU(),
                                  tnn.LayerNorm(3))
        self.blocks = tnn.LayerList([tnn.Linear(3, 2), tnn.Linear(2, 2)])
        self.extra = tnn.ParameterList([self.create_parameter([2])])
        self.register_buffer("kept", paddle.to_tensor(np.ones(2,
                                                              np.float32)))
        self.register_buffer("scratch",
                             paddle.to_tensor(np.zeros(2, np.float32)),
                             persistable=False)

    def forward(self, x):
        x = self.seq(self.fc(x))
        for b in self.blocks:
            x = b(x)
        return x + self.extra[0]


def test_layer_surface_matches_reference():
    jm, tm = _pair(_JNet, _TNet, seed=5)
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert "scratch" not in tm.state_dict()
    assert [n for n, _ in tm.named_buffers()] == \
        [n for n, _ in jm.named_buffers()]
    assert [type(m).__name__ for m in tm.sublayers()] == \
        [type(m).__name__ for m in jm.sublayers()]
    seen_t, seen_j = [], []
    tm.apply(lambda m: seen_t.append(type(m).__name__.lstrip("_TJ")))
    jm.apply(lambda m: seen_j.append(type(m).__name__.lstrip("_TJ")))
    assert seen_t == seen_j and seen_t[0] == "Net"
    p = tm.fc.weight
    assert p.name == "fc_w" and p.optimize_attr == {"learning_rate": 0.5}
    np.testing.assert_array_equal(as_np(p), as_np(jm.fc.weight))
    assert p.trainable and not p.stop_gradient
    _forward_backward(jm, tm, R.randn(5, 4).astype(np.float32))
    assert len(tm.seq) == 3 and isinstance(tm.seq[1], tnn.ReLU)
    assert len(tm.blocks) == 2 and len(tm.extra) == 1


def test_set_state_dict_reports_and_checks():
    tm = _TNet()
    state = {k: as_np(v) for k, v in tm.state_dict().items()}
    state.pop("fc.bias")
    state["nope"] = np.zeros(1)
    missing, unexpected = tm.set_state_dict(state)
    assert missing == ["fc.bias"] and unexpected == ["nope"]
    bad = dict(state, **{"fc.weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tm.load_dict(bad)
    assert tm.set_dict is not None


def test_train_eval_hooks_and_dtype():
    tm = _TNet()
    tm.eval()
    assert not any(m.training for m in tm.sublayers(include_self=True))
    tm.train()
    assert all(m.training for m in tm.sublayers(include_self=True))
    seen = []
    h1 = tm.register_forward_pre_hook(lambda m, i: seen.append("pre"))
    h2 = tm.register_forward_post_hook(
        lambda m, i, o: seen.append("post") or o * 2)
    x = paddle.to_tensor(R.randn(2, 4).astype(np.float32))
    doubled = tm(x)
    h1.remove()
    h2.remove()
    plain = tm(x)
    assert seen == ["pre", "post"] and torch.allclose(doubled, 2 * plain)
    tm.to(dtype="bfloat16")
    assert tm.fc.weight.dtype == torch.bfloat16 and \
        isinstance(tm.fc.weight, paddle.Parameter)
    tm.astype("float32")
    assert tm.fc.weight.dtype == torch.float32 and tm.fc.weight.name == \
        "fc_w"
    tm.to("cpu")
    assert tm.fc.weight.device.type == "cpu"


def test_param_attr_trainable_and_regularizer():
    reg = paddle.regularizer.L2Decay(0.1)
    layer = tnn.Linear(3, 3, weight_attr=paddle.framework.ParamAttr(
        trainable=False, regularizer=reg))
    assert not layer.weight.trainable and layer.weight.stop_gradient
    assert layer.weight.regularizer is reg
    assert [n for n, p in layer.named_parameters()] == ["weight", "bias"]


# ------------------------------------------------------------------ clips
CLIPS = [("ClipGradByValue", (0.3,)), ("ClipGradByValue", (0.5, -0.1)),
         ("ClipGradByNorm", (0.7,)), ("ClipGradByGlobalNorm", (0.9,))]


@pytest.mark.parametrize("name,args", CLIPS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CLIPS)])
def test_clip(name, args):
    gs = [R.randn(4, 3).astype(np.float32), R.randn(5).astype(np.float32)]
    want = getattr(jnn, name)(*args)([(None, P.to_tensor(g)) for g in gs])
    got = getattr(tnn, name)(*args)([(None, paddle.to_tensor(g))
                                     for g in gs])
    for (_, a), (_, b) in zip(got, want):
        assert _rel(a, b) <= FWD_TOL


def test_clip_grad_norm_():
    gs = [R.randn(4, 3).astype(np.float32), R.randn(5).astype(np.float32)]
    jp = [P.to_tensor(np.zeros_like(g)) for g in gs]
    tp = [paddle.to_tensor(np.zeros_like(g)) for g in gs]
    for p, g in zip(jp, gs):
        p.grad = P.to_tensor(g)
    for p, g in zip(tp, gs):
        p.grad = paddle.to_tensor(g)
    jt = jnn.clip_grad_norm_(jp, 1.5)
    tt = tnn.clip_grad_norm_(tp, 1.5)
    assert _rel(tt, jt) <= FWD_TOL
    for a, b in zip(tp, jp):
        assert _rel(a.grad, b.grad) <= FWD_TOL


# ------------------------------------------------- autograd, dtype, device
def test_pylayer_and_grad():
    class JCube(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            return x * x * x * k

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * 3 * x * x

    class TCube(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            return x * x * x * k

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * 3 * x * x

    v = R.randn(5).astype(np.float32)
    jx = P.to_tensor(v, stop_gradient=False)
    tx = paddle.to_tensor(v, stop_gradient=False)
    JCube.apply(jx, 2.0).sum().backward()
    TCube.apply(tx, 2.0).sum().backward()
    assert _rel(tx.grad, jx.grad) <= FWD_TOL
    (jg,) = P.grad((jx * jx).sum(), [jx])
    (tg,) = paddle.grad((tx * tx).sum(), [tx])
    assert _rel(tg, jg) <= FWD_TOL and tx.grad is not None
    other = paddle.to_tensor(v, stop_gradient=False)
    with pytest.raises(ValueError, match="unreachable"):
        paddle.grad((tx * 2).sum(), [other])
    assert paddle.grad((tx * 2).sum(), [other], allow_unused=True) == [None]
    with paddle.no_grad():
        assert not (tx * 2).requires_grad
    assert paddle.is_grad_enabled()


def test_dtype_surface():
    for name in ("float32", "bf16", "half", "int64", "bool", "float64"):
        got = paddle.core.dtype.dtype_name(name)
        want = P.core.dtype.dtype_name(P.core.dtype.to_jax_dtype(name)) \
            if name not in ("int64", "float64") else name
        assert got == want
    assert paddle.promote_types("bfloat16", "float32") == torch.float32
    assert paddle.finfo("bfloat16").eps == float(P.finfo("bfloat16").eps)
    assert paddle.iinfo("int32").max == int(P.iinfo("int32").max)
    prev = paddle.get_default_dtype()
    paddle.set_default_dtype("float64")
    try:
        assert paddle.to_tensor([1.5]).dtype == torch.float64
    finally:
        paddle.set_default_dtype(prev)
    with pytest.raises(TypeError):
        paddle.set_default_dtype("int32")
    assert paddle.to_tensor([1.5, 2]).dtype == torch.float32
    assert paddle.to_tensor([1, 2]).dtype == torch.int64


def test_device_has_no_fallback():
    """The default is gpu:0; without CUDA a creation call not asked for
    the CPU raises instead of carrying on there."""
    assert str(paddle.get_device()) == "cpu"
    paddle.set_device("gpu:0")
    try:
        assert str(paddle.get_device()) == "gpu:0"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                paddle.zeros([2])
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tnn.Linear(2, 2)
        assert paddle.to_tensor([1.0], place="cpu").device.type == "cpu"
    finally:
        paddle.set_device("cpu")
    assert paddle.is_compiled_with_cuda() == (torch.version.cuda
                                             is not None)
    assert paddle.device_count() == (torch.cuda.device_count()
                                     if torch.cuda.is_available() else 0)
    assert paddle.Tensor is torch.Tensor
    assert paddle.core.device.Place("gpu:1").torch_device == \
        torch.device("cuda", 1)
