"""The port's vision model zoo against the JAX package's on the CPU:
LeNet, AlexNet, VGG, SqueezeNet and MobileNet V1/V2 here; MobileNetV3
and ShuffleNetV2 (``test_torch_vision_models_more.py``), DenseNet
(``..._dense.py``), GoogLeNet and InceptionV3 (``..._inception.py``) by
these checks.

- Every constructor of ``paddle_tpu/vision/models/__init__.py``: the
  state dict's keys and order equal the reference's, and after the same
  ``paddle.seed`` the initial weights (and BatchNorm constants) are equal
  bit for bit. The VGG depths past 11 and the ``batch_norm`` variants are
  held in feature mode (``num_classes=0``, no pool): their classifier is
  VGG-11's, held with it, and drawing its 120 M weights once a depth
  costs the suite about a minute.
- One depth a family, batch 2 at 64 x 64 (LeNet 28 x 28, InceptionV3
  75 x 75), 10 classes, in training mode (BatchNorm on batch statistics;
  dropout layers put in eval mode on both sides, since the two draw their
  masks from different key walks) with the reference's weights carried,
  both sides in float64 (the reference under ``jax.enable_x64``), at
  limits set a few times over the readings: the cross-entropy loss within
  one float32 ulp (both sides cast the logits to float32; read: equal),
  every gradient within ``GRAD_TOL`` of its largest magnitude (read:
  <= 1.0e-7; InceptionV3 ``..._inception.py``'s own limit), the
  BatchNorm buffers after the forward within ``BUF_TOL`` (read: <= 6e-10).
  The reference's step is one jitted program over its functional state
  (``jit.functional.bind``): op by op its eager tape compiles every op
  anew (minutes a model).
- The float32 step the port runs, against the reference's float64 step
  (LeNet; ShuffleNetV2 x0.25 at batch 8, BatchNorm on 8 rows): loss
  1e-5 relative, gradients 1e-4 of their max, buffers 1e-5 (read: 9e-7,
  2.8e-5, 2.2e-6). Not against the reference's float32 step: on a
  BatchNorm network the two float32 steps part by 15 % of a gradient's
  max (MobileNetV1, batch 2) and 11 % (MobileNetV2, batch 16).
- ``zoo_parity_readings.py`` prints every reading quoted here.
- Feature mode (``num_classes=0``, ``with_pool=False``) returns the
  reference's features (eval mode, float64, ``FEAT_TOL`` of their max;
  read: <= 3e-14); ``pretrained=True`` raises (the weights are files
  from outside the repository).
"""
import copy

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch.vision import models as tmodels
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401

LOSS_RTOL = 2 ** -23
GRAD_TOL = 3e-7
BUF_TOL = 2e-9
FEAT_TOL = 1e-12
#: a gradient under this share of the model's largest is zero in exact
#: arithmetic (a BatchNorm's bias that feeds a convolution and another
#: BatchNorm, whose mean subtraction cancels it) and is held at that
#: floor
ZERO_GRAD = 1e-6
#: the port's float32 step against the reference's float64 one
F32_LOSS_RTOL, F32_GRAD_TOL, F32_BUF_TOL = 1e-5, 1e-4, 1e-5
#: in float32 a gradient under this share of the model's largest is
#: rounding noise (ShuffleNetV2's cancelled BatchNorm biases) and is held
#: at that floor
F32_ZERO_GRAD = 1e-2
CLASSES = 10

#: every constructor of this file: (test id, function name, keywords)
CONSTRUCTORS = [
    ("LeNet", "LeNet", {}),
    ("alexnet", "alexnet", {}),
    ("vgg11", "vgg11", {}),
    ("vgg13_features", "vgg13", {"num_classes": 0, "with_pool": False}),
    ("vgg16_features", "vgg16", {"num_classes": 0, "with_pool": False}),
    ("vgg19_features", "vgg19", {"num_classes": 0, "with_pool": False}),
    ("vgg11_bn_features", "vgg11", {"batch_norm": True, "num_classes": 0,
                                    "with_pool": False}),
    ("vgg16_bn_features", "vgg16", {"batch_norm": True, "num_classes": 0,
                                    "with_pool": False}),
    ("squeezenet1_0", "squeezenet1_0", {}),
    ("squeezenet1_1", "squeezenet1_1", {}),
    ("SqueezeNet", "SqueezeNet", {"version": "1.1"}),
    ("mobilenet_v1", "mobilenet_v1", {}),
    ("mobilenet_v1_x0_5", "mobilenet_v1", {"scale": 0.5}),
    ("MobileNetV1", "MobileNetV1", {}),
    ("mobilenet_v2", "mobilenet_v2", {}),
    ("MobileNetV2", "MobileNetV2", {}),
]
#: one depth a family in training mode: (test id, function, keywords,
#: input side)
TRAIN = [
    ("LeNet", "LeNet", {}, 28),
    ("alexnet", "alexnet", {}, 64),
    ("vgg11", "vgg11", {}, 64),
    ("squeezenet1_1", "squeezenet1_1", {}, 64),
    ("mobilenet_v1", "mobilenet_v1", {}, 64),
    ("mobilenet_v2", "mobilenet_v2", {}, 64),
]
FEATURES = [("mobilenet_v2", 64), ("squeezenet1_1", 64)]
PRETRAINED = ["alexnet", "vgg11", "vgg19", "squeezenet1_0", "squeezenet1_1",
              "mobilenet_v1", "mobilenet_v2"]

_CACHE, _PORTS = {}, {}


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


def _kw(fn, kw):
    """The constructor's keywords with 10 classes where it takes them."""
    out = dict(kw)
    out.setdefault("num_classes", CLASSES)
    return out


def _jstate(m):
    return {k: np.asarray(v.value) for k, v in m.state_dict().items()}


def _reference(fn, kw, seed=7):
    """The JAX model ``fn(**kw)`` built after ``P.seed(seed)`` and its
    seeded state; cached a module."""
    key = (fn, tuple(sorted(kw.items())), seed)
    if key not in _CACHE:
        P.seed(seed)
        jm = getattr(jmodels, fn)(**_kw(fn, kw))
        _CACHE[key] = (jm, _jstate(jm))
    return _CACHE[key]


def _port(fn, kw, seed=7):
    paddle.seed(seed)
    return getattr(tmodels, fn)(**_kw(fn, kw))


def _port_seeded(fn, kw):
    """The port's model after ``paddle.seed(7)``, built once a module
    (the seeded draws cost seconds at VGG's and AlexNet's widths); the
    checks take copies."""
    key = (fn, tuple(sorted(kw.items())))
    if key not in _PORTS:
        _PORTS[key] = _port(fn, kw)
    return _PORTS[key]


def check_seeded_weights(fn, kw):
    """Keys, order and seeded weights bit for bit."""
    _, want = _reference(fn, kw)
    tm = _port_seeded(fn, kw)
    sd = tm.state_dict()
    assert list(sd) == list(want)
    for k, v in sd.items():
        np.testing.assert_array_equal(as_np(v), want[k], err_msg=k)


def _batch(side, channels, seed=0, n=2):
    r = np.random.RandomState(seed)
    return (r.randn(n, channels, side, side).astype(np.float32),
            r.randint(0, CLASSES, n).astype(np.int64))


def _dropout_off(model, dropout_cls):
    for layer in model.sublayers():
        if isinstance(layer, dropout_cls):
            layer.eval()


def _outputs(out):
    return list(out) if isinstance(out, tuple) else [out]


def _jax_step(jm, x, y, wide=True):
    """The reference's training-mode step in float64 (``jax.enable_x64``;
    its cross entropy keeps its float32 cast), or in float32 with
    ``wide`` off: the loss (the sum of the cross entropies of every
    output head), gradients and BatchNorm buffers after the forward,
    from one jitted program over its functional state."""
    import jax.numpy as jnp
    from paddle_tpu.autograd.engine import no_grad
    from paddle_tpu.core.tensor import Tensor as JT
    from paddle_tpu.jit.functional import bind, split_state
    jm.train()
    _dropout_off(jm, P.nn.Dropout)
    params, buffers = split_state(jm)

    def f(p, b, xv, yv):
        with no_grad():
            with bind(jm, p, b) as collect:
                outs = _outputs(jm(JT(xv)))
                loss = sum(P.nn.functional.cross_entropy(o, JT(yv)).value
                           for o in outs)
                new_b = collect()
        return loss, new_b

    dt = jnp.float64 if wide else jnp.float32

    def cast(tree):
        return {k: jnp.asarray(np.asarray(v), dt) for k, v in tree.items()}

    with jax.enable_x64(wide):
        (loss, new_b), grads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(cast(params), cast(buffers),
                              jnp.asarray(x, dt), jnp.asarray(y))
        return float(loss), {k: np.asarray(v) for k, v in grads.items()}, \
            {k: np.asarray(v) for k, v in new_b.items()}


def _port_step(fn, kw, state, x, y, dtype):
    """The port's training-mode step in ``dtype`` from ``state``: loss,
    gradients, the state dict after the forward."""
    tm = copy.deepcopy(_port_seeded(fn, kw))
    assert tm.set_state_dict(state) == ([], [])
    tm.to(dtype=dtype)
    tm.train()
    _dropout_off(tm, paddle.nn.Dropout)
    outs = _outputs(tm(paddle.to_tensor(x).to(dtype)))
    loss = sum(paddle.nn.functional.cross_entropy(o, paddle.to_tensor(y))
               for o in outs)
    loss.backward()
    grads = {n: as_np(p.grad) for n, p in tm.named_parameters()}
    return loss.item(), grads, tm.state_dict()


def step_errors(fn, kw, side, n, dtype, zero, wide=True):
    """The port's training-mode step in ``dtype`` on ``n`` images against
    the reference's (in float64, or in float32 with ``wide`` off), the
    reference's weights carried: the loss's relative error, each
    gradient's largest error over its largest entry (at least ``zero``
    of the model's largest), each BN buffer's after the forward over its
    largest entry (at least 1)."""
    jm, state = _reference(fn, kw)
    channels = 1 if fn in ("LeNet", "lenet") else 3
    x, y = _batch(side, channels, n=n)
    loss_want, grads, bufs = _jax_step(jm, x, y, wide)
    loss, got, sd = _port_step(fn, kw, state, x, y, dtype)
    assert set(got) == set(grads)
    top = max(np.max(np.abs(g)) for g in grads.values())
    grad_errs = {name: np.max(np.abs(got[name] - g))
                 / max(np.max(np.abs(g)), zero * top)
                 for name, g in grads.items()}
    buf_errs = {k: np.max(np.abs(as_np(sd[k]) - want))
                / max(np.max(np.abs(want)), 1.0) for k, want in bufs.items()}
    return abs(loss - loss_want) / abs(loss_want), grad_errs, buf_errs


def _check_step(fn, kw, side, n, dtype, loss_rtol, grad_tol, buf_tol,
                zero):
    """``step_errors`` against the reference's float64 step, held at
    ``loss_rtol``, ``grad_tol`` and ``buf_tol``."""
    loss, grads, bufs = step_errors(fn, kw, side, n, dtype, zero)
    assert loss <= loss_rtol
    assert not {k: e for k, e in grads.items() if e > grad_tol}, grads
    assert not {k: e for k, e in bufs.items() if e > buf_tol}, bufs


def check_train_step(fn, kw, side, grad_tol=GRAD_TOL):
    """Training mode with the reference's weights, both in float64: loss,
    gradients, BN buffers after the forward."""
    _check_step(fn, kw, side, 2, torch.float64, LOSS_RTOL, grad_tol,
                BUF_TOL, ZERO_GRAD)


def feature_error(fn, kw, side):
    """``num_classes=0, with_pool=False``: the port's features against
    the reference's in eval mode, the reference's weights carried, both
    in float64; the largest error over the largest feature."""
    import jax.numpy as jnp
    from paddle_tpu.autograd.engine import no_grad
    from paddle_tpu.core.tensor import Tensor as JT
    from paddle_tpu.jit.functional import bind, split_state
    kw = dict(kw, num_classes=0, with_pool=False)
    jm, state = _reference(fn, kw)
    jm.eval()
    x, _ = _batch(side, 3, seed=3)
    params, buffers = split_state(jm)

    def f(p, b, xv):
        with no_grad():
            with bind(jm, p, b):
                return jm(JT(xv)).value

    with jax.enable_x64(True):
        want = np.asarray(jax.jit(f)(
            *({k: jnp.asarray(np.asarray(v), jnp.float64)
               for k, v in t.items()} for t in (params, buffers)),
            jnp.asarray(x, jnp.float64)))
    tm = _port(fn, kw, seed=99)
    tm.set_state_dict(state)
    tm.to(dtype=torch.float64)
    tm.eval()
    with torch.no_grad():
        got = as_np(tm(paddle.to_tensor(x).double()))
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def check_feature_mode(fn, kw, side):
    assert feature_error(fn, kw, side) <= FEAT_TOL


@pytest.mark.parametrize("fn,kw", [c[1:] for c in CONSTRUCTORS],
                         ids=[c[0] for c in CONSTRUCTORS])
def test_state_dict_keys_and_seeded_weights_bit_for_bit(fn, kw):
    check_seeded_weights(fn, kw)


@pytest.mark.parametrize("fn,kw,side", [t[1:] for t in TRAIN],
                         ids=[t[0] for t in TRAIN])
def test_train_step_loss_gradients_and_buffers_match(fn, kw, side):
    check_train_step(fn, kw, side)


@pytest.mark.parametrize("fn,side,n", [("LeNet", 28, 2),
                                       ("shufflenet_v2_x0_25", 64, 8)])
def test_float32_train_step_matches_float64_reference(fn, side, n):
    _check_step(fn, {}, side, n, torch.float32, F32_LOSS_RTOL, F32_GRAD_TOL,
                F32_BUF_TOL, F32_ZERO_GRAD)


@pytest.mark.parametrize("fn", [f for f, _ in FEATURES])
def test_feature_mode_matches_reference(fn):
    check_feature_mode(fn, {}, dict(FEATURES)[fn])


@pytest.mark.parametrize("fn", PRETRAINED)
def test_pretrained_raises(fn):
    with pytest.raises(NotImplementedError, match="pretrained"):
        getattr(tmodels, fn)(pretrained=True)
