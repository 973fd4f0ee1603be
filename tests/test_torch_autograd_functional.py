"""The port's ``autograd.functional`` (``jacobian``, ``hessian``, ``jvp``,
``vjp``, ``Jacobian``, ``Hessian``) against the JAX package's, on the
CPU: the same functions, written once over the op surface
(``paddle.matmul``, ``paddle.tanh`` …) and run by each side on the same
numpy inputs; every entry point with one input and several, and with
``batch_axis=0`` (``is_batched``), within 1e-6 of the reference's largest
magnitude. ``create_graph=True`` raises in both, and so does
``paddle.grad(create_graph=True)``.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu import autograd as JA
from paddle_tpu_torch import autograd as TA
from test_torch_ops import as_np, compare
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


R = np.random.RandomState(0)
X = R.randn(3).astype(np.float32)
Y = R.randn(3, 2).astype(np.float32)
W = R.randn(3, 4).astype(np.float32)
XB = R.randn(5, 3).astype(np.float32)
YB = R.randn(5, 3).astype(np.float32)


def f1(lib):
    w = lib.to_tensor(W)
    return lambda x: lib.tanh(lib.matmul(x, w)) * 2.0 + x.sum()


def f2(lib):
    return lambda x, y: lib.matmul(lib.sin(x), y) + lib.exp(y).sum()


def s1(lib):
    w = lib.to_tensor(W)
    return lambda x: (lib.tanh(lib.matmul(x, w)) ** 2).sum() + (x ** 3).sum()


def s2(lib):
    return lambda x, y: (lib.matmul(lib.sin(x), y) ** 2).sum() \
        + (x * x).sum() * (y * y).sum()


def sb(lib):
    return lambda x: (lib.sin(x) * x).sum()


def fb(lib):
    return lambda x, y: lib.tanh(x * y) + x


def _both(name, make, args, **kw):
    want = getattr(JA, name)(make(P), *[_t(P, a) for a in args], **kw)
    got = getattr(TA, name)(make(paddle), *[_t(paddle, a) for a in args],
                            **kw)
    return got, want


def _t(lib, a):
    if isinstance(a, tuple):
        return tuple(lib.to_tensor(v) for v in a)
    return lib.to_tensor(a)


@pytest.mark.parametrize("name,make,args,kw", [
    ("jacobian", f1, (X,), {}),
    ("jacobian", f2, ((X, Y),), {}),
    ("jacobian", fb, ((XB, YB),), {"batch_axis": 0}),
    ("hessian", s1, (X,), {}),
    ("hessian", s2, ((X, Y),), {}),
    ("hessian", sb, (XB,), {"batch_axis": 0}),
    ("jvp", f1, (X,), {}),
    ("jvp", f1, (X, R.randn(3).astype(np.float32)), {}),
    ("jvp", f2, ((X, Y), (R.randn(3).astype(np.float32),
                          R.randn(3, 2).astype(np.float32))), {}),
    ("vjp", f1, (X,), {}),
    ("vjp", f1, (X, R.randn(4).astype(np.float32)), {}),
    ("vjp", f2, ((X, Y), R.randn(2).astype(np.float32)), {}),
], ids=lambda v: getattr(v, "__name__", None))
def test_transform(name, make, args, kw):
    got, want = _both(name, make, args, **kw)
    compare(got, want, TOL)


@pytest.mark.parametrize("cls,make,args,batched", [
    ("Jacobian", f1, X, False), ("Jacobian", f2, (X, Y), False),
    ("Jacobian", fb, (XB, YB), True), ("Hessian", s1, X, False),
    ("Hessian", s2, (X, Y), False), ("Hessian", sb, XB, True),
])
def test_matrix_classes(cls, make, args, batched):
    jm = getattr(JA, cls)(make(P), _t(P, args), is_batched=batched)
    tm = getattr(TA, cls)(make(paddle), _t(paddle, args),
                          is_batched=batched)
    assert tm.shape == jm.shape
    compare(tm[:], jm[:], TOL)
    compare(tm[0], jm[0], TOL)


def test_create_graph_raises_as_in_the_reference():
    x = paddle.to_tensor(X, stop_gradient=False)
    jx = P.to_tensor(X, stop_gradient=False)
    for lib, mod, v in ((P, JA, jx), (paddle, TA, x)):
        with pytest.raises(NotImplementedError):
            mod.jacobian(f1(lib), v, create_graph=True)
        with pytest.raises(NotImplementedError):
            mod.hessian(s1(lib), v, create_graph=True)
        y = (v * v).sum()
        with pytest.raises(NotImplementedError):
            lib.grad([y], [v], create_graph=True)


def test_results_are_detached_and_batch_axis_is_checked():
    x = paddle.to_tensor(X, stop_gradient=False)
    j = TA.jacobian(f1(paddle), x)
    assert not j.requires_grad
    np.testing.assert_array_equal(as_np(x), X)
    with pytest.raises(ValueError):
        TA.jacobian(f1(paddle), x, batch_axis=1)
