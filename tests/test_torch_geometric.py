"""The port's ``paddle.geometric`` against the JAX package's, on the CPU:
every segment reduction (sum, mean, max, min) over ids with empty
segments (their rows 0, not +-inf), ``send_u_recv`` with each reduction
and with ``out_size`` below, at and above ``max(ids) + 1`` (indices past
it dropped), ``send_ue_recv`` with each message op, and ``send_uv``. The
same numpy inputs go through both; outputs within 1e-5 of the reference's
largest magnitude, input gradients within 1e-4.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as paddle
from test_torch_nn_layer import _rel
from torch_threads import one_torch_thread  # noqa: F401

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
R = np.random.RandomState(0)
X = R.randn(6, 3).astype(np.float32)
Y = R.randn(8, 3).astype(np.float32)          # one row an edge
# sorted segment ids with segments 2 and 4 empty
SEG = np.array([0, 0, 1, 3, 3, 5], np.int64)
SRC = np.array([0, 1, 2, 3, 4, 5, 1, 2], np.int64)
DST = np.array([1, 0, 1, 3, 3, 0, 5, 6], np.int64)   # rows 2, 4 empty
REDUCE = ("sum", "mean", "max", "min")
MESSAGE = ("add", "sub", "mul", "div")


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


def _both(call, floats, ints):
    """``call(lib, *tensors)`` on both sides: floats take gradients,
    ints are indices. Holds the output and the float inputs' gradients
    of ``sum(out * c)`` to the bounds."""
    j = [P.to_tensor(a, stop_gradient=False) for a in floats] \
        + [P.to_tensor(a) for a in ints]
    t = [paddle.to_tensor(a, stop_gradient=False) for a in floats] \
        + [paddle.to_tensor(a) for a in ints]
    jo, to = call(P, *j), call(paddle, *t)
    assert tuple(to.shape) == tuple(jo.shape)
    assert _rel(to, jo) <= FWD_TOL
    c = np.random.RandomState(1).randn(*tuple(jo.shape)).astype(np.float32)
    (jo * P.to_tensor(c)).sum().backward()
    (to * paddle.to_tensor(c)).sum().backward()
    for a, b in zip(t[:len(floats)], j[:len(floats)]):
        assert _rel(a.grad, b.grad) <= GRAD_TOL
    return to


@pytest.mark.parametrize("kind", REDUCE)
def test_segment(kind):
    out = _both(lambda lib, x, ids: getattr(lib.geometric,
                                            f"segment_{kind}")(x, ids),
                [X], [SEG])
    assert out.shape[0] == 6
    # the empty segments' rows are 0
    assert not out[2].abs().sum() and not out[4].abs().sum()


def test_incubate_names_the_same_ops():
    for kind in REDUCE:
        assert getattr(paddle.incubate, f"segment_{kind}") is \
            getattr(paddle.geometric, f"segment_{kind}")


@pytest.mark.parametrize("out_size", [None, 4, 7, 9])
@pytest.mark.parametrize("reduce_op", REDUCE)
def test_send_u_recv(reduce_op, out_size):
    out = _both(lambda lib, x, s, d: lib.geometric.send_u_recv(
        x, s, d, reduce_op=reduce_op, out_size=out_size), [X], [SRC, DST])
    assert out.shape[0] == (7 if out_size is None else out_size)


@pytest.mark.parametrize("reduce_op", REDUCE)
@pytest.mark.parametrize("message_op", MESSAGE)
def test_send_ue_recv(message_op, reduce_op):
    # edge rows away from 0, so "div" stays tame
    y = np.sign(Y) * (np.abs(Y) + 0.5)
    _both(lambda lib, x, e, s, d: lib.geometric.send_ue_recv(
        x, e, s, d, message_op=message_op, reduce_op=reduce_op),
        [X, y.astype(np.float32)], [SRC, DST])


@pytest.mark.parametrize("message_op", MESSAGE)
def test_send_uv(message_op):
    y = R.randn(7, 3).astype(np.float32)
    y = np.sign(y) * (np.abs(y) + 0.5)
    out = _both(lambda lib, x, yy, s, d: lib.geometric.send_uv(
        x, yy, s, d, message_op=message_op), [X, y.astype(np.float32)],
        [SRC, DST])
    assert tuple(out.shape) == (len(SRC), 3)
