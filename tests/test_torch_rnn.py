"""The port's recurrent layers (``nn.SimpleRNNCell``, ``LSTMCell``,
``GRUCell``, ``RNN``, ``BiRNN``, ``SimpleRNN``, ``LSTM``, ``GRU``) against
the JAX package's, on the CPU. Layers built after the same ``seed`` hold
the JAX package's initial weights bit for bit (``Uniform(-1/sqrt(H),
1/sqrt(H))``, the reference's order of draws) under the same
``state_dict`` keys; the port's layer then takes the JAX weights, and
outputs and final states agree to 1e-5 of the reference's largest
magnitude, gradients (input and every parameter, against seeded
cotangents on every output) to 1e-4 of each gradient's largest. With
dropout between layers the masks follow one ``seed`` on both sides
(``F.dropout``'s key walk), so they are the same masks. The stacks at 1
and 2 layers, forward and bidirectional, batch- and time-major are
``test_torch_rnn_stacks.py``.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as paddle
from test_torch_nn_layer import _jstate, _rel
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
B, T, I, H = 3, 5, 4, 6


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [v for o in out for v in _flat(o)]
    return [out]


def _build(make, seed=0):
    P.seed(seed)
    jl = make(P.nn)
    paddle.seed(seed)
    tl = make(paddle.nn)
    js, ts = _jstate(jl), tl.state_dict()
    assert list(js) == list(ts)
    for k in js:
        np.testing.assert_array_equal(as_np(ts[k]), js[k], err_msg=k)
    return jl, tl


def _run(jl, tl, arrays, states=None, train=False, drop_seed=None):
    """Forward and backward of both layers on the same inputs (the JAX
    weights in the port's layer); returns nothing, asserts the bounds."""
    tl.set_state_dict(_jstate(jl))
    for m in (jl, tl):
        m.train() if train else m.eval()
    jx = [P.to_tensor(a, stop_gradient=False) for a in arrays]
    tx = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    jargs, targs = list(jx), list(tx)
    if states is not None:
        jargs.append(states(P))
        targs.append(states(paddle))
    if drop_seed is not None:
        P.seed(drop_seed)
    jo = _flat(jl(*jargs))
    if drop_seed is not None:
        paddle.seed(drop_seed)
    to = _flat(tl(*targs))
    assert len(jo) == len(to)
    r = np.random.RandomState(3)
    jloss = tloss = 0
    for j, t in zip(jo, to):
        assert _rel(t, j) <= FWD_TOL
        c = r.randn(*tuple(t.shape)).astype(np.float32)
        jloss = jloss + (j * P.to_tensor(c)).sum()
        tloss = tloss + (t * paddle.to_tensor(c)).sum()
    jloss.backward()
    tloss.backward()
    for j, t in zip(jx, tx):
        assert _rel(t.grad, j.grad) <= GRAD_TOL
    jp = dict(jl.named_parameters())
    for name, p in tl.named_parameters():
        assert _rel(p.grad, jp[name].grad) <= GRAD_TOL, name


R = np.random.RandomState(0)
XB = R.randn(B, T, I).astype(np.float32)
XT = np.ascontiguousarray(XB.transpose(1, 0, 2))
XC = R.randn(B, I).astype(np.float32)
H0 = R.randn(B, H).astype(np.float32)
C0 = R.randn(B, H).astype(np.float32)


@pytest.mark.parametrize("cell,kw", [
    ("SimpleRNNCell", {}), ("SimpleRNNCell", {"activation": "relu"}),
    ("LSTMCell", {}), ("GRUCell", {}),
    ("GRUCell", {"bias_ih_attr": False}),
])
def test_cell(cell, kw):
    jl, tl = _build(lambda nn: getattr(nn, cell)(I, H, **kw))
    _run(jl, tl, [XC])
    if cell == "LSTMCell":
        states = lambda lib: (lib.to_tensor(H0), lib.to_tensor(C0))  # noqa
    else:
        states = lambda lib: lib.to_tensor(H0)  # noqa: E731
    _run(jl, tl, [XC], states=states)


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("time_major,reverse", [(False, False),
                                                (True, True)])
def test_rnn_wrapper(cell, time_major, reverse):
    jl, tl = _build(lambda nn: nn.RNN(getattr(nn, cell)(I, H),
                                      is_reverse=reverse,
                                      time_major=time_major))
    _run(jl, tl, [XT if time_major else XB])


@pytest.mark.parametrize("time_major", [False, True])
def test_birnn(time_major):
    jl, tl = _build(lambda nn: nn.BiRNN(nn.LSTMCell(I, H),
                                        nn.LSTMCell(I, H),
                                        time_major=time_major))
    _run(jl, tl, [XT if time_major else XB])


def _custom_cell(nn):
    """A user cell: ``forward(x, states) -> (out, new_states)``."""
    class Cell(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ih = nn.Linear(I, H)
            self.hh = nn.Linear(H, H)

        def forward(self, x, h=None):
            z = self.ih(x)
            if h is not None:
                z = z + self.hh(h)
            out = nn.functional.tanh(z)
            return out, out

    return Cell()


@pytest.mark.parametrize("reverse", [False, True])
def test_rnn_with_a_custom_cell(reverse):
    jl, tl = _build(lambda nn: nn.RNN(_custom_cell(nn), is_reverse=reverse))
    _run(jl, tl, [XB])


@pytest.mark.parametrize("mode,kw", [
    ("SimpleRNN", {"activation": "relu"}), ("LSTM", {}), ("GRU", {}),
])
def test_stack_with_dropout_and_initial_states(mode, kw):
    """Two bidirectional layers, dropout 0.4 between them in training
    (the same masks: one seed), initial states given."""
    jl, tl = _build(lambda nn: getattr(nn, mode)(
        I, H, num_layers=2, direction="bidirect", dropout=0.4, **kw))
    h0 = R.randn(4, B, H).astype(np.float32)
    c0 = R.randn(4, B, H).astype(np.float32)
    if mode == "LSTM":
        states = lambda lib: (lib.to_tensor(h0), lib.to_tensor(c0))  # noqa
    else:
        states = lambda lib: lib.to_tensor(h0)  # noqa: E731
    _run(jl, tl, [XB], states=states, train=True, drop_seed=21)


def test_state_dict_nesting():
    jl, tl = _build(lambda nn: nn.LSTM(I, H, num_layers=2,
                                       direction="bidirect"))
    keys = list(tl.state_dict())
    assert keys[:4] == ["cells.0.weight_ih", "cells.0.weight_hh",
                        "cells.0.bias_ih", "cells.0.bias_hh"]
    assert len(keys) == 16 and tl.cells[2].weight_ih.shape == (4 * H, 2 * H)
