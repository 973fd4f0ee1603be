"""The port's ``LSTM`` stacks (``SimpleRNN``'s and ``GRU``'s are
``test_torch_rnn_stacks.py``) against the JAX package's, on the CPU, at
1 and 2 layers, forward and bidirectional, batch- and time-major:
initial weights bit for bit, outputs and final states within 1e-5,
gradients within 1e-4 (``test_torch_rnn.py``'s ``_build`` and ``_run``).
"""
import pytest

from test_torch_rnn import XB, XT, I, H, _build, _run
from torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as paddle


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


MODES = ("LSTM",)
STACKS = [(mode, layers, direction, tm)
          for mode in MODES
          for layers in (1, 2)
          for direction in ("forward", "bidirect")
          for tm in (False, True)]


@pytest.mark.parametrize("mode,layers,direction,time_major", STACKS)
def test_stack(mode, layers, direction, time_major):
    jl, tl = _build(lambda nn: getattr(nn, mode)(
        I, H, num_layers=layers, direction=direction,
        time_major=time_major))
    _run(jl, tl, [XT if time_major else XB])
