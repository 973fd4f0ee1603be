"""Activation layers — the counterpart of
``paddle_tpu/nn/layers/activation.py``, whole."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from ..layer import Layer


def _simple(name, fn, **fixed):
    def forward(self, x):
        kwargs = {k: getattr(self, k) for k in self._arg_names}
        return fn(x, **kwargs)

    def __init__(self, **kwargs):
        Layer.__init__(self)
        merged = dict(fixed)
        merged.update({k: v for k, v in kwargs.items() if k != "name"})
        self._arg_names = list(merged)
        for k, v in merged.items():
            setattr(self, k, v)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward})


ReLU = _simple("ReLU", F.relu)
ReLU6 = _simple("ReLU6", F.relu6)
Sigmoid = _simple("Sigmoid", F.sigmoid)
Tanh = _simple("Tanh", F.tanh)
Silu = _simple("Silu", F.silu)
Swish = _simple("Swish", F.silu)
Mish = _simple("Mish", F.mish)
Hardswish = _simple("Hardswish", F.hardswish)
Hardsigmoid = _simple("Hardsigmoid", F.hardsigmoid)
Hardtanh = _simple("Hardtanh", F.hardtanh, min=-1.0, max=1.0)
Hardshrink = _simple("Hardshrink", F.hardshrink, threshold=0.5)
Softshrink = _simple("Softshrink", F.softshrink, threshold=0.5)
Tanhshrink = _simple("Tanhshrink", F.tanhshrink)
Softsign = _simple("Softsign", F.softsign)
Softplus = _simple("Softplus", F.softplus, beta=1.0, threshold=20.0)
LeakyReLU = _simple("LeakyReLU", F.leaky_relu, negative_slope=0.01)
ELU = _simple("ELU", F.elu, alpha=1.0)
SELU = _simple("SELU", F.selu)
CELU = _simple("CELU", F.celu, alpha=1.0)
GELU = _simple("GELU", F.gelu, approximate=False)
Softmax = _simple("Softmax", F.softmax, axis=-1)
LogSoftmax = _simple("LogSoftmax", F.log_softmax, axis=-1)
GLU = _simple("GLU", F.glu, axis=-1)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            shape=[num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, name=None):
        super().__init__()
        self.lower = lower
        self.upper = upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, self.training)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self.threshold = threshold
        self.value = value

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold, self.value)


class LogSigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.log_sigmoid(x)
