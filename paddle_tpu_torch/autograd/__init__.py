"""``paddle.autograd`` on PyTorch's engine (``autograd/functional`` waits
for ROADMAP.md Queue A step 12b)."""
from .engine import (backward, enable_grad, grad, is_grad_enabled, no_grad,
                     set_grad_enabled)
from .py_layer import LegacyPyLayer, PyLayer, PyLayerContext

__all__ = ["backward", "enable_grad", "grad", "is_grad_enabled", "no_grad",
           "set_grad_enabled", "PyLayer", "PyLayerContext", "LegacyPyLayer"]
