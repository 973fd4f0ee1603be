"""``paddle.autograd`` on PyTorch's engine, with the functional transforms
(``jacobian``, ``hessian``, ``jvp``, ``vjp``) on ``torch.func``."""
from . import functional
from .engine import (backward, enable_grad, grad, is_grad_enabled, no_grad,
                     set_grad_enabled)
from .functional import Hessian, Jacobian, hessian, jacobian, jvp, vjp
from .py_layer import LegacyPyLayer, PyLayer, PyLayerContext

__all__ = ["backward", "enable_grad", "grad", "is_grad_enabled", "no_grad",
           "set_grad_enabled", "PyLayer", "PyLayerContext", "LegacyPyLayer",
           "functional", "jacobian", "hessian", "jvp", "vjp", "Jacobian",
           "Hessian"]
