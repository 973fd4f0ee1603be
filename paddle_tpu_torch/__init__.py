"""PyTorch/CUDA port of ``paddle_tpu``.

``paddle_tpu`` (JAX/XLA with Pallas kernels for TPU) stays the reference;
this package reimplements it slice by slice in PyTorch, with the
attention kernels written by hand in CUDA for Hopper
(``paddle_tpu_torch/csrc``): LLaMA serving and training, and the
Paddle-shaped substrate for eager training — dtypes and devices,
``to_tensor``, autograd, the ``paddle.*`` op surface, ``nn.Layer`` and its
layers, optimizers with LR schedulers and regularizers, AMP and
``save``/``load``; ``io`` (datasets, samplers, the DataLoader), the
conv, pooling and spatial-norm layers and ``vision`` (datasets,
transforms, the model zoo, the detection ops), ``geometric``,
``incubate`` (the fused layers, ``FusedMultiTransformer`` decoding
through the dense decode kernel), the ERNIE models, and the high-level
API (``Model``, ``metric``, ``callbacks``, ``summary``, ``flops``) — so
a Paddle-style script runs as
``import paddle_tpu_torch as paddle``. The Tensor is ``torch.Tensor``. It
imports neither JAX nor ``paddle_tpu``. New tensors go on ``"gpu:0"``
unless the caller asks for the CPU (``set_device("cpu")``); importing
the package touches no CUDA.
"""
from .core import device  # noqa: F401
from .core.device import (Place, device_count, get_device,  # noqa: F401
                          is_compiled_with_cuda, is_compiled_with_xpu,
                          set_device)
from .core.dtype import (bfloat16, bool_, complex64, complex128,  # noqa: F401
                         finfo, float16, float32, float64, get_default_dtype,
                         iinfo, int8, int16, int32, int64, promote_types,
                         set_default_dtype, uint8)
from .core.random import get_rng_state, seed, set_rng_state  # noqa: F401
from .core.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from .autograd.engine import (enable_grad, grad,  # noqa: F401
                              is_grad_enabled, no_grad, set_grad_enabled)
from .ops import *  # noqa: F401,F403
from . import ops  # noqa: F401
from . import amp, autograd, framework, jit, nn, optimizer  # noqa: F401
from . import io, regularizer, vision  # noqa: F401
from . import geometric, incubate  # noqa: F401
from . import callbacks, metric  # noqa: F401
from .framework.io import load, save  # noqa: F401
from .hapi.model import Model  # noqa: F401

bool = bool_  # paddle.bool


def disable_static(place=None):
    """Paddle 2.x starts in dynamic mode; the port is always eager."""
    return None


def in_dynamic_mode():
    return True


def summary(net, input_size=None, dtypes=None):
    from .hapi.summary import summary as _summary
    return _summary(net, input_size, dtypes)


def flops(net, input_size, custom_ops=None, print_detail=False):
    from .hapi.dynamic_flops import flops as _flops
    return _flops(net, input_size, custom_ops=custom_ops,
                  print_detail=print_detail)
