"""``paddle.nn`` — the layer library (``paddle_tpu/nn``): ``Layer`` and
its containers, ``functional``, ``initializer``, the common, activation,
norm and loss layers and the gradient clips. The conv, pooling, rnn and
transformer layers and ``nn.utils`` wait for ROADMAP.md Queue A step 12b."""
from ..core.tensor import Parameter
from ..framework.param_attr import ParamAttr
from . import functional
from . import initializer
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue, clip_grad_norm_)
from .layer import Layer, LayerList, ParameterList, Sequential
from .layers.activation import (CELU, ELU, GELU, GLU, SELU, Hardshrink,
                                Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                                LogSigmoid, LogSoftmax, Mish, PReLU, ReLU,
                                ReLU6, RReLU, Sigmoid, Silu, Softmax,
                                Softplus, Softshrink, Softsign, Swish, Tanh,
                                Tanhshrink, ThresholdedReLU)
from .layers.common import Dropout, Embedding, Flatten, Identity, Linear
from .layers.loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss,
                          KLDivLoss, L1Loss, MSELoss, NLLLoss, SmoothL1Loss)
from .layers.norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                          LayerNorm, RMSNorm)
