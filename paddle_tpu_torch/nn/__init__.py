"""``paddle.nn`` — the layer library (``paddle_tpu/nn``): ``Layer`` and
its containers, ``functional``, ``initializer``, ``utils``, the common,
activation, conv, pooling, norm, loss, recurrent and transformer layers
and the gradient clips."""
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
from .layers.common import (AlphaDropout, Bilinear, ChannelShuffle,
                            CosineSimilarity, Dropout, Dropout2D, Dropout3D,
                            Embedding, FeatureAlphaDropout, Flatten, Fold,
                            Identity, Linear, Maxout, Pad1D, Pad2D, Pad3D,
                            PairwiseDistance, PixelShuffle, PixelUnshuffle,
                            Softmax2D, Unfold, Upsample, UpsamplingBilinear2D,
                            UpsamplingNearest2D, ZeroPad2D)
from .layers.conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                          Conv3D, Conv3DTranspose)
from .layers.rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, SimpleRNN,
                         SimpleRNNCell)
from .layers.loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                          CrossEntropyLoss, CTCLoss, GaussianNLLLoss,
                          HingeEmbeddingLoss, KLDivLoss, L1Loss,
                          MarginRankingLoss, MSELoss, MultiLabelSoftMarginLoss,
                          MultiMarginLoss, NLLLoss, PoissonNLLLoss,
                          SmoothL1Loss, SoftMarginLoss, TripletMarginLoss,
                          TripletMarginWithDistanceLoss)
from .layers.norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                          GroupNorm, InstanceNorm1D, InstanceNorm2D,
                          InstanceNorm3D, LayerNorm, LocalResponseNorm,
                          RMSNorm, SpectralNorm, SyncBatchNorm)
from .layers.pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                             AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                             AdaptiveMaxPool2D, AvgPool1D, AvgPool2D,
                             AvgPool3D, FractionalMaxPool2D,
                             FractionalMaxPool3D, MaxPool1D, MaxPool2D,
                             MaxPool3D, MaxUnPool1D, MaxUnPool2D,
                             MaxUnPool3D)
from .layers.transformer import (MultiHeadAttention, Transformer,
                                 TransformerDecoder, TransformerDecoderLayer,
                                 TransformerEncoder, TransformerEncoderLayer)
from . import utils  # noqa: E402
