from . import functional
from .layer import (FusedFeedForward, FusedMultiHeadAttention,
                    FusedMultiTransformer)
