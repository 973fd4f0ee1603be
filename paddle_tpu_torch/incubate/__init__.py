"""``paddle.incubate`` — the counterpart of ``paddle_tpu/incubate``: the
fused layers and functionals (``incubate.nn``), the ``autograd`` alias,
the older namespace of the segment ops, and ``incubate.distributed``,
whose MoE models wait for Queue A step 13."""
from . import distributed, nn  # noqa: F401
from .. import autograd as autograd  # noqa: F401  (incubate.autograd)
# the segment API before paddle.geometric (Paddle's
# python/paddle/incubate/tensor/math.py): the same ops, older namespace
from ..geometric import (segment_max, segment_mean, segment_min,  # noqa: F401
                         segment_sum)
