"""``paddle.hapi`` — ``Model``, ``summary`` and ``flops`` (the counterpart
of ``paddle_tpu/hapi``)."""
from .model import Model  # noqa: F401
