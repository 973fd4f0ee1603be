"""``paddle.vision`` — datasets, transforms, the model zoo and the
detection ops (the counterpart of ``paddle_tpu/vision``)."""
from . import datasets, models, ops, transforms  # noqa: F401
