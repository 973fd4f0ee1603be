"""``paddle.vision`` — datasets, transforms and the ResNet models (the
counterpart of ``paddle_tpu/vision``; ``vision.ops`` and the other models
wait for ROADMAP.md Queue A step 12c)."""
from . import datasets, models, transforms  # noqa: F401
