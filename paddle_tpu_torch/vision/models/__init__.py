"""``paddle.vision.models`` — the ResNet family. The other models of
``paddle_tpu/vision/models`` wait for ROADMAP.md Queue A step 12c."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext101_32x4d, wide_resnet50_2,
                     wide_resnet101_2)
