"""``paddle.vision.models`` — the model zoo of ``paddle_tpu/vision/models``:
ResNet (and its ResNeXt and wide variants), LeNet, VGG, MobileNet V1, V2
and V3, AlexNet, DenseNet, GoogLeNet, InceptionV3, ShuffleNetV2 and
SqueezeNet."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext101_32x4d, wide_resnet50_2,
                     wide_resnet101_2)
from .lenet import LeNet
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .mobilenetv3 import (MobileNetV3Large, MobileNetV3Small,
                          mobilenet_v3_large, mobilenet_v3_small)
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet264)
from .googlenet import GoogLeNet, googlenet
from .inceptionv3 import InceptionV3, inception_v3
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_swish,
                           shufflenet_v2_x0_25, shufflenet_v2_x0_33,
                           shufflenet_v2_x0_5, shufflenet_v2_x1_0,
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
