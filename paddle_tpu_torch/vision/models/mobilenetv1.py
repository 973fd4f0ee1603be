"""MobileNetV1 (reference: ``python/paddle/vision/models/mobilenetv1.py``).

The counterpart of ``paddle_tpu/vision/models/mobilenetv1.py``: the same
layers in the same order, so the state dict carries its keys and a
seeded model its initial weights.
"""
from ... import nn


def _conv_bn(in_c, out_c, k, stride=1, padding=0, groups=1):
    return nn.Sequential(
        nn.Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                  groups=groups, bias_attr=False),
        nn.BatchNorm2D(out_c), nn.ReLU())


class _DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c, stride):
        super().__init__()
        self.fn = nn.Sequential(
            _conv_bn(in_c, in_c, 3, stride=stride, padding=1, groups=in_c),
            _conv_bn(in_c, out_c, 1))

    def forward(self, x):
        return self.fn(x)


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return int(ch * scale)

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
              [(512, 1024, 2), (1024, 1024, 1)]
        layers = [_conv_bn(3, c(32), 3, stride=2, padding=1)]
        layers += [_DepthwiseSeparable(c(i), c(o), s) for i, o, s in cfg]
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(c(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            from ...ops import flatten
            x = self.fc(flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are files from outside the repository; "
            "load weights via model.set_state_dict")
    return MobileNetV1(scale=scale, **kwargs)
