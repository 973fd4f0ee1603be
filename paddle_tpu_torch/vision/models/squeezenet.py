"""SqueezeNet (reference: ``python/paddle/vision/models/squeezenet.py``).

The counterpart of ``paddle_tpu/vision/models/squeezenet.py``: the same
layers in the same order, so the state dict carries its keys and a
seeded model its initial weights.
"""
from ... import nn


class _Fire(nn.Layer):
    def __init__(self, in_c, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Sequential(nn.Conv2D(in_c, squeeze, 1), nn.ReLU())
        self.expand1 = nn.Sequential(nn.Conv2D(squeeze, e1, 1), nn.ReLU())
        self.expand3 = nn.Sequential(nn.Conv2D(squeeze, e3, 3, padding=1),
                                     nn.ReLU())

    def forward(self, x):
        from ...ops import concat
        s = self.squeeze(x)
        return concat([self.expand1(s), self.expand3(s)], axis=1)


class SqueezeNet(nn.Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            feats = [nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                     nn.MaxPool2D(3, stride=2),
                     _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                     _Fire(128, 32, 128, 128), nn.MaxPool2D(3, stride=2),
                     _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                     _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                     nn.MaxPool2D(3, stride=2), _Fire(512, 64, 256, 256)]
        elif version == "1.1":
            feats = [nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                     nn.MaxPool2D(3, stride=2),
                     _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                     nn.MaxPool2D(3, stride=2),
                     _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                     nn.MaxPool2D(3, stride=2),
                     _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                     _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256)]
        else:
            raise ValueError(f"version must be '1.0' or '1.1', got {version}")
        self.features = nn.Sequential(*feats)
        if num_classes > 0:
            self.classifier_conv = nn.Sequential(
                nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1), nn.ReLU())
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier_conv(x)
        if self.with_pool:
            x = self.pool(x)
        from ...ops import flatten
        return flatten(x, 1)


def squeezenet1_0(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are files from outside the repository; "
            "load weights via model.set_state_dict")
    return SqueezeNet(version="1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are files from outside the repository; "
            "load weights via model.set_state_dict")
    return SqueezeNet(version="1.1", **kwargs)
