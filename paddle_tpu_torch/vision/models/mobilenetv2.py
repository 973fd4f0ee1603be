"""MobileNetV2 (reference: ``python/paddle/vision/models/mobilenetv2.py``).

The counterpart of ``paddle_tpu/vision/models/mobilenetv2.py``: the same
layers in the same order, so the state dict carries its keys and a
seeded model its initial weights.
"""
from ... import nn


class _InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers += [nn.Conv2D(inp, hidden, 1, bias_attr=False),
                       nn.BatchNorm2D(hidden), nn.ReLU6()]
        layers += [
            nn.Conv2D(hidden, hidden, 3, stride=stride, padding=1,
                      groups=hidden, bias_attr=False),
            nn.BatchNorm2D(hidden), nn.ReLU6(),
            nn.Conv2D(hidden, oup, 1, bias_attr=False), nn.BatchNorm2D(oup),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = int(32 * scale)
        features = [nn.Conv2D(3, in_c, 3, stride=2, padding=1, bias_attr=False),
                    nn.BatchNorm2D(in_c), nn.ReLU6()]
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                features.append(_InvertedResidual(in_c, out_c,
                                                  s if i == 0 else 1, t))
                in_c = out_c
        last = int(1280 * max(1.0, scale))
        features += [nn.Conv2D(in_c, last, 1, bias_attr=False),
                     nn.BatchNorm2D(last), nn.ReLU6()]
        self.features = nn.Sequential(*features)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(nn.Dropout(0.2),
                                            nn.Linear(last, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            from ...ops import flatten
            x = self.classifier(flatten(x, 1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are files from outside the repository; "
            "load weights via model.set_state_dict")
    return MobileNetV2(scale=scale, **kwargs)
