"""MobileNetV3 small/large (reference:
``python/paddle/vision/models/mobilenetv3.py``).

The counterpart of ``paddle_tpu/vision/models/mobilenetv3.py``: the same
layers in the same order, so the state dict carries its keys and a
seeded model its initial weights.
"""
from ... import nn


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _act(name):
    return nn.Hardswish() if name == "HS" else nn.ReLU()


class _SqueezeExcite(nn.Layer):
    def __init__(self, ch):
        super().__init__()
        mid = _make_divisible(ch // 4)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(ch, mid, 1)
        self.fc2 = nn.Conv2D(mid, ch, 1)
        self.relu = nn.ReLU()
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class _InvertedResidualV3(nn.Layer):
    def __init__(self, in_c, exp, out_c, k, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if exp != in_c:
            layers += [nn.Conv2D(in_c, exp, 1, bias_attr=False),
                       nn.BatchNorm2D(exp), _act(act)]
        layers += [nn.Conv2D(exp, exp, k, stride=stride, padding=k // 2,
                             groups=exp, bias_attr=False),
                   nn.BatchNorm2D(exp), _act(act)]
        if use_se:
            layers.append(_SqueezeExcite(exp))
        layers += [nn.Conv2D(exp, out_c, 1, bias_attr=False),
                   nn.BatchNorm2D(out_c)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


# (kernel, expansion, out_channels, use_se, activation, stride)
_LARGE = [(3, 16, 16, False, "RE", 1), (3, 64, 24, False, "RE", 2),
          (3, 72, 24, False, "RE", 1), (5, 72, 40, True, "RE", 2),
          (5, 120, 40, True, "RE", 1), (5, 120, 40, True, "RE", 1),
          (3, 240, 80, False, "HS", 2), (3, 200, 80, False, "HS", 1),
          (3, 184, 80, False, "HS", 1), (3, 184, 80, False, "HS", 1),
          (3, 480, 112, True, "HS", 1), (3, 672, 112, True, "HS", 1),
          (5, 672, 160, True, "HS", 2), (5, 960, 160, True, "HS", 1),
          (5, 960, 160, True, "HS", 1)]
_SMALL = [(3, 16, 16, True, "RE", 2), (3, 72, 24, False, "RE", 2),
          (3, 88, 24, False, "RE", 1), (5, 96, 40, True, "HS", 2),
          (5, 240, 40, True, "HS", 1), (5, 240, 40, True, "HS", 1),
          (5, 120, 48, True, "HS", 1), (5, 144, 48, True, "HS", 1),
          (5, 288, 96, True, "HS", 2), (5, 576, 96, True, "HS", 1),
          (5, 576, 96, True, "HS", 1)]


class MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_c, head_c, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_c = _make_divisible(16 * scale)
        layers = [nn.Conv2D(3, in_c, 3, stride=2, padding=1, bias_attr=False),
                  nn.BatchNorm2D(in_c), nn.Hardswish()]
        for k, exp, out_c, se, act, s in cfg:
            exp_c = _make_divisible(exp * scale)
            o = _make_divisible(out_c * scale)
            layers.append(_InvertedResidualV3(in_c, exp_c, o, k, s, se, act))
            in_c = o
        lc = _make_divisible(last_c * scale)
        layers += [nn.Conv2D(in_c, lc, 1, bias_attr=False),
                   nn.BatchNorm2D(lc), nn.Hardswish()]
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(lc, head_c), nn.Hardswish(), nn.Dropout(0.2),
                nn.Linear(head_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            from ...ops import flatten
            x = self.classifier(flatten(x, 1))
        return x


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_LARGE, 960, 1280, scale=scale,
                         num_classes=num_classes, with_pool=with_pool)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_SMALL, 576, 1024, scale=scale,
                         num_classes=num_classes, with_pool=with_pool)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are files from outside the repository; "
            "load weights via model.set_state_dict")
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are files from outside the repository; "
            "load weights via model.set_state_dict")
    return MobileNetV3Small(scale=scale, **kwargs)
