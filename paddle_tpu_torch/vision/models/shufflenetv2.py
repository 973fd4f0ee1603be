"""ShuffleNetV2 (reference: ``python/paddle/vision/models/shufflenetv2.py``).

The counterpart of ``paddle_tpu/vision/models/shufflenetv2.py``: the same
layers in the same order, so the state dict carries its keys and a
seeded model its initial weights.
"""
from ... import nn
from ...nn import functional as F


def _act_layer(act):
    return nn.Swish() if act == "swish" else nn.ReLU()


def _conv_bn_act(in_c, out_c, k, stride, groups=1, act="relu"):
    layers = [nn.Conv2D(in_c, out_c, k, stride=stride, padding=k // 2,
                        groups=groups, bias_attr=False),
              nn.BatchNorm2D(out_c)]
    if act:
        layers.append(_act_layer(act))
    return nn.Sequential(*layers)


class _ShuffleUnit(nn.Layer):
    """stride-1 unit: split channels, transform one half, shuffle."""

    def __init__(self, ch, act):
        super().__init__()
        half = ch // 2
        self.branch = nn.Sequential(
            _conv_bn_act(half, half, 1, 1, act=act),
            _conv_bn_act(half, half, 3, 1, groups=half, act=None),
            _conv_bn_act(half, half, 1, 1, act=act))

    def forward(self, x):
        from ...ops import concat, split
        x1, x2 = split(x, 2, axis=1)
        out = concat([x1, self.branch(x2)], axis=1)
        return F.channel_shuffle(out, 2)


class _ShuffleUnitDown(nn.Layer):
    """stride-2 unit: both branches downsample, concat doubles channels."""

    def __init__(self, in_c, out_c, act):
        super().__init__()
        half = out_c // 2
        self.branch1 = nn.Sequential(
            _conv_bn_act(in_c, in_c, 3, 2, groups=in_c, act=None),
            _conv_bn_act(in_c, half, 1, 1, act=act))
        self.branch2 = nn.Sequential(
            _conv_bn_act(in_c, half, 1, 1, act=act),
            _conv_bn_act(half, half, 3, 2, groups=half, act=None),
            _conv_bn_act(half, half, 1, 1, act=act))

    def forward(self, x):
        from ...ops import concat
        out = concat([self.branch1(x), self.branch2(x)], axis=1)
        return F.channel_shuffle(out, 2)


_STAGE_OUT = {
    0.25: (24, 24, 48, 96, 512),
    0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}
_STAGE_REPEATS = (4, 8, 4)


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        if scale not in _STAGE_OUT:
            raise ValueError(f"supported scales: {sorted(_STAGE_OUT)}")
        chs = _STAGE_OUT[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = _conv_bn_act(3, chs[0], 3, 2, act=act)
        self.max_pool = nn.MaxPool2D(3, stride=2, padding=1)
        stages = []
        in_c = chs[0]
        for si, reps in enumerate(_STAGE_REPEATS):
            out_c = chs[si + 1]
            units = [_ShuffleUnitDown(in_c, out_c, act)]
            units += [_ShuffleUnit(out_c, act) for _ in range(reps - 1)]
            stages.append(nn.Sequential(*units))
            in_c = out_c
        self.stages = nn.Sequential(*stages)
        self.conv_last = _conv_bn_act(in_c, chs[4], 1, 1, act=act)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(chs[4], num_classes)

    def forward(self, x):
        x = self.max_pool(self.conv1(x))
        x = self.stages(x)
        x = self.conv_last(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            from ...ops import flatten
            x = self.fc(flatten(x, 1))
        return x


def _shufflenet(scale, act="relu", pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are files from outside the repository; "
            "load weights via model.set_state_dict")
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet(0.25, pretrained=pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet(0.33, pretrained=pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet(0.5, pretrained=pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet(1.0, pretrained=pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet(1.5, pretrained=pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet(2.0, pretrained=pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shufflenet(1.0, act="swish", pretrained=pretrained, **kwargs)
