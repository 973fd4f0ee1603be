"""DenseNet (reference: ``python/paddle/vision/models/densenet.py``).

The counterpart of ``paddle_tpu/vision/models/densenet.py``: the same
layers in the same order, so the state dict carries its keys and a
seeded model its initial weights.
"""
from ... import nn


class _DenseLayer(nn.Layer):
    """BN-ReLU-Conv1x1(bn_size*growth) -> BN-ReLU-Conv3x3(growth)."""

    def __init__(self, in_c, growth_rate, bn_size, dropout):
        super().__init__()
        self.dropout = dropout
        self.fn = nn.Sequential(
            nn.BatchNorm2D(in_c), nn.ReLU(),
            nn.Conv2D(in_c, bn_size * growth_rate, 1, bias_attr=False),
            nn.BatchNorm2D(bn_size * growth_rate), nn.ReLU(),
            nn.Conv2D(bn_size * growth_rate, growth_rate, 3, padding=1,
                      bias_attr=False))
        if dropout:
            self.drop = nn.Dropout(dropout)

    def forward(self, x):
        from ...ops import concat
        y = self.fn(x)
        if self.dropout:
            y = self.drop(y)
        return concat([x, y], axis=1)


class _Transition(nn.Layer):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.fn = nn.Sequential(
            nn.BatchNorm2D(in_c), nn.ReLU(),
            nn.Conv2D(in_c, out_c, 1, bias_attr=False),
            nn.AvgPool2D(2, stride=2))

    def forward(self, x):
        return self.fn(x)


_ARCH = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class DenseNet(nn.Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        if layers not in _ARCH:
            raise ValueError(f"supported layers: {sorted(_ARCH)}, got {layers}")
        init_c, growth, block_cfg = _ARCH[layers]
        feats = [nn.Conv2D(3, init_c, 7, stride=2, padding=3, bias_attr=False),
                 nn.BatchNorm2D(init_c), nn.ReLU(),
                 nn.MaxPool2D(3, stride=2, padding=1)]
        c = init_c
        for bi, n in enumerate(block_cfg):
            for _ in range(n):
                feats.append(_DenseLayer(c, growth, bn_size, dropout))
                c += growth
            if bi != len(block_cfg) - 1:
                feats.append(_Transition(c, c // 2))
                c //= 2
        feats += [nn.BatchNorm2D(c), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Linear(c, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            from ...ops import flatten
            x = self.classifier(flatten(x, 1))
        return x


def _densenet(layers, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are files from outside the repository; "
            "load weights via model.set_state_dict")
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)
