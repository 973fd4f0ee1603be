"""GoogLeNet / Inception-v1 (reference:
``python/paddle/vision/models/googlenet.py``). ``forward`` returns
``(out, aux1, aux2)`` like the reference (aux heads are trained jointly).

The counterpart of ``paddle_tpu/vision/models/googlenet.py``: the same
layers in the same order, so the state dict carries its keys and a
seeded model its initial weights.
"""
from ... import nn


def _conv_relu(in_c, out_c, k, stride=1, padding=0):
    return nn.Sequential(nn.Conv2D(in_c, out_c, k, stride=stride,
                                   padding=padding), nn.ReLU())


class _Inception(nn.Layer):
    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _conv_relu(in_c, c1, 1)
        self.b3 = nn.Sequential(_conv_relu(in_c, c3r, 1),
                                _conv_relu(c3r, c3, 3, padding=1))
        self.b5 = nn.Sequential(_conv_relu(in_c, c5r, 1),
                                _conv_relu(c5r, c5, 5, padding=2))
        self.bp = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                _conv_relu(in_c, proj, 1))

    def forward(self, x):
        from ...ops import concat
        return concat([self.b1(x), self.b3(x), self.b5(x), self.bp(x)],
                      axis=1)


class _AuxHead(nn.Layer):
    def __init__(self, in_c, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(4)
        self.conv = _conv_relu(in_c, 128, 1)
        self.fc1 = nn.Linear(128 * 16, 1024)
        self.relu = nn.ReLU()
        self.drop = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x):
        from ...ops import flatten
        x = flatten(self.conv(self.pool(x)), 1)
        return self.fc2(self.drop(self.relu(self.fc1(x))))


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _conv_relu(3, 64, 7, stride=2, padding=3),
            nn.MaxPool2D(3, stride=2, padding=1),
            _conv_relu(64, 64, 1), _conv_relu(64, 192, 3, padding=1),
            nn.MaxPool2D(3, stride=2, padding=1))
        self.ince3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.ince3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, stride=2, padding=1)
        self.ince4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.ince4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.ince4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.ince4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.ince4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, stride=2, padding=1)
        self.ince5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.ince5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.pool5 = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.drop = nn.Dropout(0.4)
            self.fc = nn.Linear(1024, num_classes)
            self.aux1 = _AuxHead(512, num_classes)
            self.aux2 = _AuxHead(528, num_classes)

    def forward(self, x):
        from ...ops import flatten
        x = self.stem(x)
        x = self.pool3(self.ince3b(self.ince3a(x)))
        x = self.ince4a(x)
        a1 = self.aux1(x) if self.num_classes > 0 else None
        x = self.ince4d(self.ince4c(self.ince4b(x)))
        a2 = self.aux2(x) if self.num_classes > 0 else None
        x = self.pool4(self.ince4e(x))
        x = self.ince5b(self.ince5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.drop(flatten(x, 1)))
            return x, a1, a2
        return x


def googlenet(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are files from outside the repository; "
            "load weights via model.set_state_dict")
    return GoogLeNet(**kwargs)
