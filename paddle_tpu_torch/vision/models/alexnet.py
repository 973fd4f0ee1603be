"""AlexNet (reference: ``python/paddle/vision/models/alexnet.py``) — also the
model used by the reference's pipeline-parallel parity tests
(``hybrid_parallel_pp_alexnet.py``).

The counterpart of ``paddle_tpu/vision/models/alexnet.py``: the same
layers in the same order, so the state dict carries its keys and a
seeded model its initial weights.
"""
from ... import nn


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2),
        )
        self.num_classes = num_classes
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
                nn.Dropout(), nn.Linear(4096, 4096), nn.ReLU(),
                nn.Linear(4096, num_classes),
            )
        self.pool = nn.AdaptiveAvgPool2D((6, 6))

    def forward(self, x):
        x = self.features(x)
        x = self.pool(x)
        if self.num_classes > 0:
            from ...ops import flatten
            x = self.classifier(flatten(x, 1))
        return x


def alexnet(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are files from outside the repository; "
            "load weights via model.set_state_dict")
    return AlexNet(**kwargs)
