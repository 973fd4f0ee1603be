"""MobileNetV3 and ShuffleNetV2 of the port's vision model zoo against the
JAX package's on the CPU, by the checks of ``test_torch_vision_models.py``
(DenseNet: ``..._dense.py``; GoogLeNet and InceptionV3:
``..._inception.py``; one file a family group, so the suite's workers
share their reference builds): every constructor's state-dict keys,
order and seeded weights bit for bit; one depth a family in training mode, float64 on both
sides, batch 2 at 64 x 64, at that file's limits; feature mode;
``pretrained=True`` raises.
"""
import pytest

import paddle_tpu_torch as paddle
from paddle_tpu_torch.vision import models as tmodels
from test_torch_vision_models import (check_feature_mode,
                                      check_seeded_weights, check_train_step)
from torch_threads import one_torch_thread  # noqa: F401

CONSTRUCTORS = [
    ("mobilenet_v3_small", "mobilenet_v3_small", {}),
    ("mobilenet_v3_large", "mobilenet_v3_large", {}),
    ("MobileNetV3Small", "MobileNetV3Small", {}),
    ("MobileNetV3Large", "MobileNetV3Large", {}),
    ("shufflenet_v2_x0_25", "shufflenet_v2_x0_25", {}),
    ("shufflenet_v2_x0_33", "shufflenet_v2_x0_33", {}),
    ("shufflenet_v2_x0_5", "shufflenet_v2_x0_5", {}),
    ("shufflenet_v2_x1_0", "shufflenet_v2_x1_0", {}),
    ("shufflenet_v2_x1_5", "shufflenet_v2_x1_5", {}),
    ("shufflenet_v2_x2_0", "shufflenet_v2_x2_0", {}),
    ("shufflenet_v2_swish", "shufflenet_v2_swish", {}),
    ("ShuffleNetV2_x0_5_swish", "ShuffleNetV2",
     {"scale": 0.5, "act": "swish"}),
]
TRAIN = [
    ("mobilenet_v3_small", "mobilenet_v3_small", {}, 64),
    ("shufflenet_v2_x0_25", "shufflenet_v2_x0_25", {}, 64),
]
FEATURES = [("mobilenet_v3_large", 64), ("shufflenet_v2_x0_5", 64)]
PRETRAINED = ["mobilenet_v3_small", "mobilenet_v3_large",
              "shufflenet_v2_x0_25", "shufflenet_v2_swish"]


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


@pytest.mark.parametrize("fn,kw", [c[1:] for c in CONSTRUCTORS],
                         ids=[c[0] for c in CONSTRUCTORS])
def test_state_dict_keys_and_seeded_weights_bit_for_bit(fn, kw):
    check_seeded_weights(fn, kw)


@pytest.mark.parametrize("fn,kw,side", [t[1:] for t in TRAIN],
                         ids=[t[0] for t in TRAIN])
def test_train_step_loss_gradients_and_buffers_match(fn, kw, side):
    check_train_step(fn, kw, side)


@pytest.mark.parametrize("fn,side", FEATURES)
def test_feature_mode_matches_reference(fn, side):
    check_feature_mode(fn, {}, side)


@pytest.mark.parametrize("fn", PRETRAINED)
def test_pretrained_raises(fn):
    with pytest.raises(NotImplementedError, match="pretrained"):
        getattr(tmodels, fn)(pretrained=True)
