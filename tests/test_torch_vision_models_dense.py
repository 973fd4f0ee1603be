"""DenseNet of the port's vision model zoo against the JAX package's on
the CPU, by the checks of ``test_torch_vision_models.py``: every
constructor's state-dict keys, order and seeded weights bit for bit (and
the class with dropout); DenseNet-121 in training mode, float64 on both
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
    ("densenet121", "densenet121", {}),
    ("densenet161", "densenet161", {}),
    ("densenet169", "densenet169", {}),
    ("densenet201", "densenet201", {}),
    ("densenet264", "densenet264", {}),
    ("DenseNet_121_dropout", "DenseNet", {"layers": 121, "dropout": 0.2}),
]
TRAIN = [("densenet121", "densenet121", {}, 64)]
FEATURES = [("densenet121", 64)]
PRETRAINED = ["densenet121", "densenet264"]


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
