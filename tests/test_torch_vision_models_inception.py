"""GoogLeNet and InceptionV3 of the port's vision model zoo against the
JAX package's on the CPU, by the checks of ``test_torch_vision_models.py``:
every constructor's state-dict keys, order and seeded weights bit for
bit; both in training mode, float64 on both sides, batch 2 at 64 x 64
(InceptionV3 75 x 75), at that file's limits (GoogLeNet's loss sums its
three heads, so the aux heads' gradients are held too; InceptionV3's
gradients at ``INCEPTION_GRAD_TOL``); feature mode; the aux heads'
outputs; ``pretrained=True`` raises.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.vision import models as tmodels
from test_torch_vision_models import (CLASSES, GRAD_TOL, _port,
                                      check_feature_mode,
                                      check_seeded_weights, check_train_step)
from torch_threads import one_torch_thread  # noqa: F401

CONSTRUCTORS = [
    ("googlenet", "googlenet", {}),
    ("GoogLeNet_with_pool_off", "GoogLeNet", {"with_pool": False,
                                              "num_classes": 0}),
    ("inception_v3", "inception_v3", {}),
    ("InceptionV3_features", "InceptionV3", {"num_classes": 0}),
]
#: InceptionV3's gradients: its smallest weight gradients show the cross
#: entropy's float32 rounding at up to 1.4e-6 of their max
INCEPTION_GRAD_TOL = 4e-6
TRAIN = [
    ("googlenet", "googlenet", {}, 64, GRAD_TOL),
    ("inception_v3", "inception_v3", {}, 75, INCEPTION_GRAD_TOL),
]
FEATURES = [("googlenet", 64)]
PRETRAINED = ["googlenet", "inception_v3"]


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


@pytest.mark.parametrize("fn,kw", [c[1:] for c in CONSTRUCTORS],
                         ids=[c[0] for c in CONSTRUCTORS])
def test_state_dict_keys_and_seeded_weights_bit_for_bit(fn, kw):
    check_seeded_weights(fn, kw)


@pytest.mark.parametrize("fn,kw,side,grad_tol", [t[1:] for t in TRAIN],
                         ids=[t[0] for t in TRAIN])
def test_train_step_loss_gradients_and_buffers_match(fn, kw, side, grad_tol):
    check_train_step(fn, kw, side, grad_tol)


@pytest.mark.parametrize("fn,side", FEATURES)
def test_feature_mode_matches_reference(fn, side):
    check_feature_mode(fn, {}, side)


@pytest.mark.parametrize("fn", PRETRAINED)
def test_pretrained_raises(fn):
    with pytest.raises(NotImplementedError, match="pretrained"):
        getattr(tmodels, fn)(pretrained=True)


def test_googlenet_aux_heads():
    """Three heads with classes (main, aux1 after inception 4a, aux2 after
    4d) in train and eval mode; one output in feature mode."""
    m = _port("googlenet", {})
    x = torch.from_numpy(np.random.RandomState(1).randn(
        2, 3, 64, 64).astype(np.float32))
    for train in (True, False):
        m.train(train)
        with torch.no_grad():
            out = m(x)
        assert isinstance(out, tuple) and len(out) == 3
        assert all(o.shape == (2, CLASSES) for o in out)
    f = tmodels.googlenet(num_classes=0)
    f.eval()
    with torch.no_grad():
        assert f(x).shape == (2, 1024, 1, 1)
