"""The vision training path on a GPU: the spatial functionals on the card
against the same calls on the CPU (cuDNN's convolutions and pools with
the reference's padding and ceil-mode rules; TF32 off), DataLoader
batches landing on the card from pinned memory, a ResNet-18
``jit.TrainStep`` whose loss falls, and in float64 every ``vision.ops``
function (values 1e-10, gradients 1e-8 of their max, indices equal) and
a ShuffleNetV2 training step (float64 end to end, the cross entropy's
float32 cast made a no-op: loss 1e-10, gradients 1e-8 of their max),
card against CPU through ``chip_smoke.py``'s checks. Every test is ``cuda``-marked and
skips without a CUDA device. The file imports neither JAX nor
``paddle_tpu``; on the card::

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_vision_on_card.py
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.nn import functional as F

pytestmark = pytest.mark.cuda

#: card against CPU, both float32 (summation order only), of the largest
#: magnitude
TOL = 1e-5


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_device("gpu:0")
    yield torch.device("cuda")
    paddle.set_device("gpu:0")


def _close(got, want):
    got, want = got.detach().float().cpu(), want.detach().float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max() / want.abs().max().clamp(min=1e-30)
    assert float(err) <= TOL, float(err)


CASES = [
    ("conv2d", {"padding": "SAME", "stride": 2}, ((2, 4, 9, 11),
                                                  (6, 4, 3, 3))),
    ("conv2d", {"padding": [[1, 0], [0, 2]], "groups": 2},
     ((2, 4, 9, 11), (6, 2, 3, 3))),
    ("conv2d_transpose", {"stride": 2, "padding": [[1, 0], [0, 2]]},
     ((2, 4, 5, 6), (4, 3, 3, 3))),
    ("max_pool2d", {"kernel_size": 3, "stride": 2, "padding": 1,
                    "ceil_mode": True}, ((2, 3, 10, 9),)),
    ("avg_pool2d", {"kernel_size": 3, "stride": 2, "padding": 1,
                    "ceil_mode": True}, ((2, 3, 10, 9),)),
    ("adaptive_avg_pool2d", {"output_size": (3, 4)}, ((2, 3, 10, 9),)),
    ("interpolate", {"size": (5, 7), "mode": "bilinear"},
     ((2, 3, 10, 9),)),
    ("group_norm", {"num_groups": 2}, ((2, 4, 5, 6),)),
]


@pytest.mark.parametrize("name,kw,shapes", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_spatial_functional_card_vs_cpu(cuda_dev, name, kw, shapes):
    r = np.random.RandomState(len(name))
    arrays = [r.randn(*s).astype(np.float32) for s in shapes]
    fn = getattr(F, name)
    cpu = [torch.from_numpy(a).requires_grad_() for a in arrays]
    card = [torch.from_numpy(a).to(cuda_dev).requires_grad_()
            for a in arrays]
    want, got = fn(*cpu, **kw), fn(*card, **kw)
    _close(got, want)
    cot = torch.from_numpy(r.randn(*want.shape).astype(np.float32))
    (want * cot).sum().backward()
    (got * cot.to(cuda_dev)).sum().backward()
    for a, b in zip(card, cpu):
        _close(a.grad, b.grad)


def test_max_pool_mask_on_the_card(cuda_dev):
    x = torch.randn(2, 3, 10, 9)
    want = F.max_pool2d(x, 3, 2, 1, ceil_mode=True, return_mask=True)
    got = F.max_pool2d(x.to(cuda_dev), 3, 2, 1, ceil_mode=True,
                       return_mask=True)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])


def test_loader_batches_land_on_the_card(cuda_dev):
    from paddle_tpu_torch.vision.datasets import FakeData
    loader = paddle.io.DataLoader(FakeData(8, (3, 8, 8), 10), batch_size=4,
                                  num_workers=2)
    batches = list(loader)
    assert len(batches) == 2
    x, y = batches[1]
    assert x.device.type == "cuda" and y.device.type == "cuda"
    want = np.stack([FakeData(8, (3, 8, 8), 10)[i][0] for i in range(4, 8)])
    np.testing.assert_array_equal(x.cpu().numpy(), want)


def test_resnet18_train_step_on_the_card(cuda_dev):
    from paddle_tpu_torch.jit import TrainStep
    paddle.seed(0)
    model = paddle.vision.models.resnet18(num_classes=10)
    assert model.parameters()[0].device.type == "cuda"
    opt = paddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                    parameters=model.parameters())
    step = TrainStep(model, paddle.nn.CrossEntropyLoss(), opt)
    r = np.random.RandomState(1)
    x = paddle.to_tensor(r.randn(8, 3, 64, 64).astype(np.float32))
    y = paddle.to_tensor(r.randint(0, 10, 8).astype(np.int64))
    losses = [float(step.step((x,), (y,))) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_vision_ops_card_vs_cpu_float64(cuda_dev):
    from chip_smoke import vision_ops_card_vs_cpu
    out = vision_ops_card_vs_cpu("cuda")
    assert len(out) == 14
    assert all(r["device"] == "cuda" for r in out.values())


def test_zoo_step_card_vs_cpu_float64(cuda_dev):
    from chip_smoke import zoo_card_vs_cpu
    row = zoo_card_vs_cpu("shufflenet_v2_x0_25", 64)
    assert row["tensors"] > 100
