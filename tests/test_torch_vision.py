"""``paddle_tpu_torch.vision`` against the JAX package's ``vision`` on the
CPU: the transforms (``Resize`` — ``jax.image.resize``'s antialiased
linear method there, its arithmetic in numpy here — floats to 1e-5, uint8
within one step; the random ones after the same ``random.seed``, equal),
``FakeData``, ``DatasetFolder`` and ``MNIST`` from local files, and the
ResNet family (``resnet18``, ``resnet50`` and ``resnext50_32x4d`` at
64 x 64, batch 2, 10 classes; at 32 x 32 the last stage's BatchNorm sees
two values a channel, whose normalized difference flips sign on
last-place noise, so that input is not a parity test):

- the state dict's keys and order equal the reference's, and a seeded
  model's weights (Kaiming-uniform convs, the fc, the BatchNorm
  constants) equal the reference's bit for bit;
- in training mode, with the reference's weights carried by
  ``set_state_dict`` — each residual branch's last BatchNorm scale set to
  0.1 in both (at Paddle's scale of 1 the residual stream grows block by
  block, and ResNet-50's float32 gradients part from float64 ones by up
  to 25 %, the port's own as much as the reference's) — the
  cross-entropy loss agrees to 1e-5 relative,
  every gradient to 1e-4 of its largest magnitude, and the BatchNorm
  buffers after the step (``_mean``/``_variance``, Paddle's momentum 0.9)
  to 1e-5; one ``Momentum(0.9)`` + ``L2Decay(1e-4)`` step on
  ``PiecewiseDecay`` leaves every parameter within 1e-5 of the
  reference's (relative to its largest magnitude);
- ``jit.TrainStep`` on ``resnet18`` gives the eager loop's losses bit for
  bit, and the reference's eager losses to 1e-5;
- a run saved after two steps (model with BN buffers, Momentum velocity,
  the scheduler) and loaded into a fresh model and optimizer resumes bit
  for bit.

Each JAX model is built once a module (its first eager call compiles op
by op), and every check reads that cache.
"""
import gzip
import random

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu.vision import datasets as jdatasets
from paddle_tpu.vision import models as jmodels
from paddle_tpu.vision import transforms as JT
from paddle_tpu_torch.vision import datasets as tdatasets
from paddle_tpu_torch.vision import models as tmodels
from paddle_tpu_torch.vision import transforms as TT
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BUF_TOL = 1e-5
PARAM_TOL = 1e-5
CLASSES = 10
#: (architecture, input side)
ARCHS = {"resnet18": 64, "resnet50": 64, "resnext50_32x4d": 64}


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


# ------------------------------------------------------------- transforms
def _img(shape, dtype, seed):
    r = np.random.RandomState(seed)
    if dtype == np.uint8:
        return r.randint(0, 256, shape).astype(np.uint8)
    return r.standard_normal(shape).astype(np.float32)


def _equal(a, b, dtype):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if dtype == np.uint8:
        assert np.max(np.abs(a.astype(np.int32) - b.astype(np.int32))) <= 1
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8],
                         ids=["float32", "uint8"])
@pytest.mark.parametrize("shape,size", [
    ((40, 56, 3), (24, 24)),       # HWC, shrink (antialiased)
    ((20, 16, 3), (37, 29)),       # HWC, grow
    ((3, 48, 40), (17, 40)),       # CHW, one dim shrinks
    ((33, 45), (20, 71)),          # 2-D
    ((224, 224, 3), 180),          # an ImageNet-sized shrink
], ids=["hwc-down", "hwc-up", "chw", "2d", "imagenet"])
def test_resize_matches_jax_image_resize(shape, size, dtype):
    img = _img(shape, dtype, seed=sum(shape))
    _equal(TT.Resize(size)(img), JT.Resize(size)(img), dtype)


def test_resize_weights_match_jax():
    import jax.numpy as jnp
    from jax._src.image import scale as jscale
    from paddle_tpu_torch.nn.functional import linear_resize_weights
    for n, m in ((7, 3), (3, 7), (224, 180), (5, 5), (1, 4), (100, 1)):
        want = jscale.compute_weight_mat(n, m, m / n, 0.0,
                                         jscale._fill_triangle_kernel, True)
        np.testing.assert_allclose(linear_resize_weights(n, m),
                                   np.asarray(want, np.float32), rtol=1e-6,
                                   atol=1e-7)
        assert jnp.asarray(want).dtype == jnp.float32


_FIXED = {
    "to_tensor": lambda M: M.ToTensor(),
    "normalize_chw": lambda M: M.Normalize([0.485, 0.456, 0.406],
                                           [0.229, 0.224, 0.225]),
    "normalize_hwc": lambda M: M.Normalize(0.5, 0.25, data_format="HWC"),
    "center_crop": lambda M: M.CenterCrop(20),
    "transpose": lambda M: M.Transpose(),
    "grayscale": lambda M: M.Grayscale(3),
    "pad_constant": lambda M: M.Pad((1, 2, 3, 4), fill=7),
    "pad_reflect": lambda M: M.Pad(2, padding_mode="reflect"),
    "adjust_brightness": lambda M: M.AdjustBrightness(1.3),
    "adjust_contrast": lambda M: M.AdjustContrast(0.7),
    "adjust_hue": lambda M: M.AdjustHue(0.2),
}
_RANDOM = {
    "random_resized_crop": lambda M: M.RandomResizedCrop(24),
    "random_crop": lambda M: M.RandomCrop(20, padding=2),
    "hflip": lambda M: M.RandomHorizontalFlip(0.5),
    "vflip": lambda M: M.RandomVerticalFlip(0.5),
    "brightness": lambda M: M.BrightnessTransform(0.4),
    "contrast": lambda M: M.ContrastTransform(0.4),
    "saturation": lambda M: M.SaturationTransform(0.4),
    "hue": lambda M: M.HueTransform(0.3),
    "color_jitter": lambda M: M.ColorJitter(0.4, 0.4, 0.4, 0.1),
    "rotation_nearest": lambda M: M.RandomRotation(30),
    "rotation_bilinear_expand": lambda M: M.RandomRotation(
        45, interpolation="bilinear", expand=True),
    "erasing": lambda M: M.RandomErasing(prob=1.0, value=3),
    "gaussian_blur": lambda M: M.GaussianBlur(5, (0.5, 1.5)),
}


@pytest.mark.parametrize("dtype", [np.float32, np.uint8],
                         ids=["float32", "uint8"])
@pytest.mark.parametrize("name", sorted(_FIXED) + sorted(_RANDOM))
def test_transform_matches_reference(name, dtype):
    make = _FIXED.get(name) or _RANDOM[name]
    shape = (3, 28, 32) if name == "normalize_chw" else (28, 32, 3)
    img = _img(shape, dtype, seed=len(name))
    if name == "to_tensor" and dtype == np.float32:
        img = np.clip(img, 0, 1)
    for seed in range(4):
        random.seed(seed)
        got = make(TT)(img)
        random.seed(seed)
        want = make(JT)(img)
        _equal(got, want, np.asarray(want).dtype)


def test_imagenet_train_pipeline_matches_reference():
    """The ImageNet training transforms the smoke's loader runs, on
    FakeData's HWC images: RandomResizedCrop, a flip, HWC -> CHW and the
    ImageNet mean/std."""
    def pipe(M):
        return M.Compose([M.RandomResizedCrop(32), M.RandomHorizontalFlip(),
                          M.Transpose((2, 0, 1)),
                          M.Normalize([0.485, 0.456, 0.406],
                                      [0.229, 0.224, 0.225])])
    tds = tdatasets.FakeData(8, (48, 48, 3), CLASSES, transform=pipe(TT))
    jds = jdatasets.FakeData(8, (48, 48, 3), CLASSES, transform=pipe(JT))
    random.seed(5)
    got = [tds[i] for i in range(8)]
    random.seed(5)
    want = [jds[i] for i in range(8)]
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.shape == (3, 32, 32)
        np.testing.assert_allclose(gi, wi, rtol=1e-5, atol=1e-5)
        assert int(gl) == int(wl)


# --------------------------------------------------------------- datasets
@pytest.mark.parametrize("shape", [(3, 224, 224), (32, 32, 3)])
def test_fake_data_matches_reference(shape):
    t = tdatasets.FakeData(6, shape, 1000)
    j = jdatasets.FakeData(6, shape, 1000)
    assert len(t) == len(j) == 6
    for i in (0, 3, 5):
        (ti, tl), (ji, jl) = t[i], j[i]
        np.testing.assert_array_equal(ti, ji)
        assert tl.dtype == jl.dtype and int(tl) == int(jl)


def test_dataset_folder_and_mnist_from_local_files(tmp_path):
    r = np.random.RandomState(0)
    for c in ("cat", "dog"):
        (tmp_path / "folder" / c).mkdir(parents=True)
        for k in range(3):
            np.save(tmp_path / "folder" / c / f"{k}.npy",
                    r.randn(4, 4, 3).astype(np.float32))
    root = str(tmp_path / "folder")
    t, j = tdatasets.DatasetFolder(root), jdatasets.DatasetFolder(root)
    assert t.class_to_idx == j.class_to_idx and len(t) == len(j) == 6
    for i in range(6):
        np.testing.assert_array_equal(t[i][0], j[i][0])
        assert int(t[i][1]) == int(j[i][1])
    imgs = r.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = r.randint(0, 10, 5).astype(np.uint8)
    with gzip.open(tmp_path / "img.gz", "wb") as f:
        f.write(b"\0" * 16 + imgs.tobytes())
    with open(tmp_path / "lab", "wb") as f:
        f.write(b"\0" * 8 + labels.tobytes())
    kw = dict(image_path=str(tmp_path / "img.gz"),
              label_path=str(tmp_path / "lab"))
    t, j = tdatasets.MNIST(**kw), jdatasets.MNIST(**kw)
    assert len(t) == len(j) == 5
    for i in range(5):
        np.testing.assert_array_equal(t[i][0], j[i][0])
        assert int(t[i][1]) == int(j[i][1])
    with pytest.raises(RuntimeError, match="downloads"):
        tdatasets.MNIST(download=True)


# ----------------------------------------------------------------- ResNet
_CACHE = {}
#: the residual branches' last BatchNorm scale in the parity checks
BRANCH_SCALE = 0.1


def _branch_scale(key, arch):
    """A residual branch's last BatchNorm scale: bn3 of a bottleneck, bn2
    of a basic block."""
    last = "bn2.weight" if arch in ("resnet18", "resnet34") else \
        "bn3.weight"
    return key.startswith("layer") and key.endswith("." + last)


def _jstate(m):
    return {k: np.asarray(v.value) for k, v in m.state_dict().items()}


def _batch(side, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(2, 3, side, side).astype(np.float32),
            r.randint(0, CLASSES, 2).astype(np.int64))


def _joptimizer(P_, params):
    sched = P_.optimizer.lr.PiecewiseDecay([30, 60, 90],
                                           [0.1, 0.01, 0.001, 0.0001])
    return P_.optimizer.Momentum(
        learning_rate=sched, momentum=0.9, parameters=params,
        weight_decay=P_.regularizer.L2Decay(1e-4)), sched


def _reference(arch):
    """The JAX model built from seed 7 (its weights), and one training
    step on it: loss, gradients, BN buffers after the forward, parameters
    after a Momentum step. Cached a module."""
    if arch in _CACHE:
        return _CACHE[arch]
    side = ARCHS[arch]
    P.seed(7)
    jm = getattr(jmodels, arch)(num_classes=CLASSES)
    seeded = _jstate(jm)
    init = {k: (np.full_like(v, BRANCH_SCALE) if _branch_scale(k, arch)
                else v) for k, v in seeded.items()}
    jm.set_state_dict(init)
    x, y = _batch(side)
    jm.train()
    loss = P.nn.CrossEntropyLoss()(jm(P.to_tensor(x)), P.to_tensor(y))
    loss.backward()
    grads = {n: np.asarray(p.grad.value) for n, p in jm.named_parameters()}
    opt, _ = _joptimizer(P, jm.parameters())
    opt.step()
    _CACHE[arch] = {"keys": list(jm.state_dict()), "seeded": seeded,
                    "init": init,
                    "loss": float(loss.numpy()), "grads": grads,
                    "after": _jstate(jm)}
    return _CACHE[arch]


def _port(arch, seed=7):
    paddle.seed(seed)
    return getattr(tmodels, arch)(num_classes=CLASSES)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_state_dict_keys_and_kaiming_weights_bit_for_bit(arch):
    ref = _reference(arch)
    tm = _port(arch)
    sd = tm.state_dict()
    assert list(sd) == ref["keys"]
    for k, v in sd.items():
        np.testing.assert_array_equal(as_np(v), ref["seeded"][k], err_msg=k)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_loss_gradients_and_buffers_match(arch):
    ref = _reference(arch)
    tm = _port(arch, seed=99)
    assert tm.set_state_dict(ref["init"]) == ([], [])
    x, y = _batch(ARCHS[arch])
    tm.train()
    loss = paddle.nn.CrossEntropyLoss()(tm(paddle.to_tensor(x)),
                                        paddle.to_tensor(y))
    assert abs(loss.item() - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    loss.backward()
    for n, p in tm.named_parameters():
        g = ref["grads"][n]
        err = np.max(np.abs(as_np(p.grad) - g))
        assert err <= GRAD_TOL * max(np.max(np.abs(g)), 1e-30), n
    opt, _ = _joptimizer(paddle, tm.parameters())
    opt.step()
    for k, v in tm.state_dict().items():
        want = ref["after"][k]
        tol = BUF_TOL if k.endswith(("_mean", "_variance")) else PARAM_TOL
        err = np.max(np.abs(as_np(v) - want))
        assert err <= tol * max(np.max(np.abs(want)), 1.0), k


def test_eval_mode_uses_running_stats():
    ref = _reference("resnet18")
    tm = _port("resnet18")
    tm.set_state_dict(ref["after"])
    tm.eval()
    P.seed(7)
    jm = jmodels.resnet18(num_classes=CLASSES)
    jm.set_state_dict(ref["after"])
    jm.eval()
    x, _ = _batch(64, seed=4)
    got = as_np(tm(paddle.to_tensor(x)))
    want = np.asarray(jm(P.to_tensor(x)).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(as_np(tm.bn1._mean),
                                  ref["after"]["bn1._mean"])


@pytest.mark.parametrize("arch", ["resnet34", "resnet101", "resnet152",
                                  "resnext101_32x4d", "wide_resnet50_2",
                                  "wide_resnet101_2"])
def test_other_depths_build_with_the_reference_keys(arch):
    tm = getattr(tmodels, arch)(num_classes=CLASSES)
    jm = getattr(jmodels, arch)(num_classes=CLASSES)
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [tuple(v.shape) for v in tm.state_dict().values()] == \
        [tuple(v.shape) for v in jm.state_dict().values()]
    assert tm(torch.zeros(1, 3, 32, 32)).shape == (1, CLASSES)


def _trainer(seed=7, state=None):
    tm = _port("resnet18", seed)
    if state is not None:
        tm.set_state_dict(state)
    opt, sched = _joptimizer(paddle, tm.parameters())
    return tm, opt, sched


def _eager_step(tm, opt, sched, x, y):
    loss = paddle.nn.CrossEntropyLoss()(tm(x), y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    sched.step()
    return loss.item()


def test_train_step_on_resnet18_matches_eager_and_reference():
    """``TrainStep`` (the verify skill's flow 2) against the port's eager
    loop (bit for bit) and the reference's eager loop (1e-5 relative),
    three steps on one batch; the loss falls."""
    from paddle_tpu_torch.jit import TrainStep
    x, y = _batch(64, seed=1)
    tx, ty = paddle.to_tensor(x), paddle.to_tensor(y)
    ref = _reference("resnet18")
    tm, opt, sched = _trainer(state=ref["init"])
    step = TrainStep(tm, paddle.nn.CrossEntropyLoss(), opt)
    jit_losses = []
    for _ in range(3):
        jit_losses.append(float(step.step((tx,), (ty,))))
        sched.step()
    tm, opt, sched = _trainer(state=ref["init"])
    eager = [_eager_step(tm, opt, sched, tx, ty) for _ in range(3)]
    assert jit_losses == eager
    P.seed(7)
    jm = jmodels.resnet18(num_classes=CLASSES)
    jm.set_state_dict(ref["init"])
    jopt, jsched = _joptimizer(P, jm.parameters())
    want = []
    for _ in range(3):
        loss = P.nn.CrossEntropyLoss()(jm(P.to_tensor(x)), P.to_tensor(y))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jsched.step()
        want.append(float(loss.numpy()))
    np.testing.assert_allclose(eager, want, rtol=LOSS_RTOL)
    assert eager[-1] < eager[0]


def test_save_load_resume_bit_for_bit(tmp_path):
    """Two steps, ``paddle.save`` of the model (BN buffers included) and
    the optimizer (Momentum velocity, the scheduler), two more steps; a
    fresh model and optimizer from another seed, loaded, give those two
    steps' losses and weights bit for bit."""
    x, y = _batch(64, seed=2)
    tx, ty = paddle.to_tensor(x), paddle.to_tensor(y)
    tm, opt, sched = _trainer()
    for _ in range(2):
        _eager_step(tm, opt, sched, tx, ty)
    paddle.save(tm.state_dict(), str(tmp_path / "m.pdparams"))
    paddle.save(opt.state_dict(), str(tmp_path / "m.pdopt"))
    want = [_eager_step(tm, opt, sched, tx, ty) for _ in range(2)]
    tm2, opt2, sched2 = _trainer(seed=123)
    tm2.set_state_dict(paddle.load(str(tmp_path / "m.pdparams")))
    opt2.set_state_dict(paddle.load(str(tmp_path / "m.pdopt")))
    assert sched2.last_epoch == 2
    got = [_eager_step(tm2, opt2, sched2, tx, ty) for _ in range(2)]
    assert got == want
    for (k, a), b in zip(tm.state_dict().items(),
                         tm2.state_dict().values()):
        assert torch.equal(a, b), k
