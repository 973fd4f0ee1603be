"""``paddle.Model``, ``paddle.metric``, ``paddle.callbacks``,
``paddle.summary`` and ``paddle.flops`` of the port against the JAX
package's on the CPU.

- ``Model.fit`` on LeNet (the same seeded weights, 2 epochs of 6 batches
  of 8 from a ``TensorDataset``, unshuffled, Momentum on a ``StepDecay``
  rate — Adam scales rounding-level gradient entries up to a part of the
  rate, so its trajectories part by more than 1e-5 within a few steps —
  with
  ``eval_data``, ``EarlyStopping``, ``ModelCheckpoint``, ``LRScheduler``,
  ``ReduceLROnPlateau`` and ``VisualDL``) gives the reference's per-batch
  losses and evaluation logs within 1e-5 relative, ``evaluate`` and
  ``predict`` the same; the rate is stepped twice a batch, as the
  reference steps it (``train_batch`` and the ``LRScheduler`` callback:
  a reference-side behaviour upstream Paddle does not have, ROADMAP.md
  Queue C), once without the callback.
- Each callback's effect against the reference's on the same logs
  (``EarlyStopping``'s ``mode="auto"``, ``ReduceLROnPlateau``'s cooldown
  and patience, the checkpoint files, ``scalars.jsonl``); ``save``/
  ``load`` resumes bit for bit; ``save(training=False)`` raises naming
  Queue A step 14.
- Every metric on seeded inputs equals the reference's.
- ``summary`` and ``flops`` equal the reference's counts on LeNet,
  ResNet-18 and a transposed-convolution net.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch.vision import models as tmodels
from torch_threads import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-5
BATCHES, BATCH = 6, 8


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


def _data(n, seed):
    """Images and labels a LeNet can learn: the class is the signs of the
    means of the images' top and bottom halves."""
    r = np.random.RandomState(seed)
    x = r.randn(n, 1, 28, 28).astype(np.float32)
    y = (x[:, 0, :14].mean((1, 2)) > 0) + 2 * (x[:, 0, 14:].mean((1, 2))
                                               > 0)
    return x, y.astype(np.int64)[:, None]


def _recorder(base):
    """A callback recording each train batch's loss and the eval logs."""
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.losses, self.evals = [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

        def on_eval_end(self, logs=None):
            self.evals.append(dict(logs))

    return Recorder()


def _fit(pkg, models, x, y, ex, ey, tmp, lr_callback=True):
    """``Model.fit`` of ``pkg`` (the port or the reference) with every
    callback; returns the model, its scheduler and the recorder."""
    pkg.seed(3)
    net = models.LeNet()
    sched = pkg.optimizer.lr.StepDecay(0.005, step_size=6, gamma=0.8)
    opt = pkg.optimizer.Momentum(learning_rate=sched, momentum=0.9,
                                 parameters=net.parameters())
    model = pkg.Model(net)
    model.prepare(opt, pkg.nn.CrossEntropyLoss(),
                  pkg.metric.Accuracy(topk=(1, 2)))
    rec = _recorder(pkg.callbacks.Callback)
    cbs = [rec, pkg.callbacks.EarlyStopping(monitor="acc_top1", patience=2),
           pkg.callbacks.ModelCheckpoint(save_dir=str(tmp / "ckpt")),
           pkg.callbacks.ReduceLROnPlateau(monitor="loss", patience=1),
           pkg.callbacks.VisualDL(log_dir=str(tmp / "vdl"))]
    if lr_callback:
        cbs.append(pkg.callbacks.LRScheduler(by_step=True))
    train = pkg.io.TensorDataset([x, y])
    evald = pkg.io.TensorDataset([ex, ey])
    model.fit(train, evald, batch_size=BATCH, epochs=2, shuffle=False,
              verbose=0, callbacks=cbs)
    return model, sched, rec


@pytest.mark.parametrize("lr_callback", [True, False])
def test_fit_evaluate_predict_match_reference(tmp_path, lr_callback):
    x, y = _data(BATCHES * BATCH, 0)
    ex, ey = _data(2 * BATCH, 1)
    tm, tsched, trec = _fit(paddle, tmodels, x, y, ex, ey,
                            tmp_path / "port", lr_callback)
    jm, jsched, jrec = _fit(P, jmodels, x, y, ex, ey, tmp_path / "ref",
                            lr_callback)
    assert len(trec.losses) == len(jrec.losses) == 2 * BATCHES
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=LOSS_RTOL)
    assert trec.losses[-1] < trec.losses[0]
    # the double step: train_batch and the callback each step the rate
    steps = 2 * BATCHES * (2 if lr_callback else 1)
    assert tsched.last_epoch == jsched.last_epoch == steps
    assert tsched() == jsched()
    assert len(trec.evals) == len(jrec.evals) == 2
    for t, j in zip(trec.evals, jrec.evals):
        assert set(t) == set(j) == {"loss", "acc_top1", "acc_top2"}
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=LOSS_RTOL)
    t_eval = tm.evaluate(paddle.io.TensorDataset([ex, ey]),
                         batch_size=BATCH, verbose=0)
    j_eval = jm.evaluate(P.io.TensorDataset([ex, ey]), batch_size=BATCH,
                         verbose=0)
    for k in j_eval:
        np.testing.assert_allclose(t_eval[k], j_eval[k], rtol=LOSS_RTOL)
    t_pred = tm.predict(paddle.io.TensorDataset([ex]), batch_size=BATCH,
                        stack_outputs=True)
    j_pred = jm.predict(P.io.TensorDataset([ex]), batch_size=BATCH,
                        stack_outputs=True)
    np.testing.assert_allclose(t_pred[0], j_pred[0], rtol=1e-5, atol=1e-5)
    assert t_pred[0].shape == (2 * BATCH, 10)
    # the checkpoints and the scalar log, as the reference writes them
    for side in ("port", "ref"):
        names = sorted(os.listdir(tmp_path / side / "ckpt"))
        assert names == ["0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams",
                         "final.pdopt", "final.pdparams"], (side, names)
    recs = [[json.loads(ln) for ln in open(tmp_path / side / "vdl"
                                           / "scalars.jsonl")]
            for side in ("port", "ref")]
    assert [r["step"] for r in recs[0]] == [r["step"] for r in recs[1]] \
        == list(range(2 * BATCHES))
    np.testing.assert_allclose([r["loss"] for r in recs[0]],
                               [r["loss"] for r in recs[1]],
                               rtol=LOSS_RTOL)


def test_save_load_resumes_bit_for_bit(tmp_path):
    """Two batches, ``Model.save``, two more; a fresh Model from another
    seed loaded from the checkpoint gives those two losses bit for bit."""
    x, y = _data(4 * BATCH, 2)
    batches = [(paddle.to_tensor(x[i:i + BATCH]),
                paddle.to_tensor(y[i:i + BATCH]))
               for i in range(0, 4 * BATCH, BATCH)]

    def make(seed):
        paddle.seed(seed)
        net = tmodels.LeNet()
        sched = paddle.optimizer.lr.StepDecay(0.004, step_size=1,
                                              gamma=0.7)
        opt = paddle.optimizer.Adam(learning_rate=sched,
                                    parameters=net.parameters())
        return paddle.Model(net).prepare(opt, paddle.nn.CrossEntropyLoss())

    m = make(3)
    for bx, by in batches[:2]:
        m.train_batch(bx, by)
    m.save(str(tmp_path / "ck"))
    want = [m.train_batch(bx, by)[0] for bx, by in batches[2:]]
    m2 = make(11)
    m2.load(str(tmp_path / "ck"))
    assert m2._optimizer._learning_rate.last_epoch == 2
    got = [m2.train_batch(bx, by)[0] for bx, by in batches[2:]]
    assert got == want
    for a, b in zip(m.state_dict().values(), m2.state_dict().values()):
        assert torch.equal(a, b)


def test_save_for_inference_raises_naming_step_14(tmp_path):
    m = paddle.Model(tmodels.LeNet(), inputs=[object()])
    with pytest.raises(NotImplementedError, match="step 14"):
        m.save(str(tmp_path / "inf"), training=False)
    with pytest.raises(ValueError, match="input spec"):
        paddle.Model(tmodels.LeNet()).save(str(tmp_path / "x"),
                                           training=False)


def test_prepare_with_a_mesh_raises_naming_step_13():
    net = tmodels.LeNet()
    opt = paddle.optimizer.Adam(parameters=net.parameters())
    with pytest.raises(NotImplementedError, match="step 13"):
        paddle.Model(net).prepare(opt, paddle.nn.CrossEntropyLoss(),
                                  mesh=object())


# ------------------------------------------------------------ callbacks
class _Holder:
    """The attributes a callback reads of a Model."""

    def __init__(self, opt):
        self._optimizer = opt
        self.stop_training = False


@pytest.mark.parametrize("monitor,mode,values", [
    ("loss", "auto", [1.0, 0.9, 0.95, 0.97, 0.96]),
    ("acc", "auto", [0.5, 0.6, 0.55, 0.58, 0.7]),
    ("err", "max", [0.2, 0.1, 0.3, 0.25, 0.2]),
])
def test_early_stopping_matches_reference(monitor, mode, values):
    got, want = [], []
    for pkg, out in ((paddle, got), (P, want)):
        cb = pkg.callbacks.EarlyStopping(monitor=monitor, mode=mode,
                                         patience=2, min_delta=0.01)
        holder = _Holder(None)
        cb.set_model(holder)
        for v in values:
            cb.on_eval_end({monitor: [v]})
            out.append((holder.stop_training, cb.best, cb.wait))
        out.append(cb.mode)
    assert got == want


@pytest.mark.parametrize("cooldown", [0, 1, 2])
def test_reduce_lr_on_plateau_matches_reference(cooldown):
    values = [1.0, 1.0, 0.99995, 0.9, 0.95, 0.95, 0.95, 0.95, 0.8, 0.85]
    got, want = [], []
    for pkg, out, net in ((paddle, got, paddle.nn.Linear(2, 2)),
                          (P, want, P.nn.Linear(2, 2))):
        opt = pkg.optimizer.SGD(learning_rate=0.5,
                                parameters=net.parameters())
        cb = pkg.callbacks.ReduceLROnPlateau(
            monitor="loss", factor=0.5, patience=2, cooldown=cooldown,
            min_lr=0.1, verbose=0)
        cb.set_model(_Holder(opt))
        for v in values:
            cb.on_eval_end({"loss": v})
            out.append((opt.get_lr(), cb.wait, cb.cooldown_counter))
    assert got == want
    assert got[-1][0] < 0.5


def test_reduce_lr_on_plateau_leaves_a_scheduler_alone():
    net = paddle.nn.Linear(2, 2)
    sched = paddle.optimizer.lr.StepDecay(0.1, step_size=1)
    opt = paddle.optimizer.SGD(learning_rate=sched,
                               parameters=net.parameters())
    cb = paddle.callbacks.ReduceLROnPlateau(patience=1, verbose=0)
    cb.set_model(_Holder(opt))
    cb.on_eval_end({"loss": 1.0})
    with pytest.warns(UserWarning, match="LRScheduler"):
        cb.on_eval_end({"loss": 2.0})
    assert opt.get_lr() == 0.1


def test_lr_scheduler_callback_by_epoch_and_progbar(capsys):
    net = paddle.nn.Linear(2, 2)
    sched = paddle.optimizer.lr.StepDecay(0.1, step_size=1)
    opt = paddle.optimizer.SGD(learning_rate=sched,
                               parameters=net.parameters())
    cb = paddle.callbacks.LRScheduler(by_step=False, by_epoch=True)
    cb.set_model(_Holder(opt))
    cb.on_train_batch_end(0)
    assert sched.last_epoch == 0
    cb.on_epoch_end(0)
    assert sched.last_epoch == 1
    bar = paddle.callbacks.ProgBarLogger(log_freq=1, verbose=1)
    bar.set_params({"epochs": 3})
    bar.on_epoch_begin(0)
    bar.on_train_batch_end(0, {"loss": 0.5})
    bar.on_epoch_end(0, {"loss": 0.25})
    out = capsys.readouterr().out
    assert "Epoch 1/3" in out and "loss: 0.5000" in out
    lst = paddle.callbacks.CallbackList([cb, bar])
    with pytest.raises(AttributeError):
        lst.not_a_hook


# -------------------------------------------------------------- metrics
def _metric_inputs(seed):
    r = np.random.RandomState(seed)
    logits = r.randn(64, 7).astype(np.float32)
    labels = r.randint(0, 7, (64, 1)).astype(np.int64)
    probs = r.rand(64).astype(np.float32)
    binary = r.randint(0, 2, 64).astype(np.int64)
    two = np.stack([1 - probs, probs], 1)
    return logits, labels, probs, binary, two


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_reference(seed):
    logits, labels, probs, binary, two = _metric_inputs(seed)
    tacc = paddle.metric.Accuracy(topk=(1, 3))
    jacc = P.metric.Accuracy(topk=(1, 3))
    for lo, hi in ((0, 40), (40, 64)):
        t = tacc.update(tacc.compute(torch.from_numpy(logits[lo:hi]),
                                     torch.from_numpy(labels[lo:hi])))
        j = jacc.update(jacc.compute(P.to_tensor(logits[lo:hi]),
                                     P.to_tensor(labels[lo:hi])))
        assert t == j
    assert tacc.accumulate() == jacc.accumulate()
    assert tacc.name() == jacc.name() == ["acc_top1", "acc_top3"]
    for cls in ("Precision", "Recall", "Auc"):
        tm, jm = getattr(paddle.metric, cls)(), getattr(P.metric, cls)()
        pred = two if cls == "Auc" else probs
        tm.update(torch.from_numpy(pred), torch.from_numpy(binary))
        jm.update(P.to_tensor(pred), P.to_tensor(binary))
        assert tm.accumulate() == jm.accumulate(), cls
        assert tm.name() == jm.name()
        tm.reset()
        assert tm.accumulate() == 0.0
    for k in (1, 2):
        t = paddle.metric.accuracy(torch.from_numpy(logits),
                                   torch.from_numpy(labels), k=k)
        j = P.metric.accuracy(P.to_tensor(logits), P.to_tensor(labels), k=k)
        assert float(t) == float(j.numpy())
        assert t.dtype == torch.float32


# ------------------------------------------------------- summary, flops
def _nets(pkg, models):
    pkg.seed(4)
    return {"lenet": (models.LeNet(), [1, 1, 28, 28]),
            "resnet18": (models.resnet18(num_classes=10), [1, 3, 32, 32]),
            "conv_transpose": (pkg.nn.Sequential(
                pkg.nn.Conv2DTranspose(8, 3, 3, stride=2),
                pkg.nn.BatchNorm2D(3), pkg.nn.ReLU(),
                pkg.nn.Conv2D(3, 4, 3, padding=1), pkg.nn.Flatten(),
                pkg.nn.Linear(4 * 11 * 11, 5)), [2, 8, 5, 5])}


def test_summary_and_flops_match_reference(capsys):
    tnets, jnets = _nets(paddle, tmodels), _nets(P, jmodels)
    for name in tnets:
        tnet, size = tnets[name]
        jnet, _ = jnets[name]
        # a frozen parameter counts as not trainable in both
        next(iter(tnet.parameters())).stop_gradient = True
        next(iter(jnet.parameters())).stop_gradient = True
        got = paddle.summary(tnet, size)
        tout = capsys.readouterr().out
        assert got == P.summary(jnet, size), name
        assert tout == capsys.readouterr().out
        tnet.train()
        got = paddle.flops(tnet, size, print_detail=True)
        tout = capsys.readouterr().out
        assert got == P.flops(jnet, size, print_detail=True), name
        assert tout == capsys.readouterr().out
        assert tnet.training
        assert all(len(m._forward_hooks) == 0
                   for m in tnet.sublayers(include_self=True))


def test_flops_custom_ops_and_frozen_sublayers():
    class Custom(paddle.nn.Layer):
        def forward(self, x):
            return x

    net = paddle.nn.Sequential(paddle.nn.Linear(4, 4), Custom(),
                               paddle.nn.BatchNorm1D(4))
    net.train()
    net[2].eval()
    base = paddle.flops(net, [2, 4])
    assert base == 2 * 4 * 5 + 2 * 2 * 4
    assert paddle.flops(net, [2, 4],
                        custom_ops={Custom: lambda l, i, o: 1000}) \
        == base + 1000
    assert net.training and not net[2].training
