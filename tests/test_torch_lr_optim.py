"""The port's LR schedulers, regularizers and optimizers against the JAX
package's, on the CPU. Every scheduler's learning rate over 50 steps
equals the reference's exactly (both are the same Python arithmetic),
and its ``state_dict`` round trip resumes the same sequence. ``SGD``,
``Momentum`` (plain and Nesterov), ``Adam`` and ``AdamW`` — driven by a
scheduler, with ``L1Decay``/``L2Decay``/float weight decay, per-parameter
learning-rate scales and regularizers (``ParamAttr``), a global-norm
clip and ``apply_decay_param_fun`` — take 3 steps on the same seeded
gradients as the JAX eager loop: parameters within 1e-6 of the
reference's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu.core.tensor import Parameter as JParam
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401

PARAM_TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


SCHEDULERS = [
    ("NoamDecay", (64, 10), {"learning_rate": 2.0}),
    ("PiecewiseDecay", ([5, 20, 30], [0.1, 0.05, 0.01, 0.001]), {}),
    ("NaturalExpDecay", (0.5, 0.1), {}),
    ("InverseTimeDecay", (0.5, 0.2), {}),
    ("PolynomialDecay", (0.5, 20), {"end_lr": 0.01, "power": 2.0}),
    ("PolynomialDecay", (0.5, 15), {"cycle": True}),
    ("LinearWarmup", (0.3, 10, 0.0, 0.3), {}),
    ("LinearWarmup", ("cosine", 10, 0.01, 0.2), {}),
    ("ExponentialDecay", (0.4, 0.9), {}),
    ("MultiStepDecay", (0.3, [10, 25, 40]), {"gamma": 0.5}),
    ("StepDecay", (0.3, 7), {"gamma": 0.7}),
    ("LambdaDecay", (0.2, lambda e: 0.95 ** e), {}),
    ("MultiplicativeDecay", (0.2, lambda e: 0.97), {}),
    ("CosineAnnealingDecay", (0.5, 20), {"eta_min": 0.01}),
    ("CosineAnnealingWarmRestarts", (0.5, 6), {"T_mult": 2,
                                               "eta_min": 0.001}),
    ("OneCycleLR", (0.8, 50), {"phase_pct": 0.25}),
    ("ReduceOnPlateau", (0.5,), {"patience": 2, "factor": 0.5,
                                 "cooldown": 1}),
    ("CyclicLR", (0.01, 0.1, 5), {"step_size_down": 8}),
    ("CyclicLR", (0.01, 0.1, 4), {"mode": "triangular2"}),
    ("CyclicLR", (0.01, 0.1, 4), {"mode": "exp_range", "exp_gamma": 0.98}),
]


def _make(mod, name, args, kw):
    if args and args[0] == "cosine":
        args = (mod.CosineAnnealingDecay(0.2, 30),) + args[1:]
    return getattr(mod, name)(*args, **kw)


def _walk(s, n, start=0):
    out = []
    for i in range(start, start + n):
        out.append(s())
        s.step(*(((100.0 - (i % 7) * (i < 20)),) if isinstance(
            s, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)) else ()))
    return out


@pytest.mark.parametrize("name,args,kw", SCHEDULERS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(SCHEDULERS)])
def test_scheduler_matches_reference(name, args, kw):
    js, ts = _make(jlr, name, args, kw), _make(tlr, name, args, kw)
    assert _walk(ts, 50) == _walk(js, 50)
    # a state-dict round trip resumes the same sequence
    js2, ts2 = _make(jlr, name, args, kw), _make(tlr, name, args, kw)
    js2.set_state_dict(js.state_dict())
    ts2.set_state_dict(ts.state_dict())
    assert ts.state_dict() == js.state_dict()
    assert _walk(ts2, 5, 50) == _walk(js2, 5, 50)


SHAPES = {"w": (5, 4), "b": (4,), "emb": (6, 3)}


def _params(attrs, framework):
    r = np.random.RandomState(1)
    out = []
    for n, s in SHAPES.items():
        v = r.randn(*s).astype(np.float32)
        p = JParam(P.to_tensor(v).value, name=n) if framework == "jax" \
            else paddle.Parameter(torch.from_numpy(v), name=n)
        for k, val in attrs.get(n, {}).items():
            setattr(p, k, val(framework) if callable(val) else val)
        out.append(p)
    return out


def _reg(kind, coeff):
    def make(framework):
        mod = P.regularizer if framework == "jax" else paddle.regularizer
        return getattr(mod, kind)(coeff)
    return make


def _sched(framework):
    mod = jlr if framework == "jax" else tlr
    return mod.LinearWarmup(mod.CosineAnnealingDecay(0.1, 10), 2, 0.01,
                            0.1)


OPTIMS = [
    ("SGD", {"learning_rate": 0.1}, {}),
    ("SGD", {"learning_rate": "sched", "weight_decay": "L1"},
     {"b": {"optimize_attr": {"learning_rate": 0.5}}}),
    ("Momentum", {"learning_rate": 0.05, "momentum": 0.8,
                  "weight_decay": 0.01}, {}),
    ("Momentum", {"learning_rate": "sched", "use_nesterov": True,
                  "grad_clip": 0.5},
     {"w": {"regularizer": _reg("L1Decay", 0.02)}}),
    ("Adam", {"learning_rate": "sched", "weight_decay": "L2"},
     {"emb": {"regularizer": _reg("L1Decay", 0.05),
              "optimize_attr": {"learning_rate": 2.0}}}),
    ("Adam", {"learning_rate": 0.01, "weight_decay": "L1",
              "grad_clip": 0.7}, {}),
    ("AdamW", {"learning_rate": "sched", "weight_decay": 0.1,
               "apply_decay_param_fun": lambda n: n != "b",
               "lr_ratio": lambda p: 1.0},
     {"w": {"optimize_attr": {"learning_rate": 0.3}}}),
    ("AdamW", {"learning_rate": 0.02, "weight_decay": "L2",
               "grad_clip": 0.4}, {}),
]


def _opt_kwargs(kw, framework):
    out = dict(kw)
    if out.get("learning_rate") == "sched":
        out["learning_rate"] = _sched(framework)
    wd = out.get("weight_decay")
    if wd in ("L1", "L2"):
        out["weight_decay"] = _reg(f"{wd}Decay", 0.03)(framework)
    if "grad_clip" in out:
        out["grad_clip"] = (P.nn if framework == "jax" else paddle.nn) \
            .ClipGradByGlobalNorm(out["grad_clip"])
    return out


@pytest.mark.parametrize("name,kw,attrs", OPTIMS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(OPTIMS)])
def test_optimizer_three_steps_match_reference(name, kw, attrs):
    jp, tp = _params(attrs, "jax"), _params(attrs, "torch")
    jopt = getattr(P.optimizer, name)(parameters=jp,
                                      **_opt_kwargs(kw, "jax"))
    topt = getattr(paddle.optimizer, name)(parameters=tp,
                                           **_opt_kwargs(kw, "torch"))
    r = np.random.RandomState(2)
    for _ in range(3):
        for a, b in zip(jp, tp):
            g = r.randn(*a.shape).astype(np.float32)
            a.grad = JTensor(P.to_tensor(g).value)
            b.grad = torch.from_numpy(g)
        jopt.step()
        topt.step()
        for sched in (jopt._learning_rate, topt._learning_rate):
            if not isinstance(sched, float):
                sched.step()
        for a, b in zip(jp, tp):
            err = np.max(np.abs(as_np(b) - as_np(a.value)))
            assert err <= PARAM_TOL, (a.name, err)
    assert topt.get_lr() == jopt.get_lr()
    ts, js = topt.state_dict(), jopt.state_dict()
    assert sorted(ts) == sorted(js)
    for k in js:
        if k not in ("@step", "LR_Scheduler"):
            assert np.max(np.abs(as_np(ts[k]) - as_np(js[k]))) <= PARAM_TOL
        else:
            assert ts[k] == js[k]
    # a fresh optimizer resumes from the state dict
    topt2 = getattr(paddle.optimizer, name)(parameters=tp,
                                            **_opt_kwargs(kw, "torch"))
    topt2.set_state_dict(ts)
    assert topt2._step_count == 3 and topt2.get_lr() == topt.get_lr()


def test_adamw_refuses_l1_and_scheduler_refuses_set_lr():
    p = [paddle.Parameter(torch.zeros(2))]
    with pytest.raises(TypeError, match="L2Decay"):
        paddle.optimizer.AdamW(parameters=p,
                               weight_decay=paddle.regularizer.L1Decay(0.1))
    with pytest.raises(TypeError, match="L2Decay"):
        P.optimizer.AdamW(parameters=[JParam(P.to_tensor([0.0, 0.0]).value)],
                          weight_decay=P.regularizer.L1Decay(0.1))
    opt = paddle.optimizer.SGD(learning_rate=tlr.StepDecay(0.1, 2),
                               parameters=p)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.2)
    assert "LR_Scheduler" in opt.state_dict()


def test_decay_fun_sees_parameter_names():
    seen = []
    tp = _params({}, "torch")
    opt = paddle.optimizer.AdamW(parameters=tp, apply_decay_param_fun=lambda
                                 n: seen.append(n) or True)
    for p in tp:
        p.grad = torch.ones_like(p)
    opt.step()
    assert seen == list(SHAPES)
    anon = [torch.nn.Parameter(torch.zeros(2))]
    anon[0].grad = torch.ones(2)
    seen.clear()
    paddle.optimizer.AdamW(parameters=anon,
                           apply_decay_param_fun=lambda n: seen.append(n)
                           or True).step()
    assert seen == [""]
