"""The port's ``Adagrad``, ``RMSProp`` (plain and centered, with momentum),
``Adadelta``, ``Adamax``, ``Lamb`` and ``LBFGS`` against the JAX
package's, on the CPU. The first five take 5 steps on the same seeded
gradients as the JAX eager loop (with a scheduler, weight decay, a
global-norm clip and ``exclude_from_weight_decay_fn`` where the optimizer
takes them): parameters and every ``state_dict`` slot within 1e-6 of the
reference's, under the reference's keys, and a fresh optimizer resumes
from the round-tripped ``state_dict``. ``LBFGS`` runs its closure on the
same ``Linear`` least-squares problem (the JAX layer's weights), 3 steps
of 6 iterations, with and without the strong-Wolfe line search:
parameters within 1e-6, losses within 1e-6 of the loss at zero
weights. (The problem is convex: on a
non-convex one the curvature history magnifies the two backends' float32
rounding of the forward pass, ~2e-7, into diverging iterates within a
few steps, whatever the port does.)
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as paddle
from test_torch_lr_optim import _opt_kwargs, _params
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401

PARAM_TOL = 1e-6
STEPS = 5


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


OPTIMS = [
    ("Adagrad", {"learning_rate": 0.1}, {}),
    ("Adagrad", {"learning_rate": "sched", "weight_decay": "L2",
                 "initial_accumulator_value": 0.1, "grad_clip": 0.5}, {}),
    ("RMSProp", {"learning_rate": 0.01}, {}),
    ("RMSProp", {"learning_rate": "sched", "momentum": 0.9,
                 "centered": True, "weight_decay": "L1"}, {}),
    ("Adadelta", {"learning_rate": 1.0, "rho": 0.9}, {}),
    ("Adadelta", {"learning_rate": "sched", "weight_decay": 0.01,
                  "grad_clip": 0.7}, {}),
    ("Adamax", {"learning_rate": 0.02}, {}),
    ("Adamax", {"learning_rate": "sched", "weight_decay": "L2",
                "beta1": 0.8}, {}),
    ("Lamb", {"learning_rate": 0.01}, {}),
    ("Lamb", {"learning_rate": "sched", "lamb_weight_decay": 0.05,
              "grad_clip": 0.4,
              "exclude_from_weight_decay_fn": lambda p: p.name == "b"}, {}),
]


@pytest.mark.parametrize("name,kw,attrs", OPTIMS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(OPTIMS)])
def test_optimizer_five_steps_match_reference(name, kw, attrs):
    jp, tp = _params(attrs, "jax"), _params(attrs, "torch")
    jopt = getattr(P.optimizer, name)(parameters=jp,
                                      **_opt_kwargs(kw, "jax"))
    topt = getattr(paddle.optimizer, name)(parameters=tp,
                                           **_opt_kwargs(kw, "torch"))
    r = np.random.RandomState(4)
    for _ in range(STEPS):
        for a, b in zip(jp, tp):
            g = r.randn(*a.shape).astype(np.float32)
            a.grad = P.to_tensor(g)
            b.grad = torch.from_numpy(g)
        jopt.step()
        topt.step()
        for sched in (jopt._learning_rate, topt._learning_rate):
            if not isinstance(sched, float):
                sched.step()
        for a, b in zip(jp, tp):
            err = np.max(np.abs(as_np(b) - as_np(a.value)))
            assert err <= PARAM_TOL, (a.name, err)
    ts, js = topt.state_dict(), jopt.state_dict()
    assert sorted(ts) == sorted(js)
    for k in js:
        if k in ("@step", "LR_Scheduler"):
            assert ts[k] == js[k]
        else:
            err = np.max(np.abs(as_np(ts[k]) - as_np(js[k])))
            assert err <= PARAM_TOL * max(1.0, np.max(np.abs(as_np(js[k])))), k
    # a fresh optimizer resumes from the state dict: the next step equal
    topt2 = getattr(paddle.optimizer, name)(parameters=tp,
                                            **_opt_kwargs(kw, "torch"))
    topt2.set_state_dict(ts)
    assert topt2._step_count == STEPS
    tq = [paddle.Parameter(p.detach().clone(), name=p.name) for p in tp]
    topt3 = getattr(paddle.optimizer, name)(parameters=tq,
                                            **_opt_kwargs(kw, "torch"))
    topt3.set_state_dict(ts)
    for a, b in zip(tp, tq):
        g = r.randn(*a.shape).astype(np.float32)
        a.grad = torch.from_numpy(g)
        b.grad = torch.from_numpy(g.copy())
    topt2.step()
    topt3.step()
    for a, b in zip(tp, tq):
        np.testing.assert_array_equal(as_np(a), as_np(b))


R = np.random.RandomState(7)
XS = R.randn(32, 6).astype(np.float32)
YS = (XS @ R.randn(6, 2) + 0.1 * R.randn(32, 2)).astype(np.float32)


def _lbfgs_run(lib, layer, line_search, steps):
    x, y = lib.to_tensor(XS), lib.to_tensor(YS)
    opt = lib.optimizer.LBFGS(learning_rate=1.0, max_iter=6,
                              history_size=4, line_search_fn=line_search,
                              parameters=layer.parameters())

    def closure():
        opt.clear_grad()
        loss = ((layer(x) - y) ** 2).mean()
        loss.backward()
        return loss

    return [opt.step(closure) for _ in range(steps)]


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_closure_matches_reference(line_search):
    P.seed(3)
    jl = P.nn.Linear(6, 2)
    tl = paddle.nn.Linear(6, 2)
    tl.set_state_dict({k: np.asarray(v.value)
                       for k, v in jl.state_dict().items()})
    jloss = _lbfgs_run(P, jl, line_search, 3)
    tloss = _lbfgs_run(paddle, tl, line_search, 3)
    # the losses within 1e-6 of the problem's scale (the loss at zero
    # weights): near the optimum they are the squares of residuals that
    # cancel to ~1e-7 of the targets
    scale = float(np.mean(YS.astype(np.float64) ** 2))
    assert np.max(np.abs(np.subtract(tloss, jloss))) <= PARAM_TOL * scale
    assert tloss[-1] < tloss[0]
    jstate = jl.state_dict()
    for k, v in tl.state_dict().items():
        w = np.asarray(jstate[k].value)
        assert np.max(np.abs(as_np(v) - w)) <= PARAM_TOL * max(
            1.0, np.max(np.abs(w))), k


def test_lbfgs_refuses_what_the_reference_refuses():
    p = [paddle.Parameter(torch.zeros(3))]
    with pytest.raises(ValueError, match="weight_decay"):
        paddle.optimizer.LBFGS(parameters=p, weight_decay=0.1)
    with pytest.raises(ValueError, match="grad_clip"):
        paddle.optimizer.LBFGS(parameters=p,
                               grad_clip=paddle.nn.ClipGradByNorm(1.0))
    with pytest.raises(ValueError, match="closure"):
        paddle.optimizer.LBFGS(parameters=p).step()
