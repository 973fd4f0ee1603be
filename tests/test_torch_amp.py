"""The port's AMP against the JAX package's, on the CPU: under
``auto_cast`` at O1 and O2 in bfloat16, and at O2 in float16 (the
GPT-3 fp16 leg's level), every op of the four
core op modules and of the ported ``nn.functional`` gives an output of the
JAX package's type, op by op (both cast an op's floating inputs by its
dispatch name before it runs, from the same white and black lists); the
values agree within the AMP type's rounding (2 ulps of bfloat16 of the
reference's largest magnitude; the linear-algebra ops' 16-bit results
are compared by type only: where torch's CPU solver has no 16-bit kernel
the port solves in float32 and rounds). ``decorate(level="O2")`` casts the
parameters and the optimizer keeps float32 masters; ``GradScaler``'s
schedule over a run with an injected infinite gradient — its scale, the
skipped update, the good/bad step counts and the parameters — equals the
reference's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as TF
from test_torch_ops import (CREATION, DISTRIBUTION, LINALG, MANIP, MATH,
                            RANDOM, _public, as_np, jax_call, leaves, to_j,
                            to_t)
from torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.RandomState(4)
XF = RNG.randn(4, 6).astype(np.float32)
LAB = np.array([1, 0, 5, -100])
FUNCTIONAL = {
    "linear": ((XF, RNG.randn(6, 3).astype(np.float32),
                RNG.randn(3).astype(np.float32)), {}),
    "layer_norm": ((XF, 6, np.ones(6, np.float32),
                    np.zeros(6, np.float32)), {}),
    "rms_norm": ((XF, np.ones(6, np.float32)), {}),
    "softmax": ((XF,), {}), "log_softmax": ((XF,), {}),
    "gelu": ((XF,), {}), "relu": ((XF,), {}), "silu": ((XF,), {}),
    "cross_entropy": ((XF, LAB), {}), "nll_loss": ((XF, LAB), {}),
    "mse_loss": ((XF, XF[::-1].copy()), {}),
    "binary_cross_entropy_with_logits": ((XF, (XF > 0).astype(
        np.float32)), {}),
    "kl_div": ((XF, np.abs(XF)), {}),
    "embedding": ((np.array([[0, 2], [1, 3]]), XF), {}),
    "scaled_dot_product_attention": ((RNG.randn(1, 5, 2, 4).astype(
        np.float32),) * 3, {"is_causal": True}),
    "flash_attention": ((RNG.randn(1, 5, 2, 4).astype(np.float32),) * 3,
                        {"causal": True}),
    "dropout": ((XF,), {"p": 0.5, "training": False,
                        "mode": "downscale_in_infer"}),
}

SKIP = set(DISTRIBUTION) | {"to_tensor"}


def _cases():
    out = []
    for mod, table in (("creation", CREATION), ("math", MATH),
                       ("manipulation", MANIP), ("linalg", LINALG)):
        out += [(mod, n) for n in _public(mod) if n not in SKIP]
    return out + [("functional", n) for n in FUNCTIONAL]


def _fns(mod, name):
    import importlib
    if mod == "functional":
        return getattr(JF, name), getattr(TF, name), FUNCTIONAL[name]
    table = {"creation": CREATION, "math": MATH, "manipulation": MANIP,
             "linalg": LINALG}[mod]
    jm = importlib.import_module(f"paddle_tpu.ops.{mod}")
    tm = importlib.import_module(f"paddle_tpu_torch.ops.{mod}")
    return getattr(jm, name), getattr(tm, name), table[name]


def _types(outs):
    return [str(as_np(o).dtype) if not isinstance(o, torch.Tensor)
            else str(o.dtype).split(".")[-1] for o in leaves(outs)
            if o is not None]


@pytest.mark.parametrize("level,dtype", [("O1", "bfloat16"),
                                         ("O2", "bfloat16"),
                                         ("O2", "float16")])
def test_output_types_match_reference_op_by_op(level, dtype):
    paddle.set_device("cpu")
    checked, differ = 0, []
    for mod, name in _cases():
        fj, ft, (args, kw) = _fns(mod, name)
        try:
            with P.amp.auto_cast(level=level, dtype=dtype):
                P.seed(1)
                want = fj(*to_j(args), **kw) if name in RANDOM \
                    else jax_call(fj, args, kw)
        except Exception:       # the reference does not run this op here
            continue
        with paddle.amp.auto_cast(level=level, dtype=dtype):
            paddle.seed(1)
            got = ft(*to_t(args), **kw)
        wt = [t.replace("bool_", "bool") for t in _types(want)]
        gt = _types(got)
        ints = ("int32", "int64")
        same = len(wt) == len(gt) and all(
            a == b or (a in ints and b in ints) for a, b in zip(gt, wt))
        if not same:
            differ.append((mod, name, gt, wt))
            continue
        for g, w in zip(leaves(got), leaves(want)):
            if g is None:
                continue
            g, w = as_np(g), as_np(w)
            if mod != "linalg" and w.dtype.kind == "f" and w.size \
                    and np.all(np.isfinite(w)) and w.dtype.itemsize == 2:
                err = np.max(np.abs(g.astype(np.float64)
                                    - w.astype(np.float64)))
                assert err <= 2 ** -6 * max(np.max(np.abs(
                    w.astype(np.float64))), 1.0), (name, err)
        checked += 1
    assert not differ, differ
    assert checked > 150


def test_decorate_o2_and_masters():
    paddle.set_device("cpu")
    paddle.seed(0)
    m = paddle.nn.Linear(4, 3)
    opt = paddle.optimizer.AdamW(learning_rate=0.1, parameters=m.parameters())
    m2 = paddle.amp.decorate(m, level="O2", dtype="float16")
    assert m2 is m and m.weight.dtype == torch.float16
    m.weight.grad = torch.ones_like(m.weight)
    opt.step()
    assert opt._slots[id(m.weight)]["master"].dtype == torch.float32
    assert paddle.amp.is_bfloat16_supported() and \
        paddle.amp.is_float16_supported()


def _scaler_run(framework):
    """Six steps of a one-weight model under ``GradScaler(init 1024,
    incr every 2, decr every 1)``; at step 3 the loss is infinite."""
    fw = P if framework == "jax" else paddle
    if framework == "torch":
        fw.set_device("cpu")
    w0 = np.array([[0.5, -1.0], [2.0, 0.25]], np.float32)
    if framework == "jax":
        from paddle_tpu.core.tensor import Parameter
        p = Parameter(P.to_tensor(w0).value)
    else:
        p = paddle.Parameter(torch.from_numpy(w0.copy()))
    opt = fw.optimizer.SGD(learning_rate=0.1, parameters=[p])
    scaler = fw.amp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2,
                               decr_every_n_nan_or_inf=1)
    x = fw.to_tensor(np.array([[1.0, 2.0]], np.float32))
    trace = []
    for step in range(6):
        loss = (fw.matmul(x, p) ** 2).sum()
        if step == 3:
            loss = loss * float("inf")
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        st = scaler.state_dict()
        trace.append((st["scale"], st["good_steps"], st["bad_steps"],
                      as_np(p.value if framework == "jax" else p).copy()))
    return trace, scaler


def test_grad_scaler_schedule_matches_reference():
    jt, _ = _scaler_run("jax")
    tt, scaler = _scaler_run("torch")
    for (js, jg, jb, jw), (ts, tg, tb, tw) in zip(jt, tt):
        assert (ts, tg, tb) == (js, jg, jb)
        np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=0)
    assert [s for s, *_ in tt] == [1024.0, 2048.0, 2048.0, 1024.0, 1024.0,
                                   2048.0]
    assert scaler.skipped_steps == 1
    fresh = paddle.amp.GradScaler()
    fresh.load_state_dict(scaler.state_dict())
    assert fresh.state_dict() == scaler.state_dict()
    off = paddle.amp.GradScaler(enable=False)
    loss = torch.tensor(2.0)
    assert off.scale(loss) is loss
