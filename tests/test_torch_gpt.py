"""GPT on the port's substrate (``paddle_tpu_torch.models.gpt``) against
the JAX package's ``models/gpt.py``, on the CPU, at ``gpt_tiny``:

- the state dict's keys and order equal the reference's, with and without
  the tensor-parallel layers (which on one device compute what the plain
  layers do: one variant's weights load into the other);
- with the JAX model's weights carried by ``set_state_dict`` (numpy
  arrays under the JAX keys), the loss agrees to 1e-5 relative and every
  parameter's gradient to 1e-4 of its largest magnitude — also with
  dropout on, the masks drawn after the same ``seed``;
- a seeded model's Xavier-uniform weights are the reference's bit for
  bit;
- ``TrainStep`` takes the port's ``Layer`` model;
- a run saved after step 3 (model, optimizer with its scheduler, the
  scaler, the RNG key) and loaded into a fresh model and optimizer gives
  steps 4–6 the same losses bit for bit as the uninterrupted run, in
  float32 and under ``auto_cast`` O1 bfloat16.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.models.gpt import gpt_tiny as j_tiny
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


def _ids(B=2, S=16, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (B, S))


def _jstate(m):
    return {k: np.asarray(v.value) for k, v in m.state_dict().items()}


@pytest.mark.parametrize("mp", [True, False])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_loss_and_gradients_match_reference(mp, dropout):
    kw = dict(use_mp_layers=mp, hidden_dropout_prob=dropout,
              attention_probs_dropout_prob=dropout)
    P.seed(3)
    jm = JGPT(j_tiny(**kw))
    paddle.seed(3)
    tm = GPTForCausalLM(gpt_tiny(**kw))
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert tm.set_state_dict(_jstate(jm)) == ([], [])
    ids = _ids()
    P.seed(11)
    jl = jm(P.to_tensor(ids), P.to_tensor(ids))
    paddle.seed(11)
    tl = tm(paddle.to_tensor(ids), paddle.to_tensor(ids))
    assert abs(tl.item() - float(jl.numpy())) <= \
        LOSS_RTOL * abs(float(jl.numpy()))
    jl.backward()
    tl.backward()
    jg = {n: np.asarray(p.grad.value) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        err = np.max(np.abs(as_np(p.grad) - jg[n]))
        assert err <= GRAD_TOL * max(np.max(np.abs(jg[n])), 1e-30), n
    assert tm.num_params() == jm.num_params()


def test_xavier_weights_bit_for_bit_and_variants_interchange():
    P.seed(21)
    jm = JGPT(j_tiny(use_mp_layers=False))
    paddle.seed(21)
    tm = GPTForCausalLM(gpt_tiny(use_mp_layers=False))
    js = _jstate(jm)
    for k, v in tm.state_dict().items():
        if k.endswith("qkv.weight") or k.endswith("fc_in.weight"):
            np.testing.assert_array_equal(as_np(v), js[k])
    mp = GPTForCausalLM(gpt_tiny(use_mp_layers=True))
    assert mp.set_state_dict(tm.state_dict()) == ([], [])
    tm.eval()
    mp.eval()
    ids = paddle.to_tensor(_ids(seed=2))
    assert torch.equal(tm(ids, ids), mp(ids, ids))


def test_mp_degree_above_one_raises():
    from paddle_tpu_torch.parallel.fleet.mp import ColumnParallelLinear

    class Group:
        nranks = 2
    with pytest.raises(NotImplementedError, match="Queue A step 13"):
        ColumnParallelLinear(8, 8, mp_group=Group())


def test_train_step_takes_a_layer():
    from paddle_tpu_torch.jit import TrainStep
    paddle.seed(0)
    m = GPTForCausalLM(gpt_tiny())
    opt = paddle.optimizer.AdamW(learning_rate=3e-3,
                                 parameters=m.parameters(),
                                 grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    step = TrainStep(m, lambda loss, _lab: loss, opt, donate=False,
                     loss_scale=1.0)
    ids = paddle.to_tensor(_ids(4, 16, 5))
    losses = [float(step.step((ids, ids), (ids,))) for _ in range(4)]
    assert losses[-1] < losses[0]


def _trainer(seed):
    paddle.seed(seed)
    m = GPTForCausalLM(gpt_tiny(hidden_dropout_prob=0.1,
                                attention_probs_dropout_prob=0.1))
    sched = paddle.optimizer.lr.LinearWarmup(
        paddle.optimizer.lr.CosineAnnealingDecay(3e-3, 20), 10, 1e-4, 3e-3)
    opt = paddle.optimizer.AdamW(
        learning_rate=sched, parameters=m.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0),
        apply_decay_param_fun=lambda n: True)
    return m, opt, sched, paddle.amp.GradScaler(init_loss_scaling=1024.0)


def _step(m, opt, sched, scaler, ids, amp):
    with paddle.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
        loss = m(ids, ids)
    scaler.scale(loss).backward()
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    sched.step()
    return loss.item()


@pytest.mark.parametrize("amp", [False, True])
def test_save_load_resume_bit_for_bit(amp, tmp_path):
    ids = paddle.to_tensor(_ids(4, 16, 9))
    m, opt, sched, scaler = _trainer(5)
    straight = []
    for i in range(6):
        straight.append(_step(m, opt, sched, scaler, ids, amp))
        if i == 2:
            paddle.save(m.state_dict(), str(tmp_path / "m.pdparams"))
            paddle.save(opt.state_dict(), str(tmp_path / "o.pdopt"))
            paddle.save({"rng": paddle.get_rng_state(),
                         "scaler": scaler.state_dict()},
                        str(tmp_path / "extra.pd"))
    m2, opt2, sched2, scaler2 = _trainer(123)
    m2.set_state_dict(paddle.load(str(tmp_path / "m.pdparams")))
    opt2.set_state_dict(paddle.load(str(tmp_path / "o.pdopt")))
    extra = paddle.load(str(tmp_path / "extra.pd"))
    paddle.set_rng_state(extra["rng"])
    scaler2.load_state_dict(extra["scaler"])
    resumed = [_step(m2, opt2, sched2, scaler2, ids, amp) for _ in range(3)]
    assert resumed == straight[3:]
    assert straight[-1] < straight[0]
    arrays = paddle.load(str(tmp_path / "m.pdparams"), return_numpy=True)
    assert isinstance(arrays["gpt.wte.weight"], np.ndarray)
