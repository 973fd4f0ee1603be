"""ERNIE and ERNIE-ViL on the port (``paddle_tpu_torch.models.ernie``,
``ernie_vil``) against the JAX package's ``models/ernie.py`` and
``ernie_vil.py``, on the CPU, at ``ernie_tiny`` and ``ernie_vil_tiny``:

- built after the same ``seed``, the state dicts have the JAX keys in the
  JAX order (ERNIE's re-registered norms last in each layer) and the
  JAX initial weights: bit for bit where the draw is uniform (Xavier) or
  constant, within 1e-5 relative where it is normal (the embeddings, the
  class token and positions: ``torch.erfinv`` and XLA's differ in the
  last place, as for every normal initializer since the substrate);
- with the JAX weights, logits and losses (masked LM with
  ``ignore_index=-100`` and a padding mask, classification, the CLIP
  loss) within 1e-5 of the reference's largest magnitude, every
  gradient within 1e-4 of its own (``k_proj.bias``'s, zero in exact
  arithmetic, held as noise), dropout on (one seed, the same masks) and
  off; ``num_params`` (the 0-d ``logit_scale`` counted as 1)
  equal;
- three AdamW steps track the JAX package's: losses within 1e-5
  relative, the weights after them within 1e-3 of each tensor's largest
  entry (Adam scales each gradient entry by its own size, so entries
  near rounding level move by a part of the rate on either side;
  ``k_proj.bias``, moved by noise alone, within Adam's steps);
- the padding mask blocks padded keys: other token ids there leave the
  unpadded positions' outputs unchanged.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu.models import ernie as jernie
from paddle_tpu.models import ernie_vil as jvil
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.models import ernie_vil as tvil
from test_torch_nn_layer import _jstate, _rel
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401

FWD_TOL, GRAD_TOL, NORMAL_RTOL, STEP_TOL = 1e-5, 1e-4, 1e-5, 1e-5
#: AdamW's rate, and its weights after 3 steps against the reference's,
#: over each tensor's largest entry: Adam divides each gradient entry by
#: its own root mean square, so an entry whose gradient is near rounding
#: level moves by a good part of LR on either implementation
LR, ADAM_WEIGHT_TOL = 1e-3, 1e-3
#: the parameters drawn from a normal distribution
NORMAL = ("embeddings.weight", "embed.weight", "cls_token", "pos_embed")
B, S = 3, 12
R = np.random.RandomState(0)
IDS = R.randint(1, 256, (B, S))
TYPES = R.randint(0, 2, (B, S))
MASK = (np.arange(S)[None, :] < np.array([S, 9, 5])[:, None]).astype(
    np.int64)
LABELS = np.where(R.rand(B, S) < 0.4, R.randint(0, 256, (B, S)), -100)
CLASSES = np.array([1, 0, 1])
PIXELS = R.randn(4, 3, 32, 32).astype(np.float32)
TEXT = R.randint(0, 128, (4, 16))


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


MODELS = {
    "ernie": lambda m, **kw: m.ErnieModel(m.ernie_tiny(**kw)),
    "masked_lm": lambda m, **kw: m.ErnieForMaskedLM(m.ernie_tiny(**kw)),
    "classify": lambda m, **kw: m.ErnieForSequenceClassification(
        m.ernie_tiny(**kw), num_classes=2),
}


def _pair(name, seed=0, **kw):
    """The JAX and the port's model after one ``seed``; the initial
    weights checked, then the JAX weights loaded into the port's."""
    if name == "ernie_vil":
        make = (lambda m: m.ErnieViLModel(m.ernie_vil_tiny(**kw)))
        mods = (jvil, tvil)
    else:
        make = (lambda m: MODELS[name](m, **kw))
        mods = (jernie, ternie)
    P.seed(seed)
    jm = make(mods[0])
    paddle.seed(seed)
    tm = make(mods[1])
    js, ts = _jstate(jm), tm.state_dict()
    assert list(js) == list(ts)
    for k in js:
        got = as_np(ts[k])
        if k.endswith(NORMAL):
            assert _rel(got, js[k]) <= NORMAL_RTOL, k
        else:
            np.testing.assert_array_equal(got, js[k], err_msg=k)
    assert tm.set_state_dict(js) == ([], [])
    if hasattr(jm, "num_params"):
        assert tm.num_params() == jm.num_params()
    return jm, tm


def _param_grads(jm, tm):
    """Every gradient within GRAD_TOL of its largest entry. ``k_proj.bias``'s
    is zero in exact arithmetic (it shifts all of a query's scores alike,
    which the softmax cancels): both sides are rounding noise there, held
    below 1e-5 of the model's largest gradient (as the transformer
    layers' tests hold it)."""
    jp = dict(jm.named_parameters())
    top = max(float(np.max(np.abs(as_np(p.grad))))
              for p in tm.parameters() if p.grad is not None)
    for name, p in tm.named_parameters():
        assert (p.grad is None) == (jp[name].grad is None), name
        if p.grad is None:
            continue
        if name.endswith("k_proj.bias"):
            assert float(np.max(np.abs(as_np(p.grad)))) <= 1e-5 * top
            continue
        assert _rel(p.grad, jp[name].grad) <= GRAD_TOL, name


def _loss_pair(jm, tm, run, seed=5):
    for m in (jm, tm):
        m.train()
    P.seed(seed)
    jl = run(P, jm)
    paddle.seed(seed)
    tl = run(paddle, tm)
    assert _rel(tl, jl) <= FWD_TOL
    jl.backward()
    tl.backward()
    _param_grads(jm, tm)


@pytest.mark.parametrize("name", ["ernie", "masked_lm", "classify",
                                  "ernie_vil"])
def test_initial_weights(name):
    _pair(name, seed=17)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_ernie_outputs_and_gradients(dropout):
    jm, tm = _pair("ernie", hidden_dropout_prob=dropout,
                   attention_probs_dropout_prob=dropout)

    def run(lib, m):
        seq, pooled = m(lib.to_tensor(IDS), lib.to_tensor(TYPES),
                        attention_mask=lib.to_tensor(MASK))
        c1 = np.random.RandomState(1).randn(B, S, 64).astype(np.float32)
        c2 = np.random.RandomState(2).randn(B, 64).astype(np.float32)
        return (seq * lib.to_tensor(c1)).sum() \
            + (pooled * lib.to_tensor(c2)).sum()
    _loss_pair(jm, tm, run)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_masked_lm(dropout):
    jm, tm = _pair("masked_lm", hidden_dropout_prob=dropout,
                   attention_probs_dropout_prob=dropout)
    for m in (jm, tm):
        m.eval()
    jlog = jm(P.to_tensor(IDS), attention_mask=P.to_tensor(MASK))
    tlog = tm(paddle.to_tensor(IDS), attention_mask=paddle.to_tensor(MASK))
    assert _rel(tlog, jlog) <= FWD_TOL
    _loss_pair(jm, tm, lambda lib, m: m(
        lib.to_tensor(IDS), lib.to_tensor(TYPES),
        attention_mask=lib.to_tensor(MASK), labels=lib.to_tensor(LABELS)))


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_sequence_classification(dropout):
    jm, tm = _pair("classify", hidden_dropout_prob=dropout,
                   attention_probs_dropout_prob=dropout)
    for m in (jm, tm):
        m.eval()
    assert _rel(tm(paddle.to_tensor(IDS)), jm(P.to_tensor(IDS))) <= FWD_TOL
    _loss_pair(jm, tm, lambda lib, m: m(
        lib.to_tensor(IDS), attention_mask=lib.to_tensor(MASK),
        labels=lib.to_tensor(CLASSES)))


def test_ernie_vil():
    jm, tm = _pair("ernie_vil")
    ji, jt = jm(P.to_tensor(PIXELS), P.to_tensor(TEXT), return_loss=False)
    ti, tt = tm(paddle.to_tensor(PIXELS), paddle.to_tensor(TEXT),
                return_loss=False)
    assert _rel(ti, ji) <= FWD_TOL and _rel(tt, jt) <= FWD_TOL
    assert tuple(tm.logit_scale.shape) == ()
    _loss_pair(jm, tm, lambda lib, m: m(lib.to_tensor(PIXELS),
                                        lib.to_tensor(TEXT)))


@pytest.mark.parametrize("name", ["classify", "ernie_vil"])
def test_adamw_steps(name):
    jm, tm = _pair(name, seed=3)
    jo = P.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters(),
                           weight_decay=0.01)
    to = paddle.optimizer.AdamW(learning_rate=LR,
                                parameters=tm.parameters(),
                                weight_decay=0.01)
    if name == "classify":
        def run(lib, m):
            return m(lib.to_tensor(IDS), attention_mask=lib.to_tensor(MASK),
                     labels=lib.to_tensor(CLASSES))
    else:
        def run(lib, m):
            return m(lib.to_tensor(PIXELS), lib.to_tensor(TEXT))
    for _ in range(3):
        jl, tl = run(P, jm), run(paddle, tm)
        assert abs(float(tl.detach()) - float(jl.numpy())) <= \
            STEP_TOL * abs(float(jl.numpy()))
        jl.backward()
        tl.backward()
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    js = _jstate(jm)
    for k, v in tm.state_dict().items():
        if k.endswith("k_proj.bias"):
            # Adam scales its noise gradient to steps of about lr: both
            # sides moved by noise alone, which the softmax cancels
            assert float(np.max(np.abs(as_np(v)))) <= 3 * 3 * LR, k
            continue
        assert _rel(v, js[k]) <= ADAM_WEIGHT_TOL, k


def test_padding_mask_blocks_padded_keys():
    paddle.seed(0)
    tm = ternie.ErnieModel(ternie.ernie_tiny())
    tm.eval()
    other = IDS.copy()
    other[MASK == 0] = (other[MASK == 0] + 7) % 256
    outs = [tm(paddle.to_tensor(ids), attention_mask=paddle.to_tensor(MASK))
            for ids in (IDS, other)]
    (s0, p0), (s1, p1) = [(as_np(s), as_np(p)) for s, p in outs]
    keep = MASK.astype(bool)
    np.testing.assert_allclose(s1[keep], s0[keep], rtol=0, atol=1e-6)
    np.testing.assert_allclose(p1, p0, rtol=0, atol=1e-6)
    # and the padded keys did take part without the mask
    free = as_np(tm(paddle.to_tensor(other))[0])
    assert not np.allclose(free[keep], s0[keep], atol=1e-3)
