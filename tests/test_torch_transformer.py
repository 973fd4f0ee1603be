"""The port's transformer layers (``nn.MultiHeadAttention``, the encoder
and decoder layers and stacks, ``nn.Transformer``) against the JAX
package's, on the CPU, at 2 + 2 layers, d_model 32, 4 heads. Layers
built after the same ``seed`` hold the JAX package's initial weights bit
for bit under the same ``state_dict`` keys; with the JAX weights, outputs
agree to 1e-5 of the reference's largest magnitude and gradients (inputs
and every parameter) to 1e-4, with a source padding mask (additive) and
the causal ``generate_square_subsequent_mask``, post- and pre-norm.
Incremental decoding through ``Cache`` (self-attention) and
``StaticCache`` (cross-attention) equals the full forward, and the JAX
package's incremental decoding. One training step with dropout on draws
the same masks (one ``seed``): loss within 1e-5, gradients within 1e-4.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as paddle
from test_torch_nn_layer import _jstate, _rel
from test_torch_rnn import _build
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
D, NH, FF, B, S, ST = 32, 4, 64, 2, 7, 5


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


R = np.random.RandomState(0)
SRC = R.randn(B, S, D).astype(np.float32)
TGT = R.randn(B, ST, D).astype(np.float32)
LENS = np.array([S, 4])
PAD = np.where(np.arange(S)[None, :] < LENS[:, None], 0.0, -1e9) \
    .astype(np.float32)[:, None, None, :]            # [B, 1, 1, S]


def _masks(lib):
    return (lib.to_tensor(PAD),
            lib.nn.Transformer.generate_square_subsequent_mask(ST))


def _param_grads(jl, tl):
    """Every parameter's gradient within 1e-4 of its largest magnitude.
    ``k_proj.bias``'s is zero in exact arithmetic (it shifts all of a
    query's scores alike, which the softmax cancels): there both sides
    are rounding noise, held below 1e-5 of the model's largest gradient."""
    jp = dict(jl.named_parameters())
    top = max(float(np.max(np.abs(as_np(p.grad))))
              for p in tl.parameters())
    for name, p in tl.named_parameters():
        if name.endswith("k_proj.bias"):
            assert float(np.max(np.abs(as_np(p.grad)))) <= 1e-5 * top
            continue
        assert _rel(p.grad, jp[name].grad) <= GRAD_TOL, name


def _grads(jl, tl, jins, tins, jo, to):
    r = np.random.RandomState(5)
    c = r.randn(*tuple(to.shape)).astype(np.float32)
    (jo * P.to_tensor(c)).sum().backward()
    (to * paddle.to_tensor(c)).sum().backward()
    for j, t in zip(jins, tins):
        assert _rel(t.grad, j.grad) <= GRAD_TOL
    _param_grads(jl, tl)


def _inputs(arrays):
    return ([P.to_tensor(a, stop_gradient=False) for a in arrays],
            [paddle.to_tensor(a, stop_gradient=False) for a in arrays])


def test_square_subsequent_mask():
    got = paddle.nn.Transformer.generate_square_subsequent_mask(ST)
    want = P.nn.Transformer.generate_square_subsequent_mask(ST)
    np.testing.assert_array_equal(as_np(got), as_np(want))
    assert got.dtype == paddle.float32


@pytest.mark.parametrize("kdim", [None, 24])
def test_multi_head_attention(kdim):
    jl, tl = _build(lambda nn: nn.MultiHeadAttention(D, NH, kdim=kdim,
                                                     vdim=kdim))
    tl.set_state_dict(_jstate(jl))
    kv = R.randn(B, S, kdim or D).astype(np.float32)
    (jq, jk), (tq, tk) = _inputs([TGT, kv])
    mask = np.where(R.rand(B, NH, ST, S) > 0.3, 0.0, -1e9).astype(np.float32)
    jo = jl(jq, jk, jk, P.to_tensor(mask))
    to = tl(tq, tk, tk, paddle.to_tensor(mask))
    assert _rel(to, jo) <= FWD_TOL
    _grads(jl, tl, [jq, jk], [tq, tk], jo, to)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder(normalize_before):
    jl, tl = _build(lambda nn: nn.TransformerEncoder(
        nn.TransformerEncoderLayer(D, NH, FF, dropout=0.0,
                                   normalize_before=normalize_before),
        2, nn.LayerNorm(D) if normalize_before else None))
    tl.set_state_dict(_jstate(jl))
    (jx,), (tx,) = _inputs([SRC])
    jo, to = jl(jx, _masks(P)[0]), tl(tx, _masks(paddle)[0])
    assert _rel(to, jo) <= FWD_TOL
    _grads(jl, tl, [jx], [tx], jo, to)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder(normalize_before):
    jl, tl = _build(lambda nn: nn.TransformerDecoder(
        nn.TransformerDecoderLayer(D, NH, FF, dropout=0.0,
                                   activation="gelu",
                                   normalize_before=normalize_before),
        2, nn.LayerNorm(D) if normalize_before else None))
    tl.set_state_dict(_jstate(jl))
    (jt, jm), (tt, tm) = _inputs([TGT, SRC])
    jpad, jcausal = _masks(P)
    tpad, tcausal = _masks(paddle)
    jo = jl(jt, jm, jcausal, jpad)
    to = tl(tt, tm, tcausal, tpad)
    assert _rel(to, jo) <= FWD_TOL
    _grads(jl, tl, [jt, jm], [tt, tm], jo, to)


def _transformer(nn, normalize_before, dropout=0.0):
    return nn.Transformer(D, NH, 2, 2, FF, dropout=dropout,
                          normalize_before=normalize_before)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer(normalize_before):
    jl, tl = _build(lambda nn: _transformer(nn, normalize_before))
    tl.set_state_dict(_jstate(jl))
    (js, jt), (ts, tt) = _inputs([SRC, TGT])
    jpad, jcausal = _masks(P)
    tpad, tcausal = _masks(paddle)
    jo = jl(js, jt, jpad, jcausal, jpad)
    to = tl(ts, tt, tpad, tcausal, tpad)
    assert _rel(to, jo) <= FWD_TOL
    _grads(jl, tl, [js, jt], [ts, tt], jo, to)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_incremental_decoding_equals_the_full_forward(normalize_before):
    """Decoding one target position a step through ``Cache`` (the
    self-attention's growing keys) and ``StaticCache`` (the memory's
    projected keys, from ``gen_cache``) gives the full causal forward's
    rows, and the JAX package's incremental outputs."""
    jl, tl = _build(lambda nn: _transformer(nn, normalize_before))
    tl.set_state_dict(_jstate(jl))
    for m in (jl, tl):
        m.eval()
    outs = {}
    for lib, layer in ((P, jl), (paddle, tl)):
        src, tgt = lib.to_tensor(SRC), lib.to_tensor(TGT)
        pad, causal = _masks(lib)
        memory = layer.encoder(src, pad)
        full = layer.decoder(tgt, memory, causal, pad)
        cache = layer.decoder.gen_cache(memory)
        steps = []
        for t in range(ST):
            out, cache = layer.decoder(tgt[:, t:t + 1], memory, None, pad,
                                       cache)
            steps.append(as_np(out))
        outs[lib.__name__] = (as_np(full), np.concatenate(steps, axis=1))
    tfull, tinc = outs[paddle.__name__]
    jfull, jinc = outs[P.__name__]
    assert _rel(tinc, tfull) <= FWD_TOL
    assert _rel(tinc, jinc) <= FWD_TOL
    assert _rel(tfull, jfull) <= FWD_TOL


def test_training_step_with_dropout():
    """Dropout 0.1 everywhere (attention, activation, residual): the same
    seed gives the same masks, so one step's loss and gradients agree."""
    jl, tl = _build(lambda nn: _transformer(nn, False, dropout=0.1))
    tl.set_state_dict(_jstate(jl))
    for m in (jl, tl):
        m.train()
    labels = R.randint(0, D, (B, ST))
    losses = {}
    for lib, layer in ((P, jl), (paddle, tl)):
        lib.seed(13)
        src, tgt = lib.to_tensor(SRC), lib.to_tensor(TGT)
        pad, causal = _masks(lib)
        out = layer(src, tgt, pad, causal, pad)
        soft = lib.nn.functional.label_smooth(lib.nn.functional.one_hot(
            lib.to_tensor(labels), D), epsilon=0.1)
        loss = lib.nn.functional.cross_entropy(out, soft, soft_label=True)
        loss.backward()
        losses[lib.__name__] = loss
    assert _rel(losses[paddle.__name__], losses[P.__name__]) <= FWD_TOL
    _param_grads(jl, tl)
