"""The port's fused layers (``incubate.nn``: ``FusedMultiHeadAttention``,
``FusedFeedForward``, ``FusedMultiTransformer``) against the JAX
package's, on the CPU. Built after the same ``seed`` they hold the JAX
layers' initial weights bit for bit under the same state-dict keys
(Xavier-uniform on the 3-D and 4-D stacks: the same fan rule). With the
JAX weights, outputs agree to 1e-5 of the reference's largest magnitude
and gradients to 1e-4, pre- and post-norm, with dropout on (one seed,
the same masks) and off.

``FusedMultiTransformer`` at E 32, 4 heads, 3 layers, MHA and GQA
(``kv_num_heads=2``): a prefill at ``time_step=0`` then one-token decode
steps equals the full causal forward, and the JAX stack's
prefill-then-decode, whose single-token steps run
``decode_attention_pallas`` in interpret mode (its CPU setting); the
caches the two return agree within 1e-5, and the port's is the caller's
tensor, written in place. ``decode_attention="pallas"`` (the dense
decode kernel's wrapper, its plain version on CPU tensors, counted as no
launch) and ``"jnp"`` agree (layer 0's cache rows bit for bit); a
backward through the decode raises, as the reference's; the
masked-softmax path is differentiable, cache or not.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu_torch import kernels
from test_torch_nn_layer import _jstate, _rel
from test_torch_ops import as_np
from torch_threads import one_torch_thread  # noqa: F401

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
E, NH, FF, L = 32, 4, 64, 3
B, S, NEW, S_MAX = 2, 5, 3, 12


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


def _r(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _build(make, seed=0):
    """Both layers after one ``seed``: keys and weights bit for bit; the
    port's layer then holds the JAX weights (as it already does)."""
    P.seed(seed)
    jl = make(P.incubate.nn)
    paddle.seed(seed)
    tl = make(paddle.incubate.nn)
    js, ts = _jstate(jl), tl.state_dict()
    assert list(js) == list(ts)
    for k in js:
        np.testing.assert_array_equal(as_np(ts[k]), js[k], err_msg=k)
    missing, unexpected = tl.set_state_dict(js)
    assert not missing and not unexpected
    return jl, tl


def _grads(jl, tl, jx, tx, jo, to):
    c = _r(50, *tuple(jo.shape))
    (jo * P.to_tensor(c)).sum().backward()
    (to * paddle.to_tensor(c)).sum().backward()
    assert _rel(tx.grad, jx.grad) <= GRAD_TOL
    jp = dict(jl.named_parameters())
    for name, p in tl.named_parameters():
        if jp[name].grad is None:
            assert p.grad is None or not p.grad.abs().sum(), name
            continue
        assert _rel(p.grad, jp[name].grad) <= GRAD_TOL, name


def _clear(jl, tl):
    for p in jl.parameters():
        p.clear_grad()
    for p in tl.parameters():
        p.grad = None


def _x(seed=1, s=S):
    x = _r(seed, B, s, E)
    return (P.to_tensor(x, stop_gradient=False),
            paddle.to_tensor(x, stop_gradient=False))


def _pad_mask(lib):
    lens = np.array([S, 3])
    m = np.where(np.arange(S)[None, :] < lens[:, None], 0.0, -1e9)
    return lib.to_tensor(m.astype(np.float32)[:, None, None, :])


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_fused_multi_head_attention(normalize_before, training):
    jl, tl = _build(lambda nn: nn.FusedMultiHeadAttention(
        E, NH, dropout_rate=0.5, attn_dropout_rate=0.5,
        normalize_before=normalize_before))
    for m in (jl, tl):
        m.train() if training else m.eval()
    jx, tx = _x()
    P.seed(3)
    jo = jl(jx, _pad_mask(P))
    paddle.seed(3)
    to = tl(tx, _pad_mask(paddle))
    assert _rel(to, jo) <= FWD_TOL
    _grads(jl, tl, jx, tx, jo, to)


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_fused_feed_forward(normalize_before, activation):
    jl, tl = _build(lambda nn: nn.FusedFeedForward(
        E, FF, dropout_rate=0.5, activation=activation,
        normalize_before=normalize_before))
    jx, tx = _x()
    P.seed(4)
    jo = jl(jx)
    paddle.seed(4)
    to = tl(tx)
    assert _rel(to, jo) <= FWD_TOL
    _grads(jl, tl, jx, tx, jo, to)


def _stack(kv=None, activation="gelu", decode="pallas", seed=0):
    return _build(lambda nn: nn.FusedMultiTransformer(
        E, NH, FF, activation=activation, num_layers=L, kv_num_heads=kv,
        decode_attention=decode), seed)


@pytest.mark.parametrize("activation", ["gelu", "relu", "silu"])
@pytest.mark.parametrize("kv", [None, 2])
def test_stack_forward_and_gradients(activation, kv):
    """The whole stack, no cache, with and without an additive mask:
    the masked softmax, GQA, the tanh-approximate gelu."""
    jl, tl = _stack(kv, activation)
    for masked in (False, True):
        jx, tx = _x()
        mask = (_pad_mask(P), _pad_mask(paddle)) if masked else (None, None)
        jo, to = jl(jx, mask[0]), tl(tx, mask[1])
        assert _rel(to, jo) <= FWD_TOL
        _grads(jl, tl, jx, tx, jo, to)
        _clear(jl, tl)


def _generate(layer, lib, x, cache):
    """Prefill rows ``[:S]`` at time_step 0, then one-token steps:
    the hidden states of every position and the last cache."""
    h, cache = layer(lib.to_tensor(x[:, :S]), caches=cache, time_step=0)
    outs = [as_np(h)]
    for t in range(S, S + NEW):
        h, cache = layer(lib.to_tensor(x[:, t:t + 1]), caches=cache,
                         time_step=t)
        outs.append(as_np(h))
    return np.concatenate(outs, axis=1), cache


@pytest.mark.parametrize("kv", [None, 2])
def test_prefill_then_decode(kv):
    jl, tl = _stack(kv)
    Hkv = kv or NH
    x = _r(7, B, S + NEW, E)
    # stale values past what the steps write
    cache0 = _r(8, L, 2, B, S_MAX, Hkv, E // NH)
    tc = paddle.to_tensor(cache0)
    kernels.reset_launches()
    with paddle.no_grad():
        th, tcache = _generate(tl, paddle, x, tc)
        full = as_np(tl(paddle.to_tensor(x)))
    # on CPU tensors the wrapper runs the plain version: no launch
    assert sum(kernels.LAUNCHES.values()) == 0
    jh, jcache = _generate(jl, P, x, P.to_tensor(cache0))
    assert tcache is tc
    assert _rel(th, jh) <= FWD_TOL
    assert _rel(th, full) <= FWD_TOL
    assert _rel(tcache, jcache) <= FWD_TOL
    n = S + NEW
    np.testing.assert_array_equal(as_np(tcache)[:, :, :, n:],
                                  cache0[:, :, :, n:])


@pytest.mark.parametrize("kv", [None, 2])
def test_pallas_and_jnp_agree(kv):
    _, tp = _stack(kv, decode="pallas")
    _, tj = _stack(kv, decode="jnp")
    x = _r(9, B, S + NEW, E)
    cache0 = np.zeros((L, 2, B, S_MAX, kv or NH, E // NH), np.float32)
    with paddle.no_grad():
        hp, cp = _generate(tp, paddle, x, paddle.to_tensor(cache0))
        hj, cj = _generate(tj, paddle, x, paddle.to_tensor(cache0))
    assert _rel(hp, hj) <= FWD_TOL
    # layer 0's rows come before any attention: the same bits; the later
    # layers' carry the two attentions' last-place differences
    np.testing.assert_array_equal(as_np(cp)[0], as_np(cj)[0])
    assert _rel(cp, cj) <= FWD_TOL


def test_decode_backward_raises():
    _, tl = _stack()
    cache = paddle.to_tensor(np.zeros((L, 2, B, S_MAX, NH, E // NH),
                                      np.float32))
    with paddle.no_grad():
        _, cache = tl(paddle.to_tensor(_r(1, B, S, E)), caches=cache,
                      time_step=0)
    x = paddle.to_tensor(_r(2, B, 1, E), stop_gradient=False)
    h, _ = tl(x, caches=cache, time_step=S)
    with pytest.raises(NotImplementedError, match="inference-only"):
        h.sum().backward()


def test_prefill_with_cache_is_differentiable():
    """The masked path through the cache: gradients of a prefill and
    of a ``jnp`` decode step track the JAX stack's."""
    jl, tl = _stack(2, decode="jnp")
    cache0 = np.zeros((L, 2, B, S_MAX, 2, E // NH), np.float32)
    jc, tc = P.to_tensor(cache0), paddle.to_tensor(cache0)
    for t, s in ((0, S), (S, 1)):
        jx, tx = _x(20 + t, s)
        jo, jc = jl(jx, caches=jc, time_step=t)
        to, tc = tl(tx, caches=tc, time_step=t)
        assert _rel(to, jo) <= FWD_TOL
        _grads(jl, tl, jx, tx, jo, to)
        jc = P.to_tensor(as_np(jc))
        _clear(jl, tl)


def test_arguments():
    with pytest.raises(ValueError):
        paddle.incubate.nn.FusedMultiTransformer(E, NH, FF, num_layers=1,
                                                 decode_attention="flash")
    with pytest.raises(ValueError):
        paddle.incubate.nn.FusedMultiTransformer(E, NH, FF, num_layers=1,
                                                 normalize_before=False)
    with pytest.raises(ValueError):
        paddle.incubate.nn.FusedMultiTransformer(E, NH, FF, num_layers=1,
                                                 kv_num_heads=3)
    layer = paddle.incubate.nn.FusedMultiTransformer(E, NH, FF, num_layers=1)
    cache = torch.zeros(1, 2, B, S, NH, E // NH)
    with pytest.raises(ValueError, match="past the cache"):
        layer(paddle.to_tensor(_r(1, B, 2, E)), caches=cache, time_step=4)
