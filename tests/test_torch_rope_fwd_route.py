"""The route of the port's fused-RoPE flash forward
(``paddle_tpu_torch.kernels.flash.flash_attention_fwd(..., rope)``) on the
CPU, which is the card's route with the plain versions: Q and K rotated
once through the pre-pass (``rope_qk``, whose plain version is
``rope_rotate``), then the plain forward on the rotated pair.

Held against ``rope_qk`` followed by the plain forward bit for bit (O and
LSE, float32 and bfloat16), against the JAX package's Pallas forward
(``pallas_flash._flash_fwd`` with ``rope=``, interpret mode) within the
JAX kernel tests' 2e-5 at the sizes of ``tests/test_torch_rope_flash.py``,
and, through :class:`FlashAttention`, its gradients against the plain
backward (``flash_attention_bwd_reference`` on the un-rotated inputs the
forward saves) bit for bit. Inputs come from a numpy seed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import pallas_flash as jflash
from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
from paddle_tpu_torch.kernels import flash as tflash
from torch_threads import one_torch_thread  # noqa: F401


FWD_TOL = 2e-5


def _tables(S, D, theta=10000.0):
    inv = 1.0 / (theta ** (np.arange(0, D, 2, dtype=np.float32) / D))
    emb = np.outer(np.arange(S, dtype=np.float32), inv)
    emb = np.concatenate([emb, emb], axis=-1)
    return np.sin(emb), np.cos(emb)


def _head_major(B, H, Hk, S, D, seed, n=3):
    """Un-rotated q, k, v (and dO with ``n=4``) as numpy ``[B, h, S, D]``
    float32."""
    r = np.random.RandomState(seed)
    return tuple(r.randn(B, h, S, D).astype(np.float32) * 0.5
                 for h in (H, Hk, Hk, H)[:n])


def _port(arrays, dtype):
    """Head-major numpy arrays as the ``[B, S, h, D]`` views the model's
    bhsd branch hands the kernels."""
    return tuple(torch.from_numpy(a).to(dtype).transpose(1, 2)
                 for a in arrays)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_forward_is_the_pre_pass_then_the_plain_forward(monkeypatch, dtype):
    """One forward rotates Q once and K once (the pre-pass), launches
    nothing on the CPU, and its O and LSE are those of ``rope_qk``
    followed by the plain forward, bit for bit (GQA, a tail past 64
    rows)."""
    B, H, Hk, S, D = 2, 4, 2, 70, 64
    q, k, v = _port(_head_major(B, H, Hk, S, D, seed=5), dtype)
    rope = tuple(torch.from_numpy(t) for t in _tables(S, D))
    qr, kr = tflash.rope_qk(q, k, *rope)
    want = tflash.flash_attention_reference(qr, kr, v, True)
    calls = []
    plain = tflash.rope_rotate

    def counted(x, sin, cos):
        calls.append(tuple(x.shape))
        return plain(x, sin, cos)

    monkeypatch.setattr(tflash, "rope_rotate", counted)
    reset_launches()
    got = tflash.flash_attention_fwd(q, k, v, True, rope)
    assert calls == [(B, S, H, D), (B, S, Hk, D)]
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    # the plain forward with rope= rotates the same way
    for g, w in zip(got, tflash.flash_attention_reference(q, k, v, True,
                                                          rope)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("S,D,H,Hk", [
    (256, 64, 2, 2),      # two 128-blocks, causal pruning
    (320, 64, 2, 2),      # tail: 320 % 128 rows past S masked
    (256, 32, 2, 2),
    (320, 32, 2, 2),
    (320, 64, 4, 2),      # GQA: the port keeps 2 KV heads, JAX repeats
])
def test_forward_matches_jax_pallas(S, D, H, Hk):
    """The route's float32 O and LSE against the JAX Pallas forward with
    ``rope=`` (interpret mode, 128-row blocks), within 2e-5."""
    q, k, v = _head_major(1, H, Hk, S, D, seed=S + D + Hk)
    sin, cos = _tables(S, D)
    G = H // Hk
    fold = lambda x: jnp.asarray(x).reshape(-1, S, D)       # noqa: E731
    rep = lambda x: np.repeat(x, G, axis=1)                  # noqa: E731
    want_o, want_lse = jflash._flash_fwd(
        fold(q), fold(rep(k)), fold(rep(v)), 1.0 / math.sqrt(D), True, 128,
        128, True, rope=(jnp.asarray(sin), jnp.asarray(cos)))
    tq, tk, tv = _port((q, k, v), torch.float32)
    o, lse = tflash.flash_attention_fwd(
        tq, tk, tv, True, (torch.from_numpy(sin), torch.from_numpy(cos)))
    np.testing.assert_allclose(o.transpose(1, 2).reshape(-1, S, D).numpy(),
                               np.asarray(want_o), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(lse.reshape(-1, S).numpy(),
                               np.asarray(want_lse)[..., 0], rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_autograd_gradients_equal_the_plain_backward(dtype):
    """``FlashAttention`` with tables (the route's forward, the saved
    un-rotated Q and K, the backward's own pre-pass) gives the gradients
    of ``flash_attention_bwd_reference`` on the un-rotated inputs, bit for
    bit, and its output is the route's forward's."""
    B, H, Hk, S, D = 1, 4, 2, 67, 64
    arrays = _head_major(B, H, Hk, S, D, seed=11, n=4)
    q, k, v, do = _port(arrays, dtype)
    rope = tuple(torch.from_numpy(t) for t in _tables(S, D))
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o = tflash.FlashAttention.apply(*leaves, *rope, True, True)
    o.backward(do)
    o_want, lse = tflash.flash_attention_fwd(q, k, v, True, rope)
    want = tflash.flash_attention_bwd_reference(q, k, v, o_want, lse, do,
                                                True, rope)
    assert torch.equal(o.detach(), o_want)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == dtype
        assert torch.equal(leaf.grad, w)
