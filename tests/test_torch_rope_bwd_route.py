"""The route of the port's fused-RoPE flash backward
(``paddle_tpu_torch.kernels.flash.flash_attention_bwd(..., rope)``) on
the CPU, which is the card's route with the plain versions: Q and K
rotated once through the plain pre-pass (``rope_rotate``, the
``rope_qk`` kernel's plain version), the float32 gradients of the rotated
inputs, the adjoint rotation on dQ and dK, one rounding.

Held against the port's own plain backward
(``flash_attention_bwd_reference``, which rotates inside each of its two
halves) bit for bit, in float32 and in bfloat16; and against the JAX
package's Pallas backward (``pallas_flash.flash_attention_bhsd`` with
``rope=``, its kernels forced through interpret mode) within the JAX
kernel tests' 2e-4, as ``tests/test_torch_rope_flash.py`` holds the
forward and autograd route. Inputs come from a numpy seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import pallas_flash as jflash
from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
from paddle_tpu_torch.kernels import flash as tflash
from torch_threads import one_torch_thread  # noqa: F401


GRAD_TOL = 2e-4


@pytest.fixture(autouse=True)
def _interpret():
    jflash._FORCE_INTERPRET[0] = True
    yield
    jflash._FORCE_INTERPRET[0] = False


def _tables(S, D, theta=10000.0):
    inv = 1.0 / (theta ** (np.arange(0, D, 2, dtype=np.float32) / D))
    emb = np.outer(np.arange(S, dtype=np.float32), inv)
    emb = np.concatenate([emb, emb], axis=-1)
    return np.sin(emb), np.cos(emb)


def _head_major(B, H, Hk, S, D, seed):
    """Un-rotated q, k, v and dO as numpy ``[B, h, S, D]`` float32."""
    r = np.random.RandomState(seed)
    return tuple(r.randn(B, h, S, D).astype(np.float32) * 0.5
                 for h in (H, Hk, Hk, H))


def _port(arrays, dtype):
    """Head-major numpy arrays as the ``[B, S, h, D]`` views the model's
    bhsd branch hands the kernels."""
    return tuple(torch.from_numpy(a).to(dtype).transpose(1, 2)
                 for a in arrays)


def _count_rotations(monkeypatch):
    calls = []
    plain = tflash.rope_rotate

    def counted(x, sin, cos):
        calls.append(tuple(x.shape))
        return plain(x, sin, cos)

    monkeypatch.setattr(tflash, "rope_rotate", counted)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_route_rotates_once_and_equals_the_plain_backward(monkeypatch,
                                                           dtype):
    """One backward rotates Q once and K once (the pre-pass), launches
    nothing on the CPU, and gives the plain backward's bits for dQ, dK
    and dV (GQA, a tail past 64 rows)."""
    B, H, Hk, S, D = 1, 4, 2, 70, 64
    q, k, v, do = _port(_head_major(B, H, Hk, S, D, seed=5), dtype)
    rope = tuple(torch.from_numpy(t) for t in _tables(S, D))
    o, lse = tflash.flash_attention_fwd(q, k, v, True, rope)
    want = tflash.flash_attention_bwd_reference(q, k, v, o, lse, do, True,
                                                rope)
    calls = _count_rotations(monkeypatch)
    reset_launches()
    got = tflash.flash_attention_bwd(q, k, v, o, lse, do, True, rope)
    assert calls == [(B, S, H, D), (B, S, Hk, D)]
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_pre_pass_on_the_cpu_is_rope_rotate(layout):
    """``rope_qk`` on CPU tensors is ``rope_rotate`` of each, bit for
    bit, in either layout the kernels read."""
    B, H, Hk, S, D = 2, 4, 1, 33, 128
    arrays = _head_major(B, H, Hk, S, D, seed=3)[:2]
    q, k = _port(arrays, torch.bfloat16)
    if layout == "bshd":
        q, k = q.contiguous(), k.contiguous()
    sin, cos = (torch.from_numpy(t) for t in _tables(S, D))
    qr, kr = tflash.rope_qk(q, k, sin, cos)
    assert torch.equal(qr, tflash.rope_rotate(q, sin, cos))
    assert torch.equal(kr, tflash.rope_rotate(k, sin, cos))


def _jax_grads(q, k, v, do, sin, cos):
    """dQ, dK, dV of the JAX Pallas op on ``[B*H, S, D]`` (K/V repeated to
    the query heads, as ``_attention_bhsd`` does) for the cotangent dO,
    dK/dV folded back to ``[B, Hk, S, D]``."""
    B, H, S, D = q.shape
    Hk = k.shape[1]
    G = H // Hk
    fold = lambda x: jnp.asarray(x).reshape(-1, S, D)       # noqa: E731
    rep = lambda x: np.repeat(x, G, axis=1)                  # noqa: E731

    def f(q_, k_, v_):     # one block a head: the sweep stays cheap
        return jflash.flash_attention_bhsd(
            q_, k_, v_, causal=True, block_q=S, block_k=S,
            rope=(jnp.asarray(sin), jnp.asarray(cos)))

    _, vjp = jax.vjp(f, fold(q), fold(rep(k)), fold(rep(v)))
    gq, gk, gv = vjp(fold(do))
    back = lambda g: np.asarray(g).reshape(B, Hk, G, S, D).sum(2)  # noqa
    return np.asarray(gq).reshape(B, H, S, D), back(gk), back(gv)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [63, 300])
def test_route_matches_jax_pallas_backward(S, D, G):
    """The route's float32 dQ, dK, dV against the JAX Pallas backward in
    interpret mode, within 2e-4."""
    H = 4
    arrays = _head_major(1, H, H // G, S, D, seed=S + D + G)
    sin, cos = _tables(S, D)
    want = _jax_grads(*arrays, sin, cos)
    q, k, v, do = _port(arrays, torch.float32)
    rope = (torch.from_numpy(sin), torch.from_numpy(cos))
    o, lse = tflash.flash_attention_fwd(q, k, v, True, rope)
    got = tflash.flash_attention_bwd(q, k, v, o, lse, do, True, rope)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w,
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
