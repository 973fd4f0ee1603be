"""The flash kernels' fused-RoPE mode and head-major entry in the port
(``paddle_tpu_torch.kernels.flash``) against the JAX package, on the CPU.

The JAX side is ``pallas_flash.flash_attention_bhsd(rope=(sin, cos))``
with its Pallas kernels forced through interpret mode (the ``_fwd_kernel``,
``_dkv_kernel`` and ``_dq_kernel`` bodies run, ``_rope_block`` in their
prologues and ``_rope_t_block`` on dQ/dK), restored after each test. The
port's side is its plain versions (CPU tensors): the rotation, the forward
and the two backward references with their adjoint rotation.

Inputs come from a numpy seed and reach both sides as the same float32
arrays. Tolerances are the JAX kernel tests' own
(``tests/test_pallas_flash.py``): 2e-5 absolute and relative for the
forward, 2e-4 for the gradients — float32 on both sides, summation order
and the kernels' per-tile online softmax only.
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


FWD_TOL = 2e-5
GRAD_TOL = 2e-4


@pytest.fixture(autouse=True)
def _interpret():
    jflash._FORCE_INTERPRET[0] = True
    yield
    jflash._FORCE_INTERPRET[0] = False


def _tables(S, D, theta=10000.0):
    inv = 1.0 / (theta ** (np.arange(0, D, 2, dtype=np.float32) / D))
    freqs = np.outer(np.arange(S, dtype=np.float32), inv)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.sin(emb), np.cos(emb)


def _inputs(B, H, Hk, S, D, seed):
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, h, S, D).astype(np.float32) * 0.5
               for h in (H, Hk, Hk))
    return q, k, v


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _jax_fwd_and_grads(q, k, v, sin, cos, H):
    """The JAX Pallas op on ``[B*H, S, D]`` (K/V repeated to the query
    heads first, as ``_attention_bhsd`` does), its output and the
    gradients of ``sum(o * cos(o))`` folded back to ``[B, Hk, S, D]``."""
    B, Hk, S, D = k.shape
    G = H // Hk
    fold = lambda x: jnp.asarray(x).reshape(-1, S, D)       # noqa: E731
    rep = lambda x: np.repeat(x, G, axis=1)                  # noqa: E731

    def f(q_, k_, v_):
        return jflash.flash_attention_bhsd(
            q_, k_, v_, causal=True, block_q=128, block_k=128,
            rope=(jnp.asarray(sin), jnp.asarray(cos)))

    args = (fold(q), fold(rep(k)), fold(rep(v)))
    o = f(*args)
    def loss(*a):
        o_ = f(*a)
        return jnp.sum(o_ * jnp.cos(o_))

    gq, gk, gv = jax.grad(loss, argnums=(0, 1, 2))(*args)
    back = lambda g: np.asarray(g).reshape(B, Hk, G, S, D).sum(2)  # noqa
    return (np.asarray(o).reshape(B, H, S, D),
            np.asarray(gq).reshape(B, H, S, D), back(gk), back(gv))


@pytest.mark.parametrize("S,D,H,Hk", [
    (256, 64, 2, 2),      # two 128-blocks, causal pruning
    (320, 64, 2, 2),      # tail: 320 % 128 rows past S masked
    (256, 32, 2, 2),
    (320, 32, 2, 2),
    (320, 64, 4, 2),      # GQA: the port keeps 2 KV heads, JAX repeats
])
def test_rope_mode_matches_jax_pallas(S, D, H, Hk):
    """Forward and the three gradients of the port's head-major entry
    with ``rope=`` (plain versions) against the JAX Pallas kernels."""
    reset_launches()
    q, k, v = _inputs(1, H, Hk, S, D, seed=S + D + Hk)
    sin, cos = _tables(S, D)
    want_o, want_dq, want_dk, want_dv = _jax_fwd_and_grads(q, k, v, sin,
                                                           cos, H)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tflash.flash_attention_bhsd(
        tq, tk, tv, causal=True, block_q=128, block_k=128,
        rope=(torch.from_numpy(sin), torch.from_numpy(cos)))
    _close(o, want_o, FWD_TOL)
    (o * torch.cos(o)).sum().backward()
    assert tk.grad.shape == (1, Hk, S, D)
    for got, want in ((tq.grad, want_dq), (tk.grad, want_dk),
                      (tv.grad, want_dv)):
        _close(got, want, GRAD_TOL)
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES


def test_folded_entry_matches_jax_forward():
    """The reference's own ``[BH, S, D]`` form, rope on, forward."""
    q, k, v = (x[0] for x in _inputs(1, 3, 3, 320, 64, seed=9))
    sin, cos = _tables(320, 64)
    want = jflash.flash_attention_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=128, block_k=128, rope=(jnp.asarray(sin), jnp.asarray(cos)))
    got = tflash.flash_attention_bhsd(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        rope=(torch.from_numpy(sin), torch.from_numpy(cos)))
    assert got.shape == (3, 320, 64)
    _close(got, want, FWD_TOL)


def test_backward_references_round_once_after_the_adjoint():
    """``flash_bwd_dkv_reference``/``flash_bwd_dq_reference`` with rope
    keep dK/dQ in float32 through the adjoint and round once: in bf16
    they equal that recipe bit for bit, and their float32 results are the
    un-rotated inputs' gradients (autograd through rotate-then-attend,
    max-abs 1e-5 of the largest entry)."""
    r = np.random.RandomState(4)
    B, S, H, Hk, D = 1, 40, 4, 2, 64
    q, k, v, do = (torch.from_numpy(r.randn(B, S, h, D).astype(np.float32))
                   for h in (H, Hk, Hk, H))
    sin, cos = (torch.from_numpy(t) for t in _tables(S, D))
    rope = (sin, cos)
    o, lse = tflash.flash_attention_fwd(q, k, v, True, rope)
    delta = tflash.attention_delta(o, do)
    dq = tflash.flash_bwd_dq_reference(q, k, v, do, lse, delta, True, rope)
    dk, dv = tflash.flash_bwd_dkv_reference(q, k, v, do, lse, delta, True,
                                            rope)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = tflash._ref_attention(tflash.rope_rotate(qg, *rope),
                                tflash.rope_rotate(kg, *rope), vg, True)
    want = torch.autograd.grad(out, (qg, kg, vg), do)
    for got, w in zip((dq, dk, dv), want):
        assert (got - w).abs().max() <= 1e-5 * w.abs().max()
    # bf16: the float32 dQ adjoint-rotated, then one rounding
    qb, kb, vb, dob = (x.bfloat16() for x in (q, k, v, do))
    ob, lseb = tflash.flash_attention_fwd(qb, kb, vb, True, rope)
    deltab = tflash.attention_delta(ob, dob)
    dqb = tflash.flash_bwd_dq_reference(qb, kb, vb, dob, lseb, deltab, True,
                                        rope)
    qr, kr = tflash._rotated(qb, kb, rope)
    _, ds, krep = tflash._scores_grad(qr, kr, vb, lseb, deltab, dob, True)
    dq32 = torch.einsum("bhqk,bkhd->bqhd", ds.to(torch.bfloat16).float(),
                        krep.float())
    assert torch.equal(dqb, tflash.rope_adjoint(dq32, *rope).bfloat16())


def test_adjoint_is_the_transpose():
    """<rope(x), y> == <x, rope^T(y)> for float32 x, y (1e-5 relative:
    the two sides sum in other orders)."""
    r = np.random.RandomState(1)
    x, y = (torch.from_numpy(r.randn(2, 24, 3, 64).astype(np.float32))
            for _ in range(2))
    sin, cos = (torch.from_numpy(t) for t in _tables(24, 64))
    a = (tflash.rope_rotate(x, sin, cos) * y).sum()
    b = (x * tflash.rope_adjoint(y, sin, cos)).sum()
    assert abs(float(a - b)) <= 1e-5 * abs(float(a))


def test_entry_checks_and_layouts():
    """Block sizes must be positive ints, tables ``[S, D]``; the kernels
    read ``[B, S, H, D]`` and head-major memory as they are and copy any
    other layout (dO and V take Q's and K's strides)."""
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="block_q"):
        tflash.flash_attention_bhsd(q, q, q, block_q=0)
    with pytest.raises(ValueError, match="rope tables"):
        tflash._tables((torch.zeros(7, 64),) * 2, 8, 64, "cpu")
    bshd = torch.zeros(2, 8, 4, 64)
    head_major = torch.zeros(2, 4, 8, 64).transpose(1, 2)
    for x in (bshd, head_major):
        assert tflash._layout(x) is x
    odd = torch.zeros(2, 4, 64, 8).permute(0, 3, 1, 2)
    assert tflash._layout(odd).is_contiguous()
    moved = tflash._like(bshd, head_major)
    assert moved.stride() == head_major.stride()
