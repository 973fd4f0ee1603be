"""float16 in the flash kernels (ROADMAP.md Queue C 8): the bound the
card holds them to, checked on the CPU against the JAX reference's own
tiled float16 arithmetic, and the routing that now takes float16.

The tensor-core kernels run the bf16 design on ``__half``: 64 query rows
by 64 keys, P rounded to float16 per key tile against a running max, dS
rounded per 64 x 64 tile, the LSE and every accumulator float32. The
Pallas kernels do the same at ``block_q = block_k = 64``, so the JAX
``_flash_fwd`` and ``_flash_bwd`` (``paddle_tpu/kernels/pallas_flash.py``),
run in interpret mode in float16 at those blocks, stand in for the
kernels' arithmetic. They must sit within ``chip_smoke.py``'s float16
``TOL`` (the output; fp32 ``TOL`` for the LSE) and ``BWD_TOL`` (dQ, dK,
dV) of the port's plain versions, causal and not, with and without
``rope=`` (Q and K rotated in the kernels' prologues there, by the
plain rotation here). Inputs come from a numpy seed; H = Hk = 2, D = 64,
S = 128 (two full tiles) and 300 (a tail).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from chip_smoke import BWD_TOL, TOL
from paddle_tpu.kernels import pallas_flash as jflash
from paddle_tpu_torch.kernels import _launch
from paddle_tpu_torch.kernels import flash as tflash
from paddle_tpu_torch.kernels.flash_attention import _ref_lse
from paddle_tpu_torch.nn import functional as TF
from torch_threads import one_torch_thread  # noqa: F401

B, H, D = 1, 2, 64
BLOCK = 64                      # the tensor-core kernels' tiles
SCALE = 1.0 / math.sqrt(D)
F16 = "float16"


def _inputs(S, seed):
    r = np.random.RandomState(seed)
    return [r.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def _tables(S):
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2, dtype=np.float32) / D))
    emb = np.outer(np.arange(S, dtype=np.float32), inv)
    emb = np.concatenate([emb, emb], axis=-1)
    return np.sin(emb).astype(np.float32), np.cos(emb).astype(np.float32)


def _heads_first(x):
    """numpy [B, S, H, D] -> the Pallas layout [B*H, S, D], float16."""
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, -1, D),
                       jnp.float16)


def _seq_first(x, S):
    """Pallas [B*H, S, ...] -> torch float32 [B, S, H, ...]."""
    a = np.asarray(jnp.asarray(x, jnp.float32)).reshape(B, H, S, -1)
    return torch.from_numpy(a.transpose(0, 2, 1, 3).copy())


def _f16(x):
    return torch.from_numpy(x).to(torch.float16)


def _rope(S, rope):
    if not rope:
        return None, None
    sin, cos = _tables(S)
    return (jnp.asarray(sin), jnp.asarray(cos)), (torch.from_numpy(sin),
                                                  torch.from_numpy(cos))


CASES = [(S, causal, rope) for S in (128, 300) for causal in (True, False)
         for rope in (False, True)]
IDS = [f"S{S}-{'causal' if c else 'full'}{'-rope' if r else ''}"
       for S, c, r in CASES]


@pytest.mark.parametrize("S,causal,rope", CASES, ids=IDS)
def test_tiled_fp16_forward_within_tol(S, causal, rope):
    q, k, v, _ = _inputs(S, seed=S)
    jrope, trope = _rope(S, rope)
    o, lse = jflash._flash_fwd(_heads_first(q), _heads_first(k),
                               _heads_first(v), SCALE, causal, BLOCK, BLOCK,
                               True, rope=jrope)
    got_o = _seq_first(o, S)
    got_lse = _seq_first(lse, S)[..., 0].transpose(1, 2)
    want_o, want_lse = tflash.flash_attention_reference(
        _f16(q), _f16(k), _f16(v), causal, trope)
    assert want_o.dtype == torch.float16
    assert torch.isfinite(got_o).all() and torch.isfinite(got_lse).all()
    atol, rtol = TOL[F16]
    w = want_o.float()
    assert ((got_o - w).abs() <= atol + rtol * w.abs()).all()
    atol, rtol = TOL["float32"]
    assert ((got_lse - want_lse).abs() <= atol + rtol * want_lse.abs()).all()


@pytest.mark.parametrize("S,causal,rope", CASES, ids=IDS)
def test_tiled_fp16_backward_within_bwd_tol(S, causal, rope):
    """dQ, dK, dV of the Pallas backward (its ``_dkv_kernel`` and
    ``_dq_kernel``: P and dS rounded to float16 per 64 x 64 tile) against
    the plain backward on the same O and LSE."""
    q, k, v, do = _inputs(S, seed=S + 1)
    jrope, trope = _rope(S, rope)
    o, lse = jflash._flash_fwd(_heads_first(q), _heads_first(k),
                               _heads_first(v), SCALE, causal, BLOCK, BLOCK,
                               True, rope=jrope)
    res = (_heads_first(q), _heads_first(k), _heads_first(v), o, lse)
    grads = jflash._flash_bwd(res, _heads_first(do), SCALE, causal, BLOCK,
                              BLOCK, True, rope=jrope)
    t_lse = _seq_first(lse, S)[..., 0].transpose(1, 2).contiguous()
    delta = tflash.attention_delta(_seq_first(o, S).to(torch.float16),
                                   _f16(do))
    args = (_f16(q), _f16(k), _f16(v), _f16(do), t_lse, delta, causal,
            trope)
    dk, dv = tflash.flash_bwd_dkv_reference(*args)
    dq = tflash.flash_bwd_dq_reference(*args)
    atol, rtol = BWD_TOL[F16]
    for got, want in zip(grads, (dq, dk, dv)):
        assert want.dtype == torch.float16
        g, w = _seq_first(got, S), want.float()
        assert torch.isfinite(g).all()
        assert ((g - w).abs() <= atol * w.abs().max() + rtol * w.abs()).all()


def test_fp16_bounds_no_looser_than_bf16():
    for table in (TOL, BWD_TOL):
        assert all(a <= b for a, b in zip(table[F16], table["bfloat16"]))


# ---------------------------------------------------------------- routing
def test_flash_kernels_take_float16_and_serving_kernels_do_not():
    half = torch.empty(0, dtype=torch.float16)
    assert _launch.dtype_code(half) == 2
    assert _launch.dtype_code(torch.empty(0, dtype=torch.bfloat16)) == 1
    with pytest.raises(TypeError, match="float16"):
        _launch.dtype_code(half, _launch.SERVING_TYPES)
    with pytest.raises(TypeError):
        _launch.dtype_code(torch.empty(0, dtype=torch.float64))


@pytest.mark.parametrize("causal", [True, False])
def test_f_flash_attention_takes_float16(causal):
    """``F.flash_attention`` in float16 refuses nothing: on a CPU tensor
    it is the plain forward and, through autograd, the plain backward."""
    paddle.set_device("cpu")
    q, k, v, do = (_f16(a) for a in _inputs(64, seed=9))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out, _ = TF.flash_attention(*qkv, causal=causal)
    assert out.dtype == torch.float16
    o_ref, lse = tflash.flash_attention_reference(q, k, v, causal)
    assert torch.equal(out, o_ref)
    grads = torch.autograd.grad(out, qkv, do)
    want = tflash.flash_attention_bwd_reference(q, k, v, o_ref, lse, do,
                                                causal)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    assert torch.equal(lse, _ref_lse(q, k, causal))
