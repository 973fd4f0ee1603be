"""The bound the card holds the bf16 flash kernels to, checked on the CPU
against the JAX reference's own tiled bf16 arithmetic.

The tensor-core kernels (``csrc/flash.cu``'s forward, ``csrc/flash_bwd.cu``'s
dK/dV and dQ) tile 64 query rows by 64 keys; the forward rounds P to bf16
per 64-key tile against a running max, and dQ rounds dS per 64 x 64 tile
before dS K. The Pallas kernels do the same at
``block_q = block_k = 64``, so the JAX ``_flash_fwd`` and ``_flash_bwd``
(``paddle_tpu/kernels/pallas_flash.py``), run in interpret mode in bf16 at
those blocks, stand in for the kernels' arithmetic here. They must sit
within ``chip_smoke.py``'s ``TOL`` (the output; fp32 ``TOL`` for the LSE)
and ``BWD_TOL`` (dQ, dK, dV) of the port's plain versions — the bounds the
smoke and the on-card tests hold the kernels to. Inputs come from a numpy
seed; H = Hk = 2, D = 64, S = 128 (two full tiles) and 300 (a tail).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BWD_TOL, TOL
from paddle_tpu.kernels import pallas_flash as jflash
from paddle_tpu_torch.kernels import flash as tflash
from paddle_tpu_torch.kernels.flash_attention import _ref_attention, _ref_lse
from torch_threads import one_torch_thread  # noqa: F401

B, H, D = 1, 2, 64
BLOCK = 64                      # the tensor-core kernels' tiles
SCALE = 1.0 / math.sqrt(D)


def _inputs(S, seed):
    r = np.random.RandomState(seed)
    return [r.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def _heads_first(x):
    """numpy [B, S, H, D] -> the Pallas layout [B*H, S, D], bf16."""
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, -1, D),
                       jnp.bfloat16)


def _seq_first(x, S):
    """Pallas [B*H, S, ...] -> torch float32 [B, S, H, ...]."""
    a = np.asarray(jnp.asarray(x, jnp.float32)).reshape(B, H, S, -1)
    return torch.from_numpy(a.transpose(0, 2, 1, 3).copy())


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _tiled_forward(q, k, v, causal):
    """The Pallas forward, interpret mode, bf16, 64 x 64 tiles:
    (o [B*H, S, D] bf16, lse [B*H, S, 1] f32)."""
    return jflash._flash_fwd(_heads_first(q), _heads_first(k),
                             _heads_first(v), SCALE, causal, BLOCK, BLOCK,
                             True)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("S", [128, 300])
def test_tiled_bf16_forward_within_tol(S, causal):
    q, k, v, _ = _inputs(S, seed=S)
    o, lse = _tiled_forward(q, k, v, causal)
    got_o = _seq_first(o, S)
    got_lse = _seq_first(lse, S)[..., 0].transpose(1, 2)     # [B, H, S]
    want_o = _ref_attention(_bf16(q), _bf16(k), _bf16(v), causal).float()
    want_lse = _ref_lse(_bf16(q), _bf16(k), causal)
    assert torch.isfinite(got_o).all() and torch.isfinite(got_lse).all()
    atol, rtol = TOL["bfloat16"]
    assert ((got_o - want_o).abs() <= atol + rtol * want_o.abs()).all()
    atol, rtol = TOL["float32"]
    assert ((got_lse - want_lse).abs() <= atol + rtol * want_lse.abs()).all()


def _tiled_backward(S, seed):
    """The Pallas backward, interpret mode, bf16, 64 x 64 tiles, causal:
    its ``(dq, dk, dv)`` and the plain versions' inputs (bf16 q, k, v, dO;
    the same O's delta and the same LSE)."""
    q, k, v, do = _inputs(S, seed=seed)
    o, lse = _tiled_forward(q, k, v, True)
    res = (_heads_first(q), _heads_first(k), _heads_first(v), o, lse)
    grads = jflash._flash_bwd(res, _heads_first(do), SCALE, True, BLOCK,
                              BLOCK, True)
    t_lse = _seq_first(lse, S)[..., 0].transpose(1, 2).contiguous()
    delta = tflash.attention_delta(_seq_first(o, S).to(torch.bfloat16),
                                   _bf16(do))
    args = (_bf16(q), _bf16(k), _bf16(v), _bf16(do), t_lse, delta, True)
    return grads, args


def _within_bwd_tol(got, want, S):
    atol, rtol = BWD_TOL["bfloat16"]
    g, w = _seq_first(got, S), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= atol * w.abs().max() + rtol * w.abs()).all()


@pytest.mark.parametrize("S", [128, 300])
def test_tiled_bf16_dkv_within_bwd_tol(S):
    """dK and dV of the Pallas backward (its ``_dkv_kernel``) against
    ``flash_bwd_dkv_reference`` on the same O and LSE, causal."""
    (_, dk, dv), args = _tiled_backward(S, seed=S + 1)
    for got, w in zip((dk, dv), tflash.flash_bwd_dkv_reference(*args)):
        _within_bwd_tol(got, w, S)


@pytest.mark.parametrize("S", [128, 300])
def test_tiled_bf16_dq_within_bwd_tol(S):
    """dQ of the Pallas backward (its ``_dq_kernel``: dS rounded to bf16
    per 64 x 64 tile before dS K) against ``flash_bwd_dq_reference`` on
    the same O and LSE, causal."""
    (dq, _, _), args = _tiled_backward(S, seed=S + 2)
    _within_bwd_tol(dq, tflash.flash_bwd_dq_reference(*args), S)
