"""Dense-cache decode attention: one query token per sequence attends the
first ``lengths[b]`` rows of its own slot of a dense per-slot cache.

Replaces ``paddle_tpu/kernels/pallas_decode.py`` (``_decode_kernel`` via
``_decode_call``, entry ``decode_attention_pallas``); the CUDA kernel is
``paddle_tpu_torch/csrc/decode.cu``. What bounds it on the H100: bytes —
each valid cached K/V row is read once for ``4*D`` flops per head. Its
design is paged decode's split-KV walk (``csrc/split_kv.cuh``): one block
per (row, KV head, split of the row's keys), the KV head's G query heads
served from one read of K/V (no repeated K/V, no block-diagonal wide
query), fp32 partials combined in split order in the same launch, so two
launches give the same bits. The dense cache is the paged walk over B
blocks of ``S_max`` rows with the table ``arange(B)``: key ``p`` of row
``b`` sits at row ``b*S_max + p``, and no table is read. The split rule
is paged decode's with the capacity ``S_max``. Nothing past a row's length
is fetched. Full-precision caches only (float32, bfloat16).

:func:`decode_attention` is the wrapper: plain version for CPU tensors,
the kernel for CUDA tensors; like the reference's entry it is
inference-only (a backward raises). :func:`decode_attention_reference`
is the plain version, and the paged decode's plain version builds on it.
:data:`LAST_GRID` records the last launch's split and grid.
"""
from __future__ import annotations

import math

import torch

from ._launch import as_index, check_cuda, launch
from .split_kv import check_heads, plan, scratch, sm_count

NEG_INF = -1e30
#: the last launch: keys a split, splits a row, blocks in the grid
LAST_GRID = {"split_len": 0, "n_split": 0, "blocks": 0}


def check_limits(H, Hkv, D):
    """Raise on a head geometry the kernel does not take: ``H`` query
    heads over ``Hkv`` KV heads of ``D``."""
    check_heads("decode", H, Hkv, D)


def decode_attention_reference(q, k_cache, v_cache, lengths):
    """Dense-cache single-query attention with per-row lengths — the
    plain helper of ``paddle_tpu/kernels/pallas_decode.py``'s
    ``decode_attention_reference``, same ops and cast points.

    q [B, H, D]; k_cache/v_cache [B, S, Hkv, D]; lengths [B]."""
    B, H, D = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    s_max = k_cache.shape[1]
    k = k_cache.repeat_interleave(G, dim=2) if G > 1 else k_cache
    v = v_cache.repeat_interleave(G, dim=2) if G > 1 else v_cache
    logits = torch.einsum("bhd,bkhd->bhk", q.float(), k.float())
    logits = logits / math.sqrt(D)
    lengths = torch.as_tensor(lengths).to(q.device)
    cols = torch.arange(s_max, device=q.device)
    valid = cols[None, None, :] < lengths[:, None, None]
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    # zero masked probs/values explicitly: stale rows can be NaN and
    # 0 * NaN = NaN
    probs = torch.where(valid, probs, torch.zeros_like(probs))
    row_valid = (cols[None, :, None, None]
                 < lengths[:, None, None, None])
    v = torch.where(row_valid, v, torch.zeros_like(v))
    # a dequantized cache is float32 beside a bfloat16 q: P rounds to q's
    # type first, the product runs in float32 (JAX's type promotion), and
    # the result comes back in q's type
    return torch.einsum("bhk,bkhd->bhd", probs.to(q.dtype).to(v.dtype),
                        v).to(q.dtype)


class _InferenceOnly(torch.autograd.Function):
    """Decode attention that refuses a backward, as the reference's
    ``custom_vjp`` rule does (``pallas_decode.py:154``): a one-token
    decode never backpropagates, and the kernel has no backward."""

    @staticmethod
    def forward(ctx, q, k_cache, v_cache, lengths):
        return _decode_attention(q, k_cache, v_cache, lengths)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "decode_attention is inference-only (single-token decode "
            "never backpropagates); use the flash-attention kernel for "
            "training attention")


def decode_attention(q, k_cache, v_cache, lengths):
    """Single-token attention over a dense per-slot cache: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. Same
    arguments as :func:`decode_attention_reference`. Inference-only: a
    backward through it raises."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_cache, v_cache)):
        return _InferenceOnly.apply(q, k_cache, v_cache, lengths)
    return _decode_attention(q, k_cache, v_cache, lengths)


def _decode_attention(q, k_cache, v_cache, lengths):
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, got "
                         f"{q.device}")
    B, H, D = q.shape
    _, s_max, Hkv, _ = k_cache.shape
    check_limits(H, Hkv, D)
    if k_cache.shape[0] != B or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    lengths = as_index(lengths, q.device)
    code = check_cuda("decode", (q, k_cache, v_cache), (lengths,))
    sl, n_split = plan(B, Hkv, s_max, sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    launch("decode", q, k_cache, v_cache, lengths, out,
           *scratch(B, Hkv, H // Hkv, D, n_split, q.device), B, H, Hkv, D,
           s_max, sl, n_split, code)
    LAST_GRID.update(split_len=sl, n_split=n_split,
                     blocks=n_split * Hkv * B)
    return out
