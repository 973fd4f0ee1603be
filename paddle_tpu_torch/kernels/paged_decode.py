"""Paged decode attention: one query token per sequence attends its cache
through a block table over the shared KV pool.

Replaces ``paddle_tpu/kernels/pallas_paged_decode.py`` (``_paged_kernel``
via ``_paged_call``, the ``pallas_call`` at ``:215``; entry
``paged_decode_attention_pallas``); the CUDA kernel is
``paddle_tpu_torch/csrc/paged_decode.cu``. What bounds it on the H100:
bytes — each cached K/V row is read once for ``4*D`` flops per query
head. Its design is split-KV (flash-decoding): one block per (row, KV
head, split of the row's keys), serving the KV head's G query heads from
one read of K/V; 32-key pages through a ``cp.async`` ring; each split's
fp32 partials combined in split order by the last block of its (row, KV
head) to finish, in the same launch. Nothing past a row's length is
fetched. The walk lives in ``csrc/split_kv.cuh``, shared with dense decode
and the span-1 rows of ragged attention; :mod:`.split_kv` holds its split
rule.

The pool is float32, bfloat16 (the query's type), or quantized: int8 with
per-row-per-head float32 scale planes, or ``float8_e4m3fn`` with per-block
planes (``serving/block_manager.py``). A quantized page is half or a
quarter of the bytes through the same ring; each page's scales come
beside it, K and V convert to float32 in registers (exact for both
types), the K scale multiplies the scores after the dot, the softmax sum
``l`` is taken over the unscaled P, and only then is the V scale folded
into P (kept in float32), as the reference kernel orders it.

:func:`paged_decode_attention` is the wrapper: plain version for CPU
tensors, the kernel for CUDA tensors. :func:`split_len` is the split
rule; :data:`LAST_GRID` records the last launch's split and grid.
"""
from __future__ import annotations

import torch

from ._launch import as_index, check_cuda, launch
from .decode import decode_attention_reference
# the split rule of the walk this kernel shares with dense decode and the
# span-1 rows of ragged attention
from .split_kv import (BLOCKS_PER_SM, MIN_SPLIT_PAGES, PAGE,  # noqa: F401
                       check_heads, plan, scratch, sm_count, split_len)

#: the last launch: keys a split, splits a row, blocks in the grid
LAST_GRID = {"split_len": 0, "n_split": 0, "blocks": 0}


def check_limits(H, Hkv, D):
    """Raise on a head geometry the kernel does not take: ``H`` query
    heads over ``Hkv`` KV heads of ``D``."""
    check_heads("paged decode", H, Hkv, D)


def dequant_rows(rows, scale, tables, bs):
    """Rows gathered through ``tables [B, mb]`` (``[B, mb * bs, Hkv, D]``,
    int8 or e4m3) times their scales, in float32: ``scale`` is the pool's
    plane, per row ``[nb, bs, Hkv]`` (int8) or per block ``[nb, Hkv]``
    (fp8, broadcast over the block's rows)."""
    B, mb = tables.shape
    s = scale[tables]
    s = s.repeat_interleave(bs, dim=1) if scale.dim() == 2 \
        else s.reshape(B, mb * bs, -1)
    return rows.float() * s[..., None]


def paged_decode_attention_reference(q, pool_k, pool_v, tables, lengths,
                                     k_scale=None, v_scale=None):
    """Plain version: gather each row's logical cache through its table
    (sentinel entries clamp into the pool and are masked by length), then
    the dense reference. A quantized pool (``k_scale``/``v_scale``: int8
    per-row planes ``[nb, bs, Hkv]`` or fp8 per-block planes ``[nb,
    Hkv]``) dequantizes to float32 right after the gather, as the JAX
    reference does.

    q [B, H, D]; pool_k/pool_v [nb, bs, Hkv, D]; tables [B, mb];
    lengths [B]. Returns [B, H, D]."""
    B = q.shape[0]
    nb, bs, Hkv, D = pool_k.shape
    tables = torch.as_tensor(tables).to(q.device).long().clamp(0, nb - 1)
    mb = tables.shape[1]
    k = pool_k[tables].reshape(B, mb * bs, Hkv, D)
    v = pool_v[tables].reshape(B, mb * bs, Hkv, D)
    if k_scale is not None:
        k = dequant_rows(k, k_scale, tables, bs)
        v = dequant_rows(v, v_scale, tables, bs)
    return decode_attention_reference(q, k, v, lengths)


def scale_mode(pool, k_scale, v_scale):
    """The walk's scale mode of a pool: 0 full precision, 1 int8 with
    per-row planes, 2 e4m3 with per-block planes; raises on a pool and
    planes that do not go together."""
    nb, bs, Hkv = pool.shape[:3]
    if k_scale is None and v_scale is None:
        if pool.dtype in (torch.int8, torch.float8_e4m3fn):
            raise ValueError(f"a {pool.dtype} pool needs its scale planes")
        return 0
    if k_scale is None or v_scale is None:
        raise ValueError("k_scale and v_scale go together")
    want = {torch.int8: (1, (nb, bs, Hkv)),
            torch.float8_e4m3fn: (2, (nb, Hkv))}.get(pool.dtype)
    if want is None:
        raise TypeError(f"scale planes go with an int8 or float8_e4m3fn "
                        f"pool, not {pool.dtype}")
    for s in (k_scale, v_scale):
        if tuple(s.shape) != want[1] or s.dtype != torch.float32 \
                or not s.is_contiguous() or s.device != pool.device:
            raise ValueError(f"scale planes must be contiguous float32 "
                             f"{want[1]} on {pool.device}, got "
                             f"{tuple(s.shape)} {s.dtype}")
    return want[0]


def paged_decode_attention(q, pool_k, pool_v, tables, lengths, k_scale=None,
                           v_scale=None):
    """Single-token attention through block tables: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. Same arguments as
    :func:`paged_decode_attention_reference`."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, pool_k, pool_v, tables,
                                                lengths, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, "
                         f"got {q.device}")
    B, H, D = q.shape
    nb, bs, Hkv, _ = pool_k.shape
    check_limits(H, Hkv, D)
    tables = as_index(tables, q.device)
    lengths = as_index(lengths, q.device)
    mode = scale_mode(pool_k, k_scale, v_scale)
    code = check_cuda("paged_decode", (q,), (tables, lengths),
                      pools=(pool_k, pool_v))
    mb = tables.shape[1]
    sl, n_split = plan(B, Hkv, mb * bs, sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    launch("paged_decode", q, pool_k, pool_v, k_scale, v_scale, tables,
           lengths, out, *scratch(B, Hkv, H // Hkv, D, n_split, q.device),
           B, H, Hkv, D, nb, bs, mb, sl, n_split, code, mode)
    LAST_GRID.update(split_len=sl, n_split=n_split,
                     blocks=n_split * Hkv * B)
    return out
