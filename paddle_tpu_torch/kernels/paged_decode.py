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
rule. Full-precision pools only (float32, bfloat16).

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

#: head dims the kernel takes
HEAD_DIMS = (64, 128, 256)
#: the last launch: keys a split, splits a row, blocks in the grid
LAST_GRID = {"split_len": 0, "n_split": 0, "blocks": 0}


def check_limits(H, Hkv, D):
    """Raise on a head geometry the kernel does not take: ``H`` query
    heads over ``Hkv`` KV heads of ``D``."""
    check_heads("paged decode", H, Hkv, D, HEAD_DIMS)


def paged_decode_attention_reference(q, pool_k, pool_v, tables, lengths):
    """Plain version: gather each row's logical cache through its table
    (sentinel entries clamp into the pool and are masked by length), then
    the dense reference.

    q [B, H, D]; pool_k/pool_v [nb, bs, Hkv, D]; tables [B, mb];
    lengths [B]. Returns [B, H, D]."""
    B = q.shape[0]
    nb, bs, Hkv, D = pool_k.shape
    tables = torch.as_tensor(tables).to(q.device).long().clamp(0, nb - 1)
    mb = tables.shape[1]
    k = pool_k[tables].reshape(B, mb * bs, Hkv, D)
    v = pool_v[tables].reshape(B, mb * bs, Hkv, D)
    return decode_attention_reference(q, k, v, lengths)


def paged_decode_attention(q, pool_k, pool_v, tables, lengths):
    """Single-token attention through block tables: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. Same arguments as
    :func:`paged_decode_attention_reference`."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, pool_k, pool_v, tables,
                                                lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, "
                         f"got {q.device}")
    B, H, D = q.shape
    nb, bs, Hkv, _ = pool_k.shape
    check_limits(H, Hkv, D)
    tables = as_index(tables, q.device)
    lengths = as_index(lengths, q.device)
    code = check_cuda("paged_decode", (q, pool_k, pool_v),
                      (tables, lengths))
    mb = tables.shape[1]
    sl, n_split = plan(B, Hkv, mb * bs, sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    launch("paged_decode", q, pool_k, pool_v, tables, lengths, out,
           *scratch(B, Hkv, H // Hkv, D, n_split, q.device), B, H, Hkv, D,
           nb, bs, mb, sl, n_split, code)
    LAST_GRID.update(split_len=sl, n_split=n_split,
                     blocks=n_split * Hkv * B)
    return out
