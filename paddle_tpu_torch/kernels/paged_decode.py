"""Paged decode attention: one query token per sequence attends its cache
through a block table over the shared KV pool.

Replaces ``paddle_tpu/kernels/pallas_paged_decode.py`` (``_paged_kernel``
via ``_paged_call``, entry ``paged_decode_attention_pallas``); the CUDA
kernel is ``paddle_tpu_torch/csrc/paged_decode.cu``. What bounds it on the
H100: bytes — each cached K/V row is read once for ``4*D`` flops per head.
Its design reads only the valid length of each row (no block past it is
fetched), one block per (row, head), 16-byte loads, GQA by indexing the KV
head (no repeated K/V). Full-precision pools only (float32, bfloat16).

:func:`paged_decode_attention` is the wrapper: plain version for CPU
tensors, the kernel for CUDA tensors.
"""
from __future__ import annotations

import torch

from ._launch import as_index, check_cuda, launch
from .decode import decode_attention_reference


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
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if D not in (64, 128, 256):
        raise NotImplementedError(f"paged decode kernel: head_dim {D} not "
                                  f"in (64, 128, 256)")
    tables = as_index(tables, q.device)
    lengths = as_index(lengths, q.device)
    code = check_cuda("paged_decode", (q, pool_k, pool_v),
                      (tables, lengths))
    out = torch.empty_like(q)
    launch("paged_decode", q, pool_k, pool_v, tables, lengths, out, B, H,
           Hkv, D, nb, bs, tables.shape[1], code)
    return out
