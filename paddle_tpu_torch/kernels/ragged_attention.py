"""Ragged paged attention: a packed buffer of variable-length query spans
(decode rows are spans of 1, prefill chunks spans of n) attends causally
within each span through per-sequence block tables.

Replaces ``paddle_tpu/kernels/pallas_ragged_attention.py``
(``_ragged_kernel`` via ``_ragged_call``, entry
``ragged_paged_attention_pallas``); the CUDA kernel is
``paddle_tpu_torch/csrc/ragged_attention.cu``. What bounds it on the H100:
bytes for decode rows, operations for a long prefill chunk. Its design:
one block per (sequence, 16-token tile of its span, head); tiles past a
span exit at once; each tile walks keys only up to its last causal
position; a span-1 row agrees with
:func:`~.paged_decode.paged_decode_attention` (a split-KV kernel that rounds
P per page against each split's running max) within ``chip_smoke.py``'s
``TOL``.
Full-precision pools only (float32, bfloat16).

Semantics per sequence ``r`` (``qlen[r] == 0`` is a dead row): span token
``i`` is packed row ``qstart[r] + i``, sits at logical position
``kvlen[r] - qlen[r] + i`` and attends positions ``0 .. that``; packed
rows outside every span come back as exact zeros.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ._launch import as_index, check_cuda, launch

NEG_INF = -1e30


def _host_ints(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                      np.int64).reshape(-1)


def ragged_attention_reference(q, pool_k, pool_v, tables, qstart, qlen,
                               kvlen):
    """Plain version of ``paddle_tpu``'s ``ragged_attention_reference``:
    the same gather (sentinel entries clamp into the pool), masks, plain
    softmax and cast points, computed one sequence at a time so the
    per-token gather never materialises ``[T, s_tot, H, D]``.

    q [T, H, D]; pool_k/pool_v [nb, bs, Hkv, D]; tables [R, mb];
    qstart/qlen/kvlen [R]. Returns [T, H, D]."""
    T, H, D = q.shape
    nb, bs, Hkv, _ = pool_k.shape
    G = H // Hkv
    tables = torch.as_tensor(tables).to(q.device).long().clamp(0, nb - 1)
    R, mb = tables.shape
    s_tot = mb * bs
    scale = 1.0 / math.sqrt(D)
    qs, ql, kl = _host_ints(qstart), _host_ints(qlen), _host_ints(kvlen)
    out = torch.zeros_like(q)
    cols = torch.arange(s_tot, device=q.device)
    for r in range(R):
        n = int(ql[r])
        if n <= 0:
            continue
        a = int(qs[r])
        k = pool_k[tables[r]].reshape(s_tot, Hkv, D)
        v = pool_v[tables[r]].reshape(s_tot, Hkv, D)
        if G > 1:
            k = k.repeat_interleave(G, dim=1)
            v = v.repeat_interleave(G, dim=1)
        pos = int(kl[r]) - n + torch.arange(n, device=q.device)
        mask = cols[None, :] <= pos[:, None]                   # [n, s_tot]
        logits = torch.einsum("qhd,khd->qhk", q[a:a + n].float(),
                              k.float()) * scale
        logits = torch.where(mask[:, None, :], logits,
                             torch.full_like(logits, NEG_INF))
        probs = torch.softmax(logits, dim=-1)
        # exact zeros on masked cols + zeroed stale rows (0 * NaN = NaN)
        probs = torch.where(mask[:, None, :], probs, torch.zeros_like(probs))
        row_valid = cols < int(kl[r])
        v = torch.where(row_valid[:, None, None], v, torch.zeros_like(v))
        out[a:a + n] = torch.einsum("qhk,khd->qhd", probs.to(q.dtype), v)
    return out


def ragged_paged_attention(q, pool_k, pool_v, tables, qstart, qlen, kvlen):
    """Mixed prefill+decode attention over packed spans: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. Same arguments
    as :func:`ragged_attention_reference`."""
    if q.device.type == "cpu":
        return ragged_attention_reference(q, pool_k, pool_v, tables, qstart,
                                          qlen, kvlen)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu, "
                         f"got {q.device}")
    T, H, D = q.shape
    nb, bs, Hkv, _ = pool_k.shape
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if D not in (64, 128, 256):
        raise NotImplementedError(f"ragged attention kernel: head_dim {D} "
                                  f"not in (64, 128, 256)")
    tables = as_index(tables, q.device)
    qstart = as_index(qstart, q.device)
    qlen = as_index(qlen, q.device)
    kvlen = as_index(kvlen, q.device)
    code = check_cuda("ragged_attention", (q, pool_k, pool_v),
                      (tables, qstart, qlen, kvlen))
    out = torch.zeros_like(q)     # rows outside every span stay zero
    launch("ragged_attention", q, pool_k, pool_v, tables, qstart, qlen,
           kvlen, out, T, tables.shape[0], H, Hkv, D, nb, bs,
           tables.shape[1], code)
    return out
