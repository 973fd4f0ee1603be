"""Ragged paged attention: a packed buffer of variable-length query spans
(decode rows are spans of 1, prefill chunks spans of n) attends causally
within each span through per-sequence block tables.

Replaces ``paddle_tpu/kernels/pallas_ragged_attention.py``
(``_ragged_kernel`` via ``_ragged_call``, the ``pallas_call`` at
``:238``; entry ``ragged_paged_attention_pallas``); the CUDA kernels are
in ``paddle_tpu_torch/csrc/ragged_attention.cu``. What bounds it on the
H100: bytes for decode rows, operations for a long prefill chunk. So one
call launches two grids back to back, each shaped for one kind of span
(:func:`grid`; the spans live on the device, so the shapes alone size
both, and each block reads its own row's span):

- span-1 rows (``qlen == 1``) take paged decode's split-KV walk
  (``csrc/split_kv.cuh``): one block per (split, KV head, sequence), the
  split rule of :mod:`.split_kv` over ``R`` rows of the tables' capacity;
- chunk spans (``qlen >= 2``) take a tile grid, one block per (tile of
  the span, sequence, head): in bfloat16 the flash forward's ``wgmma``
  tile on the tensor cores (64 span rows a block, 64-key K/V tiles read
  through the table), in float32 the CUDA-core tile routine (16 rows,
  32-key tiles). Key tiles crossing any row's causal limit are masked,
  since a chunk may start mid-block.

Blocks of the other kind of span, and tiles past a span, exit at once.
A span-1 row agrees with :func:`~.paged_decode.paged_decode_attention`
within ``chip_smoke.py``'s ``TOL`` (the same walk, split at other
lengths). Full-precision pools only (float32, bfloat16); head dims 64
and 128. One launch counted a call.

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
from .split_kv import check_heads, plan, scratch, sm_count

NEG_INF = -1e30
#: head dims the kernels take
HEAD_DIMS = (64, 128)
#: span rows a chunk tile holds, by input type: the wgmma tile (bf16) and
#: the CUDA-core tile (float32)
TILE_ROWS = {torch.bfloat16: 64, torch.float32: 16}
#: the last launch: the split-KV grid (split length, splits a row, blocks)
#: and the chunk tile grid (rows a tile, blocks)
LAST_GRID = {"split_len": 0, "n_split": 0, "split_blocks": 0,
             "tile_rows": 0, "tile_blocks": 0}


def check_limits(H, Hkv, D):
    """Raise on a head geometry the kernels do not take: ``H`` query
    heads over ``Hkv`` KV heads of ``D``."""
    check_heads("ragged attention", H, Hkv, D, HEAD_DIMS)


def paths(qlen):
    """Which grid serves each sequence: ``"split"`` for a span-1 row,
    ``"tile"`` for a chunk span, ``"dead"`` for an empty one."""
    return ["split" if n == 1 else "tile" if n >= 2 else "dead"
            for n in _host_ints(qlen)]


def grid(T, R, H, Hkv, capacity, dtype, n_sm):
    """Both grids of a call from shapes alone: ``T`` packed rows, ``R``
    sequences, tables of ``capacity`` keys, on a card of ``n_sm`` SMs."""
    sl, n_split = plan(R, Hkv, capacity, n_sm)
    rows = TILE_ROWS[dtype]
    return {"split_len": sl, "n_split": n_split,
            "split_blocks": n_split * Hkv * R, "tile_rows": rows,
            "tile_blocks": -(-T // rows) * R * H}


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
    check_limits(H, Hkv, D)
    tables = as_index(tables, q.device)
    qstart = as_index(qstart, q.device)
    qlen = as_index(qlen, q.device)
    kvlen = as_index(kvlen, q.device)
    code = check_cuda("ragged_attention", (q, pool_k, pool_v),
                      (tables, qstart, qlen, kvlen))
    R, mb = tables.shape
    g = grid(T, R, H, Hkv, mb * bs, q.dtype, sm_count(q.device.index or 0))
    out = torch.zeros_like(q)     # rows outside every span stay zero
    launch("ragged_attention", q, pool_k, pool_v, tables, qstart, qlen,
           kvlen, out,
           *scratch(R, Hkv, H // Hkv, D, g["n_split"], q.device), T, R, H,
           Hkv, D, nb, bs, mb, g["split_len"], g["n_split"], code)
    LAST_GRID.update(g)
    return out
