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
fetched. Full-precision pools only (float32, bfloat16).

:func:`paged_decode_attention` is the wrapper: plain version for CPU
tensors, the kernel for CUDA tensors. :func:`split_len` is the split
rule; :data:`LAST_GRID` records the last launch's split and grid.
"""
from __future__ import annotations

import functools

import torch

from ._launch import as_index, check_cuda, launch
from .decode import decode_attention_reference

#: keys a page: the kernel's step, and the unit of a split
PAGE = 32
#: a full-capacity batch gets at least this many blocks an SM
BLOCKS_PER_SM = 8
#: the shortest split, in pages: its fp32 partials stay small beside the
#: K/V bytes it reads
MIN_SPLIT_PAGES = 8
#: the kernel keeps G * D accumulator elements in 16 registers of each of
#: its 128 threads
MAX_GD = 16 * 128

#: the last launch: keys a split, splits a row, blocks in the grid
LAST_GRID = {"split_len": 0, "n_split": 0, "blocks": 0}
_TICKETS = {}


def split_len(B, Hkv, capacity, n_sm):
    """Keys a split (a multiple of :data:`PAGE`): rows as long as
    ``capacity`` (the longest the block tables hold: the lengths live on
    the device, and reading them would stall the host) split so that the
    grid has at least :data:`BLOCKS_PER_SM` blocks on each of ``n_sm``
    SMs, and no split is shorter than :data:`MIN_SPLIT_PAGES` pages."""
    pages = -(-max(capacity, 1) // PAGE)
    splits = -(-BLOCKS_PER_SM * n_sm // max(B * Hkv, 1))
    return max(MIN_SPLIT_PAGES, -(-pages // splits)) * PAGE


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tickets(dev, n):
    """The per-(row, KV head) ticket counters of ``dev``: zeros, and each
    launch leaves them zero. Launches share them, so they run on one
    stream at a time (the port's current stream)."""
    t = _TICKETS.get(dev)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _TICKETS[dev] = t
    return t


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
    G = H // Hkv
    if G * D > MAX_GD:
        raise NotImplementedError(f"paged decode kernel: {G} query heads a "
                                  f"KV head of {D} exceed {MAX_GD} "
                                  f"accumulator elements")
    tables = as_index(tables, q.device)
    lengths = as_index(lengths, q.device)
    code = check_cuda("paged_decode", (q, pool_k, pool_v),
                      (tables, lengths))
    mb = tables.shape[1]
    sl = split_len(B, Hkv, mb * bs, _sm_count(q.device.index or 0))
    n_split = -(-max(mb * bs, 1) // sl)
    n = B * Hkv * n_split * G
    part = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    launch("paged_decode", q, pool_k, pool_v, tables, lengths, out,
           part[n * D:n * (D + 1)], part[n * (D + 1):], part[:n * D],
           _tickets(q.device, B * Hkv), B, H, Hkv, D, nb, bs, mb, sl,
           n_split, code)
    LAST_GRID.update(split_len=sl, n_split=n_split,
                     blocks=n_split * Hkv * B)
    return out
