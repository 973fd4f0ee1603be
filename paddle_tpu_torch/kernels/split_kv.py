"""The host side of the split-KV walk (``paddle_tpu_torch/csrc/
split_kv.cuh``) that paged decode, dense decode and the span-1 rows of
ragged attention share: the split rule, the fp32 partials each launch
allocates, and the per-(row, KV head) tickets every launch leaves zero.

The walk cuts each row's keys into splits of :func:`split_len` keys; one
block per (split, KV head, row) walks a split in :data:`PAGE`-key pages,
and the last block of a (row, KV head) to finish combines the splits'
partials in split order.
"""
from __future__ import annotations

import functools

import torch

from ._launch import check_head_dim

#: keys a page: the walk's step, and the unit of a split
PAGE = 32
#: a full-capacity batch gets at least this many blocks an SM
BLOCKS_PER_SM = 8
#: the shortest split, in pages: its fp32 partials stay small beside the
#: K/V bytes it reads
MIN_SPLIT_PAGES = 8
#: the walk keeps G * D accumulator elements in 16 registers of each of
#: its 128 threads
MAX_GD = 16 * 128

_TICKETS = {}


def split_len(B, Hkv, capacity, n_sm):
    """Keys a split (a multiple of :data:`PAGE`): rows as long as
    ``capacity`` (the longest the cache holds: the lengths live on the
    device, and reading them would stall the host) split so that the grid
    has at least :data:`BLOCKS_PER_SM` blocks on each of ``n_sm`` SMs, and
    no split is shorter than :data:`MIN_SPLIT_PAGES` pages."""
    pages = -(-max(capacity, 1) // PAGE)
    splits = -(-BLOCKS_PER_SM * n_sm // max(B * Hkv, 1))
    return max(MIN_SPLIT_PAGES, -(-pages // splits)) * PAGE


def check_heads(name, H, Hkv, D, dims):
    """Raise on a head geometry kernel ``name`` does not take: ``H`` query
    heads over ``Hkv`` KV heads of ``D`` (one of ``dims``), the KV head's
    G query heads fitting the walk's accumulator."""
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    check_head_dim(name, D, dims)
    if H // Hkv * D > MAX_GD:
        raise NotImplementedError(f"{name} kernel: {H // Hkv} query heads "
                                  f"a KV head of {D} exceed {MAX_GD} "
                                  f"accumulator elements")


@functools.lru_cache(maxsize=None)
def sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tickets(dev, n):
    """The per-(row, KV head) ticket counters of ``dev``: zeros, and each
    launch leaves them zero. All three callers share them, so they run on
    one stream at a time (the port's current stream)."""
    t = _TICKETS.get(dev)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _TICKETS[dev] = t
    return t


def plan(B, Hkv, capacity, n_sm):
    """``(split_len, n_split)`` for ``B`` rows of up to ``capacity`` keys
    on a card of ``n_sm`` SMs."""
    sl = split_len(B, Hkv, capacity, n_sm)
    return sl, -(-max(capacity, 1) // sl)


def scratch(B, Hkv, G, D, n_split, dev):
    """``(part_m, part_l, part_acc, tickets)`` of one launch: fp32 partials
    ``[B, Hkv, n_split, G]`` (twice) and ``[B, Hkv, n_split, G, D]`` in one
    allocation, and the shared tickets."""
    n = B * Hkv * n_split * G
    part = torch.empty(n * (D + 2), dtype=torch.float32, device=dev)
    return (part[n * D:n * (D + 1)], part[n * (D + 1):], part[:n * D],
            _tickets(dev, B * Hkv))
