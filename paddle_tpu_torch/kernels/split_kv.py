"""The host side of the split-KV walk (``paddle_tpu_torch/csrc/
split_kv.cuh``) that paged decode, dense decode and the span-1 rows of
ragged attention share: the split rule, the fp32 partials each launch
allocates, and the per-(row, KV head) tickets every launch leaves zero.

The walk cuts each row's keys into splits of :func:`split_len` keys; one
block per (split, KV head, row) walks a split in :data:`PAGE`-key pages
(a quantized pool with G * D <= :data:`NARROW_MAX_GD`:
:func:`narrow_page`-key pages, each of the block's :data:`WARPS` warps
owning a quarter of every page with its own online softmax, the warps
combined at the end of the split), and the last block of a (row, KV
head) to finish combines the splits' partials in split order.

Streams: the tickets are one buffer a device, which every launch leaves
zero, so launches that share it must be ordered on one stream. Every
caller launches on the port's current stream, which is the device's
default stream on every thread: an engine fleet's replicas, each driven
from a thread of its own, share it too (their graph replays included).
Separate streams a replica would need buffers a stream (ROADMAP Queue B
item 6).
"""
from __future__ import annotations

import functools
import threading

import torch

from ._launch import check_head_dim, padded_dim

#: keys a page: the walk's step, and the unit of a split
PAGE = 32
#: warps a block (128 threads)
WARPS = 4
#: bytes of K (and of V) a page of a quantized pool's walk
NARROW_PAGE_BYTES = 8192
#: the largest G * D that walk takes; a quantized pool's KV head with more
#: (more accumulator registers a thread) takes the page walk
NARROW_MAX_GD = 4 * 128
#: a full-capacity batch gets at least this many blocks an SM
BLOCKS_PER_SM = 8
#: the shortest split, in pages: its fp32 partials stay small beside the
#: K/V bytes it reads
MIN_SPLIT_PAGES = 8
#: the walk keeps G * Dp accumulator elements (Dp: the head dim's padded
#: width) in 16 registers of each of its 128 threads
MAX_GD = 16 * 128

_TICKETS = {}
_TICKETS_LOCK = threading.Lock()
# ticket buffers outgrown by a larger launch: kept alive, since a CUDA
# graph captured over one goes on reading it at every replay
_OUTGROWN = []


def split_len(B, Hkv, capacity, n_sm):
    """Keys a split (a multiple of :data:`PAGE`): rows as long as
    ``capacity`` (the longest the cache holds: the lengths live on the
    device, and reading them would stall the host) split so that the grid
    has at least :data:`BLOCKS_PER_SM` blocks on each of ``n_sm`` SMs, and
    no split is shorter than :data:`MIN_SPLIT_PAGES` pages."""
    pages = -(-max(capacity, 1) // PAGE)
    splits = -(-BLOCKS_PER_SM * n_sm // max(B * Hkv, 1))
    return max(MIN_SPLIT_PAGES, -(-pages // splits)) * PAGE


def narrow_page(D):
    """Keys a page of the quantized walk at head dim ``D`` (one byte an
    element of its padded width): 128, 64 and 32 at D = 64, 128 and 256
    (and the dims that pad to them) — a bf16 page's bytes; each warp owns
    ``narrow_page(D) // WARPS`` of them."""
    return NARROW_PAGE_BYTES // padded_dim(D)


def check_heads(name, H, Hkv, D):
    """Raise on a head geometry kernel ``name`` does not take: ``H`` query
    heads over ``Hkv`` KV heads of ``D`` (a head dim the kernels take),
    the KV head's G query heads of its padded width fitting the walk's
    accumulator."""
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    check_head_dim(name, D)
    if H // Hkv * padded_dim(D) > MAX_GD:
        raise NotImplementedError(f"{name} kernel: {H // Hkv} query heads "
                                  f"a KV head of {D} (padded to "
                                  f"{padded_dim(D)}) exceed {MAX_GD} "
                                  f"accumulator elements")


@functools.lru_cache(maxsize=None)
def sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tickets(dev, n):
    """The per-(row, KV head) ticket counters of ``dev``: zeros, and each
    launch leaves them zero. All three callers share them, so they run on
    one stream at a time (the port's current stream)."""
    with _TICKETS_LOCK:
        t = _TICKETS.get(dev)
        if t is None or t.numel() < n:
            if t is not None:
                _OUTGROWN.append(t)
            t = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
            _TICKETS[dev] = t
        return t


def plan(B, Hkv, capacity, n_sm):
    """``(split_len, n_split)`` for ``B`` rows of up to ``capacity`` keys
    on a card of ``n_sm`` SMs."""
    sl = split_len(B, Hkv, capacity, n_sm)
    return sl, -(-max(capacity, 1) // sl)


def scratch(B, Hkv, G, D, n_split, dev):
    """``(part_m, part_l, part_acc, tickets)`` of one launch at head dim
    ``D``: fp32 partials ``[B, Hkv, n_split, G]`` (twice) and ``[B, Hkv,
    n_split, G, Dp]`` (Dp the padded width the walk runs at) in one
    allocation, and the shared tickets."""
    D = padded_dim(D)
    n = B * Hkv * n_split * G
    part = torch.empty(n * (D + 2), dtype=torch.float32, device=dev)
    return (part[n * D:n * (D + 1)], part[n * (D + 1):], part[:n * D],
            _tickets(dev, B * Hkv))
