"""The fused decode tick: one decode tick of the serving stack — every
layer's norms, projections, RoPE, paged K/V append and paged attention,
then the final norm, the lm head and the per-row sample — as ONE kernel
launch.

Replaces ``paddle_tpu/kernels/pallas_fused_decode_tick.py``
(``_fused_tick_pallas``, its ``pallas_call`` at ``:335``; entry
``fused_decode_tick``); the CUDA kernel is
``paddle_tpu_torch/csrc/fused_decode_tick.cu``. What bounds it on the
H100: bytes — a tick reads every decoder weight once (13.2 GB for
LLaMA-7B in bf16) plus the valid cached K/V, for about two flops per
weight and row. Its design is one cooperative persistent launch (as many
128-thread blocks as fit, at most :data:`BLOCKS_PER_SM` an SM; 3 at the
7B bf16 tick, 396 blocks) with a grid-wide barrier between dependent
phases, 7 a layer:

- every projection (QKV, O, gate/up, down, the lm head) cut into tiles of
  64 (bf16) or 32 (fp32) output columns by chunks of 64 k rows, each
  block streaming an equal share of the chunks (split-K where a phase has
  few tiles) through a 4-stage ``cp.async`` ring of 16-byte copies; bf16
  on the tensor cores (``mma.sync.m16n8k16``, the weight tile as A by
  ``ldmatrix.trans``, 8 rows of X as B), fp32 on the CUDA cores. A
  block's share of a tile is a piece: its fp32 partial sums go to a
  scratch buffer (:func:`part_slots` sizes it), and the block that
  completes a group of tiles (a QKV head, a gate tile and its up tile,
  else one tile) adds their pieces in a fixed order and runs the
  epilogue: RoPE and the K/V append, the residual add, SiLU(gate) * up,
  the logits;
- the attention on the split-KV walk of ``csrc/split_kv.cuh`` at
  :func:`.split_kv.plan`'s split, over the pool after this tick's append:
  the paged decode kernel's output bit for bit at the same q, pool and
  lengths;
- RMSNorm a block per row; the sampling epilogue (threefry split,
  first-max greedy, top-k by radix select, Gumbel-max) in the same launch.

The rows take any count: accumulators live in shared memory in tiles of
8 rows, so every weight is read from device memory once a tick for up to
64 rows (and once more for each further 64). Full-precision pools and
dense weights only; int8/fp8 pools and int8 weights raise at the engine.

:func:`fused_decode_tick` is the wrapper: the kernel for CUDA tensors,
the plain version for CPU tensors. :func:`fused_decode_tick_reference` is
the plain version: the port's scanned tick (``serving/decode.py``
``_fused_decode_tick``) with the plain paged attention. The tick's host
metadata (lengths, append mask, top-k, temperatures, and the keys on the
first tail tick) goes over as small host-to-device copies; the embed
gather, the sin/cos lookup and the append coordinates are computed inside
the kernel, so a tick is exactly one kernel launch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._launch import check_cuda, launch
from .split_kv import check_heads, plan, scratch, sm_count

#: head dims the kernel takes
HEAD_DIMS = (64, 128)
#: the widths (hidden, intermediate, vocabulary) are multiples of this
WIDTH = 64
#: k rows a weight chunk (``kKC`` in the source)
CHUNK = 64
#: blocks an SM the launch may take at most (it takes as many as fit, up
#: to this): the bound :func:`part_slots` sizes the pieces' buffer for
BLOCKS_PER_SM = 4
#: output columns a GEMV tile, by dtype (``Geo<T>::NT`` in the source)
TILE_COLS = {torch.bfloat16: 64, torch.float32: 32}
#: the last launch, for reports: its grid (blocks co-resident on the
#: card), blocks an SM, and the attention's split length and splits a row
LAST_GRID = {"blocks": 0, "blocks_per_sm": 0, "split_len": 0, "n_split": 0}
#: the last launch's query and attention-output buffers ``[R, nh, D]``: the
#: last layer's, for tests and ``chip_smoke.py`` to hold the attention
#: against the paged decode kernel
LAST_SCRATCH = {}
# one zeroed int32 buffer per device: the grid barrier's two words, the
# attention items' counter, then a ticket per GEMV group (a head of QKV,
# a tile of the others); the kernel leaves it ready for the next launch
_BARRIERS = {}


def _barrier(dev, groups):
    bar = _BARRIERS.get(dev.index)
    if bar is None or bar.numel() < 3 + groups:
        bar = _BARRIERS[dev.index] = torch.zeros(3 + groups,
                                                 dtype=torch.int32,
                                                 device=dev)
    return bar


def check_limits(nh, nkv, D, hidden, inter, vocab):
    """Raise on a geometry the kernel does not take: ``nh`` query heads
    over ``nkv`` KV heads of head dim ``D``; hidden, intermediate and
    vocabulary widths. Any row count is taken."""
    check_heads("fused tick", nh, nkv, D, HEAD_DIMS)
    if hidden % WIDTH or inter % WIDTH or vocab % WIDTH:
        raise NotImplementedError(f"fused tick kernel: hidden {hidden}, "
                                  f"intermediate {inter} and vocab {vocab} "
                                  f"must be multiples of {WIDTH}")


def part_slots(N, K, cols, grid):
    """Partial-sum slots one tile of an ``N``-column projection over ``K``
    needs at most, on a grid of up to ``grid`` blocks: its chunks are
    streamed by consecutive blocks of at least ``C // min(grid, C)`` chunks
    each (``Plan`` in the source)."""
    nc = K // CHUNK
    C = N // cols * nc
    least = C // min(grid, C)
    return 2 + (nc - 1) // least


def part_size(R, nh, nkv, D, hidden, inter, vocab, cols, grid):
    """Floats of the pieces' buffer: the largest projection's slots x R x
    N (QKV, O, gate/up, down, the head). Raises where the source's 32-bit
    chunk arithmetic (chunks x blocks) would overflow."""
    shapes = (((nh + 2 * nkv) * D, hidden), (hidden, nh * D),
              (2 * inter, hidden), (hidden, inter), (vocab, hidden))
    if max(N // cols * (K // CHUNK) for N, K in shapes) * grid >= 2 ** 31:
        raise NotImplementedError("fused tick kernel: projections too wide "
                                  "for its 32-bit chunk numbering")
    return max(part_slots(N, K, cols, grid) * R * N for N, K in shapes)


def fused_decode_tick_reference(params, head, tables, tables_dev, sin, cos,
                                tok, pool_k, pool_v, lens, kys, app_mask,
                                temps, top_ks, *, nh, nkv, hd, eps,
                                return_logits=False):
    """Plain version: the scanned tick with the plain paged attention (a
    call back into ``serving/decode.py``; lazy import, since that module
    imports this one). Same arguments and returns as
    :func:`fused_decode_tick`."""
    from ..serving.decode import _fused_decode_tick
    from .paged_decode import paged_decode_attention_reference
    return _fused_decode_tick(
        params, head, tables, tables_dev, sin, cos, tok, pool_k, pool_v,
        lens, kys, app_mask, temps, top_ks, nh=nh, nkv=nkv, hd=hd, eps=eps,
        attn=paged_decode_attention_reference, return_logits=return_logits)


def fused_decode_tick(params, head, tables, tables_dev, sin, cos, tok,
                      pool_k, pool_v, lens, kys, app_mask, temps, top_ks, *,
                      nh, nkv, hd, eps, return_logits=False):
    """One decode tick over all rows: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. The arguments are those of the
    scanned tick: stacked ``params``, ``head`` (the lm head, or the
    embedding transposed when tied), tables ``[R, mb]`` as numpy and as an
    int32 device tensor, RoPE tables ``[S, D]``, last tokens ``tok [R]``,
    pools ``[L, nb, bs, Hkv, D]`` (written in place), host ``lens`` and
    ``app_mask [R]``, keys ``[R, 2]`` (host uint32 values, or the device
    keys a previous launch returned), ``temps``/``top_ks [R]``.

    Returns ``(next_tok [R], pool_k, pool_v, keys' [R, 2])``, plus the
    float32 logits ``[R, V]`` with ``return_logits``; the caller advances
    ``lens`` by ``app_mask``."""
    if tok.device.type == "cpu":
        return fused_decode_tick_reference(
            params, head, tables, tables_dev, sin, cos, tok, pool_k, pool_v,
            lens, kys, app_mask, temps, top_ks, nh=nh, nkv=nkv, hd=hd,
            eps=eps, return_logits=return_logits)
    if tok.device.type != "cuda":
        raise ValueError(f"fused_decode_tick runs on cuda or cpu, got "
                         f"{tok.device}")
    dev = tok.device
    embed = params["embed"]
    V, H = embed.shape
    L, nb, bs, Hkv, D = pool_k.shape
    R = tok.shape[0]
    inter = params["w_gate"].shape[2]
    mb = tables_dev.shape[1]
    if D != hd or Hkv != nkv or nh % nkv:
        raise ValueError(f"pool heads {Hkv} x {D} / nkv {nkv} x {hd} / nh "
                         f"{nh} disagree")
    check_limits(nh, nkv, D, H, inter, V)
    if head.shape != (H, V):
        raise ValueError(f"head {tuple(head.shape)} is not [{H}, {V}]")
    if head.is_contiguous():
        tied, head_arg = 0, head
    elif head.stride() == (1, H) and head.data_ptr() == embed.data_ptr():
        tied, head_arg = 1, embed          # read [V, H] transposed
    else:
        raise ValueError("fused tick kernel: the head must be a contiguous "
                         "[H, V] weight or the embedding transposed")
    weights = [params[k] for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                   "w_down", "input_ln", "post_ln")]
    meta = np.concatenate([
        np.asarray(lens, np.int64).astype(np.int32),
        np.asarray(app_mask, np.int64).astype(np.int32),
        np.asarray(top_ks, np.int64).astype(np.int32),
        np.asarray(temps, np.float32).view(np.int32)])
    meta_dev = torch.from_numpy(meta).to(dev)
    if isinstance(kys, torch.Tensor) and kys.device.type == "cuda":
        keys_dev = kys
    else:
        host = kys.numpy() if isinstance(kys, torch.Tensor) else kys
        keys_dev = torch.from_numpy(np.ascontiguousarray(
            np.asarray(host, np.int64).astype(np.uint32).view(np.int32))).to(
                dev)
    tok = tok.contiguous()
    if tok.dtype != torch.int64:
        raise TypeError(f"fused tick kernel: tokens must be int64, got "
                        f"{tok.dtype}")
    code = check_cuda("fused_decode_tick",
                      [embed, head_arg, pool_k, pool_v, params["final_norm"]]
                      + weights, (tables_dev, meta_dev, keys_dev))
    for t in (sin, cos):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != dev or t.shape[1] != D:
            raise ValueError("fused tick kernel: sin/cos must be contiguous "
                             "float32 [S, D] on the tokens' device")
    emp = lambda *s: torch.empty(s, dtype=embed.dtype, device=dev)  # noqa
    h, hn = emp(R, H), emp(R, H)
    q, attn = emp(R, nh, D), emp(R, nh, D)
    act = emp(R, inter)
    n_sm = sm_count(dev.index or 0)
    cols = TILE_COLS[embed.dtype]
    part = torch.empty(part_size(R, nh, nkv, D, H, inter, V, cols,
                                 BLOCKS_PER_SM * n_sm),
                       dtype=torch.float32, device=dev)
    sl, n_split = plan(R, nkv, mb * bs, n_sm)
    walk = scratch(R, nkv, nh // nkv, D, n_split, dev)
    logits = torch.empty(R, V, dtype=torch.float32, device=dev)
    nxt = torch.empty(R, dtype=torch.int64, device=dev)
    keys_out = torch.empty(R, 2, dtype=torch.int32, device=dev)
    bar = _barrier(dev, max(nh + 2 * nkv, inter // cols, H // cols,
                            V // cols))
    grid = ctypes.c_int(0)
    launch("fused_decode_tick", tok, embed, *weights[:7], weights[7],
           weights[8], params["final_norm"], head_arg, pool_k, pool_v, sin,
           cos, tables_dev, meta_dev, keys_dev, h, hn, q, attn, act, part,
           logits, nxt, keys_out, bar, *walk, R, L, H, nh, nkv, inter, V,
           nb, bs, mb, sin.shape[0], tied, sl, n_split, D, code, float(eps),
           BLOCKS_PER_SM, ctypes.addressof(grid))
    LAST_GRID.update(blocks=grid.value, blocks_per_sm=grid.value // n_sm,
                     split_len=sl, n_split=n_split)
    LAST_SCRATCH.update(q=q, attn=attn)
    out = (nxt, pool_k, pool_v, keys_out)
    return out + (logits,) if return_logits else out
