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
64 rows (and once more for each further 64).

Quantized serving (the reference kernel's modes): the pools may be int8
with per-row-per-head scale planes or ``float8_e4m3fn`` with per-block
planes (each side a ``(data, scale)`` pair, as ``PagedKVCache.kv_args``
gives them): the QKV epilogue quantizes the appended rows on write (the
pool's write rule, bit for bit) and the attention is the walk's quantized
mode, paged decode's bits. The weights may be int8 ``(q, scale)`` pairs
(``serving/decode.quantize_decode_params``); every weight value that
reaches an MMA is ``round(float(q) * scale[col])``, ``_dq``'s bits. In
bf16 a chunk of int8 weights is two tiles wide (:data:`PLAN_COLS`: 64 k
rows x 128 columns, a projection whose tiles are odd in number ends in
one tile), 8 KB of int8 in 128-byte rows like a dense chunk's 8 KB, so a
tick runs half the chunk iterations and reads half the rows; each warp
builds its MMAs' operands from the int8 tile in registers, with no bf16
copy in shared memory. :func:`part_slots` and :func:`part_size` take the
plan's columns. In float32 a chunk of int8 weights keeps the dense
tile's 32 columns and is dequantized in shared memory. With int8 weights
the head is the
parameters' int8 ``lm_head`` pair (a tied one ``[V, H]`` with its scales
along V, dequantized then read transposed, as ``_dq_head`` does); the
``head`` argument is then only the plain version's. An a8 engine never
reaches the kernel: the reference routes an a8 tick to the scanned one.

:func:`fused_decode_tick` is the wrapper: the kernel for CUDA tensors,
the plain version for CPU tensors. :func:`fused_decode_tick_reference` is
the plain version: the port's scanned tick (``serving/decode.py``
``_fused_decode_tick``) with the plain paged attention. The tick's host
metadata (lengths, append mask, top-k, temperatures, and the keys on the
first tail tick) goes over as small host-to-device copies, or stays on the
device where the caller keeps it there (the multi-tick tail); the embed
gather, the sin/cos lookup and the append coordinates are computed inside
the kernel, so a tick is exactly one kernel launch.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _build
from ._launch import check_cuda, launch
from .paged_decode import scale_mode
from .split_kv import check_heads, plan, scratch, sm_count

#: the widths (hidden, intermediate, vocabulary, and the QKV projection's
#: (nh + 2 nkv) * D) are multiples of this
WIDTH = 64
#: k rows a weight chunk (``kKC`` in the source)
CHUNK = 64
#: blocks an SM the launch may take at most (it takes as many as fit, up
#: to this): the bound :func:`part_slots` sizes the pieces' buffer for
BLOCKS_PER_SM = 4
#: output columns a GEMV tile, by dtype (``Geo<T>::NT`` in the source)
TILE_COLS = {torch.bfloat16: 64, torch.float32: 32}
#: output columns a chunk (a tile of the split-K plan) by (dtype, int8
#: weights) (``Chunk<T, W8>::CW`` in the source): two tiles for int8
#: weights in bf16 (8 KB of int8 in 128-byte rows), one otherwise
PLAN_COLS = {(torch.bfloat16, False): 64, (torch.bfloat16, True): 128,
             (torch.float32, False): 32, (torch.float32, True): 32}
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
_BARRIERS_LOCK = threading.Lock()
# barriers outgrown by a larger launch: kept alive, since a CUDA graph
# captured over one goes on reading it at every replay
_OUTGROWN = []


def _barrier(dev, groups):
    # launches sharing it are ordered on the device's default stream, as
    # the split-KV tickets are (kernels/split_kv.py)
    with _BARRIERS_LOCK:
        bar = _BARRIERS.get(dev.index)
        if bar is None or bar.numel() < 3 + groups:
            if bar is not None:
                _OUTGROWN.append(bar)
            bar = _BARRIERS[dev.index] = torch.zeros(3 + groups,
                                                     dtype=torch.int32,
                                                     device=dev)
        return bar


def check_limits(nh, nkv, D, hidden, inter, vocab):
    """Raise on a geometry the kernel does not take: ``nh`` query heads
    over ``nkv`` KV heads of head dim ``D``; hidden, intermediate and
    vocabulary widths, and the QKV width. Any row count is taken."""
    check_heads("fused tick", nh, nkv, D)
    if hidden % WIDTH or inter % WIDTH or vocab % WIDTH \
            or (nh + 2 * nkv) * D % WIDTH:
        raise NotImplementedError(f"fused tick kernel: hidden {hidden}, "
                                  f"intermediate {inter}, vocab {vocab} and "
                                  f"QKV width {(nh + 2 * nkv) * D} must be "
                                  f"multiples of {WIDTH}")


def part_slots(N, K, cols, grid):
    """Partial-sum slots one plan tile of ``cols`` columns (the last one
    narrower where ``cols`` does not divide ``N``) of an ``N``-column
    projection over ``K`` needs at most, on a grid of up to ``grid``
    blocks: its chunks are streamed by consecutive blocks of at least
    ``C // min(grid, C)`` chunks each (``Plan`` in the source)."""
    nc = K // CHUNK
    C = -(-N // cols) * nc
    least = C // min(grid, C)
    return 2 + (nc - 1) // least


def part_size(R, nh, nkv, D, hidden, inter, vocab, cols, grid):
    """Floats of the pieces' buffer: the largest projection's slots x R x
    N (QKV, O, gate/up, down, the head) for plan tiles of ``cols``
    columns. Raises where the source's 32-bit chunk arithmetic (chunks x
    blocks) would overflow."""
    shapes = (((nh + 2 * nkv) * D, hidden), (hidden, nh * D),
              (2 * inter, hidden), (hidden, inter), (vocab, hidden))
    if max(-(-N // cols) * (K // CHUNK) for N, K in shapes) * grid \
            >= 2 ** 31:
        raise NotImplementedError("fused tick kernel: projections too wide "
                                  "for its 32-bit chunk numbering")
    return max(part_slots(N, K, cols, grid) * R * N for N, K in shapes)


def _meta(lens, app_mask, top_ks, temps, dev):
    """The kernel's ``[4R]`` int32 metadata: lengths, append mask, top-k
    and the temperatures' bits. Host arrays go over in one copy; device
    tensors (the multi-tick tail keeps its lengths and alive mask on the
    device, and its top-k and temperatures there for the step) are joined
    on the device, with no host copy."""
    if isinstance(lens, torch.Tensor) and lens.device.type == "cuda":
        return torch.cat([lens.to(torch.int32), app_mask.to(torch.int32),
                          top_ks.to(torch.int32),
                          temps.to(torch.float32).view(torch.int32)])
    meta = np.concatenate([
        np.asarray(lens, np.int64).astype(np.int32),
        np.asarray(app_mask, np.int64).astype(np.int32),
        np.asarray(top_ks, np.int64).astype(np.int32),
        np.asarray(temps, np.float32).view(np.int32)])
    return torch.from_numpy(meta).to(dev)


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
    out = _fused_decode_tick(
        [params], head, tables, tables_dev, sin, cos, tok, [pool_k],
        [pool_v], lens, kys, app_mask, temps, top_ks, nh=nh, nkv=nkv, hd=hd,
        eps=eps, attn=paged_decode_attention_reference,
        return_logits=return_logits)
    return (out[0], out[1][0], out[2][0]) + tuple(out[3:])   # one shard


def _w8_head(params, H, V):
    """The int8 lm head of quantized parameters: ``(q, scale, tied)``,
    ``q [H, V]`` with scales ``[1, V]``, or tied ``q [V, H]`` with scales
    ``[V, 1]`` (the scales lie along V either way)."""
    q, sc = params["lm_head"]
    if tuple(sc.shape) == (1, V) and tuple(q.shape) == (H, V):
        return q, sc, 0
    if tuple(sc.shape) == (V, 1) and tuple(q.shape) == (V, H):
        return q, sc, 1
    raise ValueError(f"int8 lm head {tuple(q.shape)} / {tuple(sc.shape)} "
                     f"is neither [H, V] nor the tied [V, H]")


def fused_decode_tick(params, head, tables, tables_dev, sin, cos, tok,
                      pool_k, pool_v, lens, kys, app_mask, temps, top_ks, *,
                      nh, nkv, hd, eps, return_logits=False):
    """One decode tick over all rows: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. The arguments are those of the
    scanned tick: stacked ``params``, ``head`` (the lm head, or the
    embedding transposed when tied), tables ``[R, mb]`` as numpy and as an
    int32 device tensor, RoPE tables ``[S, D]``, last tokens ``tok [R]``,
    pools ``[L, nb, bs, Hkv, D]`` (written in place; a quantized side is a
    ``(data, scale)`` pair), ``lens`` and
    ``app_mask [R]`` (host arrays, or on the kernel's path device tensors,
    with ``temps``/``top_ks`` then device tensors too), keys ``[R, 2]``
    (host uint32 values, or the device keys a previous launch returned),
    ``temps``/``top_ks [R]``.

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
    quant = isinstance(pool_k, tuple)
    (pk, ks), (pv, vs) = (pool_k, pool_v) if quant else \
        ((pool_k, None), (pool_v, None))
    L, nb, bs, Hkv, D = pk.shape
    R = tok.shape[0]
    w8 = isinstance(params["wq"], tuple)
    inter = (params["w_gate"][0] if w8 else params["w_gate"]).shape[2]
    mb = tables_dev.shape[1]
    if D != hd or Hkv != nkv or nh % nkv:
        raise ValueError(f"pool heads {Hkv} x {D} / nkv {nkv} x {hd} / nh "
                         f"{nh} disagree")
    check_limits(nh, nkv, D, H, inter, V)
    mode = scale_mode(pk[0], None if ks is None else ks[0],
                      None if vs is None else vs[0])
    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    if w8:
        hq, hs, tied = _w8_head(params, H, V)
        weights = [params[k][0] for k in names] + [hq]
        wscales = [params[k][1] for k in names] + [hs]
        for q, sc in zip(weights, wscales):
            if q.dtype != torch.int8 or sc.dtype != torch.float32 \
                    or not q.is_contiguous() or not sc.is_contiguous() \
                    or sc.numel() != (q.shape[0] if q is hq and tied
                                      else q.numel() // q.shape[-2]):
                raise ValueError("fused tick kernel: int8 weights must be "
                                 "contiguous int8 with float32 scales, one "
                                 "an output column")
        head_arg = hq
    else:
        wscales = [None] * 8
        if head.shape != (H, V):
            raise ValueError(f"head {tuple(head.shape)} is not [{H}, {V}]")
        if head.is_contiguous():
            tied, head_arg = 0, head
        elif head.stride() == (1, H) and head.data_ptr() == embed.data_ptr():
            tied, head_arg = 1, embed          # read [V, H] transposed
        else:
            raise ValueError("fused tick kernel: the head must be a "
                             "contiguous [H, V] weight or the embedding "
                             "transposed")
        weights = [params[k] for k in names] + [head_arg]
    norms = [params["input_ln"], params["post_ln"]]
    meta_dev = _meta(lens, app_mask, top_ks, temps, dev)
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
                      [embed, params["final_norm"]] + norms
                      + ([] if w8 else weights),
                      (tables_dev, meta_dev, keys_dev), pools=(pk, pv))
    for t in (ks, vs) if quant else ():
        if not t.is_contiguous() or t.device != dev:
            raise ValueError("fused tick kernel: scale planes must be "
                             "contiguous on the tokens' device")
    for t in weights if w8 else ():
        if t.device != dev or t.data_ptr() % 16:
            raise ValueError("fused tick kernel: int8 weights must be "
                             "16-byte aligned on the tokens' device")
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
    part = torch.empty(part_size(R, nh, nkv, D, H, inter, V,
                                 PLAN_COLS[embed.dtype, w8],
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
    # the library of this (pool mode, int8 weights) pair
    launch(_build.FUSED_VARIANTS[mode, w8], tok, embed, *weights[:7], *norms,
           params["final_norm"], head_arg, pk, pv, sin, cos, tables_dev,
           meta_dev, keys_dev, h, hn, q, attn, act, part, logits, nxt,
           keys_out, bar, *walk, ks, vs, *wscales, R, L, H, nh, nkv, inter,
           V, nb, bs, mb, sin.shape[0], tied, sl, n_split, D, code,
           float(eps), BLOCKS_PER_SM, ctypes.addressof(grid),
           count_as="fused_decode_tick")
    LAST_GRID.update(blocks=grid.value, blocks_per_sm=grid.value // n_sm,
                     split_len=sl, n_split=n_split)
    LAST_SCRATCH.update(q=q, attn=attn)
    out = (nxt, pool_k, pool_v, keys_out)
    return out + (logits,) if return_logits else out
