"""The fused decode tick: one decode tick of the serving stack — every
layer's norms, projections, RoPE, paged K/V append and paged attention,
then the final norm, the lm head and the per-row sample — as ONE kernel
launch.

Replaces ``paddle_tpu/kernels/pallas_fused_decode_tick.py``
(``_fused_tick_pallas``, entry ``fused_decode_tick``); the CUDA kernel is
``paddle_tpu_torch/csrc/fused_decode_tick.cu``. What bounds it on the
H100: bytes — a tick reads every decoder weight once (13.2 GB for
LLaMA-7B in bf16) plus the valid cached K/V, for about two flops per
weight and row. Its design is one cooperative persistent launch: as many
128-thread blocks as fit on the card at once, a grid-wide barrier between
dependent phases (so the attention reads the pool after this tick's
append), weights read by coalesced column-owning GEMV items, and the
sampling epilogue (threefry split, first-max greedy, top-k by radix
select, Gumbel-max) in the same launch. Full-precision pools and dense
weights only; int8/fp8 pools and int8 weights raise at the engine.

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

from ._launch import check_cuda, check_head_dim, launch

#: rows (batch slots) one launch takes
MAX_ROWS = 16
#: K ranges of the O and down projections (``kSplit`` in the source)
SPLIT = 4
#: the grid of the last launch, for reports (blocks co-resident on the card)
LAST_GRID = {"blocks": 0}
# one zeroed barrier buffer per device: the kernel leaves it ready for the
# next launch
_BARRIERS = {}


def check_limits(R, D, hidden, inter, vocab):
    """Raise on a geometry the kernel does not take: ``R`` rows, head dim
    ``D``, hidden, intermediate and vocabulary widths."""
    if not 1 <= R <= MAX_ROWS:
        raise NotImplementedError(
            f"fused tick kernel: {R} rows, takes 1 to {MAX_ROWS} (ROADMAP "
            f"Queue B item 6.4 lifts the cap)")
    check_head_dim("fused tick", D, (64, 128))
    if hidden % 32 or inter % 32 or vocab % 32:
        raise NotImplementedError(f"fused tick kernel: hidden {hidden}, "
                                  f"intermediate {inter} and vocab {vocab} "
                                  f"must be multiples of 32")


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
    check_limits(R, D, H, inter, V)
    if D != hd or Hkv != nkv or nh % nkv:
        raise ValueError(f"pool heads {Hkv} x {D} / nkv {nkv} x {hd} / nh "
                         f"{nh} disagree")
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
    part = torch.empty(SPLIT, R, H, dtype=torch.float32, device=dev)
    logits = torch.empty(R, V, dtype=torch.float32, device=dev)
    nxt = torch.empty(R, dtype=torch.int64, device=dev)
    keys_out = torch.empty(R, 2, dtype=torch.int32, device=dev)
    bar = _BARRIERS.get(dev.index)
    if bar is None:
        bar = _BARRIERS[dev.index] = torch.zeros(2, dtype=torch.int32,
                                                 device=dev)
    grid = ctypes.c_int(0)
    launch("fused_decode_tick", tok, embed, *weights[:7], weights[7],
           weights[8], params["final_norm"], head_arg, pool_k, pool_v, sin,
           cos, tables_dev, meta_dev, keys_dev, h, hn, q, attn, act, part,
           logits, nxt, keys_out, bar, R, L, H, nh, nkv, inter, V, nb, bs,
           mb, sin.shape[0], tied, D, code, float(eps), 0,
           ctypes.addressof(grid))
    LAST_GRID["blocks"] = grid.value
    out = (nxt, pool_k, pool_v, keys_out)
    return out + (logits,) if return_logits else out
