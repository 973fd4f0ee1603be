#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

Phases, each printing one JSON line; any failure exits nonzero:

1. device  — the card's name and power limit (``nvidia-smi``); TF32 off.
2. build   — compile the CUDA sources of ``paddle_tpu_torch/csrc`` (seven
             kernels in six sources, one ``nvcc`` each, in parallel).
3. kernels — each kernel against its plain PyTorch version, bf16 and fp32:
             the three serving kernels of the default engine and the
             dense-cache decode kernel (B=8, S_max=4096, lengths 1 to
             4096, plus a GQA check with 8 KV heads and a row of length
             0) at the LLaMA-7B serving shapes; paged and dense decode
             the same bits on two launches (with their split length and
             grid); ragged attention with both of its grids (split-KV
             blocks for span-1 rows, tile blocks for chunks: launched and
             working) plus spans of 2, 63, 64 and 65, a chunk starting
             mid-block, a chunk whose last key tile is partial and GQA
             with 8 KV heads; the fused decode tick at
             llama_7b widths, 2 layers, 8 rows (mixed lengths, one masked
             row, one sampled row) and 37 rows (past the 16 it once took,
             not a multiple of its 8-row tiles): keys bit for bit, logits
             and appended K/V rows within TOL (bf16: scaled), nothing
             written outside the appended rows, next tokens equal in fp32,
             and its layer-0 attention output bit for bit equal to the
             paged decode kernel's at the tick's own q and pool; the two
             flash-backward kernels at the training shapes (B=4, S=2048,
             32 heads of 128) plus a tail (S=300) and a GQA (8 KV heads)
             check, each bitwise equal across two launches, and the
             flash forward's O and LSE at each of those shapes; max-abs
             error against the stated tolerance, kernel / plain / library
             milliseconds (a PyTorch call on the same work, a yardstick
             the port never calls), the least time the card could take
             (``bound_ms``),
             achieved TFLOP/s and the route (the bf16 flash forward, dK/dV
             and dQ on the tensor cores, the rest on the CUDA cores).
4. engine  — llama_7b widths at 2 layers in fp32, for each of the
             engine's three decode programs (default, ``fused_tick=True``,
             ``paged_attn=False``), through the kernels against the plain
             versions (``FLAGS_use_cuda_kernels`` on, then off): the greedy
             token streams must be equal, the program's own kernel must
             launch only with the kernels on, and the fused engine's
             streams must equal the default engine's; then 20 requests
             at 32 slots (more than 16 in flight) through the default and
             the fused engine, streams equal.
5. serve   — llama_7b at full width and depth (32 layers) in bf16 with
             seeded random weights: 8 requests (7 short prompts, one long
             prompt that rides the ragged kernel in chunks, one seeded
             top-k request), 64 new tokens each, through the default
             engine, then the fused-tick engine (one fused kernel launch
             per tail tick, no paged decode; plus one tick timed at this
             depth against the scanned tick, and again with every row at
             length 1: the difference is the attention's share), then the
             dense engine (32
             decode launches per tick, no paged kernel), each freed
             before the next; each launch count must equal what the code
             implies.
6. generate — ``model.generate`` on the same model (llama_7b, 32
             layers, bf16, seed 0): B=4 prompts of 128 tokens, 64 new
             tokens, greedy and then seeded top-k twice (equal ids); both
             equal a direct ``ContinuousBatchingEngine(num_slots=4,
             prefill_bucketing="exact", decode_chunk=16)`` run with the
             same ``fold_in`` keys; flash, ragged and paged decode
             launches equal the code's count (one prefill, the unified
             steps and the tail ticks, each times 32 layers); wall time
             and tok/s. Then fp32 at 7B widths, 2 layers: the same ids
             with the kernels and with ``FLAGS_use_cuda_kernels`` off.
7. server  — ``serve(model, port=0)`` at its defaults (decode_chunk 1, 8
             slots, cost on, trace off): 8 concurrent HTTP clients (4
             blocking, 4 SSE) on the serve phase's requests, each started
             once the one before holds its slot; every stream equals a
             direct engine run admitting the requests the same way;
             ``/metrics`` parses strictly with
             ``serving_decode_compilations`` 1; ``/healthz`` ok; a
             ``/debug/trace?steps=8`` window taken during traffic holds
             ``plan``, ``launch`` and ``host-accept``; ``/debug/profile``'s
             ragged calls equal the engine's unified steps; ragged
             launches = 32 x steps with work, flash = 32 x cold-prefill
             calls, paged decode 0; TTFT and TPOT p50/p90 and the
             gateway's wall against the direct run's. The fault leg (fp32,
             7B widths, 2 layers): ``scripts/bench_chaos.py``'s plan
             ``transient@3, pool@6, fatal@10, nan@15`` through
             ``serve(..., fault_hook=plan)``: no request lost, streams
             equal the fault-free run, 2 engine restarts, peak memory
             across the rebuilds. The CLI leg: ``python -m
             paddle_tpu_torch.serving.server --preset 350m
             --decode-attention pallas --port 0 --quiet`` as a subprocess
             serves one completion and drains on SIGTERM with exit 0.
8. train_parity — llama_7b widths at 2 layers, B=1, S=500, in fp32 (the
             CUDA-core kernels) and in bf16 (the tensor-core forward,
             dK/dV and dQ): one forward+backward through the kernels and one
             through the plain versions (``FLAGS_use_cuda_kernels`` off);
             the losses and every parameter's gradient must agree.
9. train   — llama_7b widths at 15 layers in bf16 (the deepest whose
             steps fit one 80 GB card: 16 run out of memory in the
             accumulated step's update), B=4, S=2048, full
             recompute, AdamW(1e-4) with ClipGradByGlobalNorm(1.0) through
             ``TrainStep``: a warm-up step, three timed steps and one
             ``accum_step(accum=2)`` on a repeated seeded batch. Losses
             finite and falling; flash forward, dK/dV and dQ launch counts
             equal to what the code implies.

``--profile`` repeats the three serve runs and one train step under
``torch.profiler`` and reports device time by kernel and the device's
busy share (for the fused run: one device kernel per tail tick,
its device time per launch beside its bound and beside the scanned tail
tick's device time). Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and
as the last line ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``. Without a CUDA
device, or outside a checkout, it exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# the math rates of the kernels' input types (fp32 off the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# kernel vs plain version: bf16 rounds the output (and P) to 8 mantissa
# bits, fp32 differs only in summation order
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-4)}   # (atol, rtol)
# flash backward vs its plain version, per output tensor:
# |err| <= atol * max|ref| + rtol * |ref|. Gradients are far smaller than
# 1, so atol scales with the tensor's own size. bf16: P and dS are
# rounded to 8 mantissa bits (2^-9 relative) from fp32 values whose last
# bits differ with the summation order, so an element may round to the
# neighbouring bf16 value; sums over up to 2048 rows keep that well under
# 1% of the tensor's max, and the output rounds once more (2^-9 relative).
# fp32: summation order only.
BWD_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-4)}

# LLaMA-7B serving geometry of the default engine
H, HKV, D = 32, 32, 128
SLOTS, BS, MAX_SEQ = 8, 32, 4096
MB = MAX_SEQ // BS
NB = SLOTS * MB
CHUNK = 512
T_PACKED = SLOTS + CHUNK

# LLaMA-7B training attention (the train phase's shapes)
TRAIN_B, TRAIN_S = 4, 2048

REPLACES = {
    "ragged_attention": "paddle_tpu/kernels/pallas_ragged_attention.py:238",
    "paged_decode": "paddle_tpu/kernels/pallas_paged_decode.py:215",
    "flash": "paddle_tpu/kernels/pallas_flash.py:159",
    "flash_bwd_dkv": "paddle_tpu/kernels/pallas_flash.py:335",
    "flash_bwd_dq": "paddle_tpu/kernels/pallas_flash.py:365",
    "decode": "paddle_tpu/kernels/pallas_decode.py:116",
    "fused_decode_tick":
        "paddle_tpu/kernels/pallas_fused_decode_tick.py:335",
}
#: how a kernel does its arithmetic, by input type: the bf16 flash forward
#: and the bf16 chunk spans of ragged attention on the tensor cores by
#: warpgroup wgmma (ragged's span-1 rows on the split-KV walk), bf16 dK/dV,
#: dQ and the fused tick's projections by mma.sync.m16n8k16, everything
#: else in fp32 FMAs on the CUDA cores
TENSOR_CORE = {"flash": "wgmma", "flash_bwd_dkv": "mma.sync",
               "flash_bwd_dq": "mma.sync",
               "ragged_attention": "wgmma chunks, split-KV span-1 rows",
               "fused_decode_tick": "mma.sync GEMVs, split-KV attention"}


def route(name, dtype_name):
    return (TENSOR_CORE.get(name, "cuda-core") if dtype_name == "bfloat16"
            else "cuda-core")


SOURCES = {name: f"paddle_tpu_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["flash_bwd_dkv"] = SOURCES["flash_bwd_dq"] = \
    "paddle_tpu_torch/csrc/flash_bwd.cu"
BWD = ("flash_bwd_dkv", "flash_bwd_dq")


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(nbytes, flops, dtype):
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# ---------------------------------------------------------------- inputs
def paged_inputs(dtype, dev, gen):
    """8 decode rows over the 7B pool: lengths from 0 (a dead row) to a
    near-full cache, scrambled block placement, sentinel table tails, and
    NaN in the unwritten rows of one partial block."""
    import torch
    lengths = torch.tensor([1, 31, 33, 700, 1601, 2500, 4093, 0],
                           dtype=torch.int32)
    pool_k = torch.randn(NB, BS, HKV, D, generator=gen, device=dev).to(dtype)
    pool_v = torch.randn(NB, BS, HKV, D, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(1))
    tables = torch.full((SLOTS, MB), NB, dtype=torch.int32)
    for b in range(SLOTS):
        n = -(-int(lengths[b]) // BS)
        tables[b, :n] = perm[b * MB:b * MB + n].to(torch.int32)
    # stale NaN past row 3's length inside its last block
    last = int(tables[3, (700 - 1) // BS])
    pool_k[last, 700 % BS:] = float("nan")
    pool_v[last, 700 % BS:] = float("nan")
    q = torch.randn(SLOTS, H, D, generator=gen, device=dev).to(dtype)
    return q, pool_k, pool_v, tables.to(dev), lengths.to(dev)


def ragged_inputs(dtype, dev, gen):
    """The packed tick-0 buffer of the default engine (T = 8 + 512): six
    span-1 decode rows, one 500-token chunk starting mid-block, one dead
    row, and 14 packed rows outside every span."""
    import torch
    _, pool_k, pool_v, tables, _ = paged_inputs(dtype, dev, gen)
    # the decode rows keep their tables; row 5's 500-token chunk ends at
    # 1517 (mid-block) inside the 2500-row table it already has
    qlen = torch.tensor([1, 1, 1, 1, 1, 500, 1, 0], dtype=torch.int32)
    kvlen = torch.tensor([1, 31, 33, 700, 1601, 1517, 4093, 0],
                         dtype=torch.int32)
    qstart = torch.zeros(SLOTS, dtype=torch.int32)
    qstart[1:] = torch.cumsum(qlen, 0)[:-1]
    qp = torch.randn(T_PACKED, H, D, generator=gen, device=dev).to(dtype)
    return (qp, pool_k, pool_v, tables, qstart.to(dev), qlen.to(dev),
            kvlen.to(dev))


def dense_inputs(dtype, dev, gen, hkv=HKV):
    """8 decode rows over the dense-slot engine's [8, 4096] cache: lengths
    from 1 to the full 4096, NaN in every cache row past its length."""
    import torch
    lengths = [1, 31, 33, 700, 1601, 2500, 4096, 4093]
    k = torch.randn(SLOTS, MAX_SEQ, hkv, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(SLOTS, MAX_SEQ, hkv, D, generator=gen, device=dev).to(dtype)
    for b, n in enumerate(lengths):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    q = torch.randn(SLOTS, H, D, generator=gen, device=dev).to(dtype)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


# (qlen, kvlen) per sequence: the spans the ragged redesign makes risky.
# Chunks take 64-row tiles (bf16) whose causal offset kvlen - qlen is
# arbitrary; span-1 rows take the split-KV walk; (0, 0) is a dead row.
RAGGED_EDGE = {
    "spans_2_63_64_65": [(2, 130), (63, 63), (64, 1000), (65, 1601),
                         (1, 33), (0, 0)],
    "chunk_mid_block": [(200, 1217), (1, 700)],      # starts at 1017
    "partial_last_key_tile": [(100, 1000), (3, 70), (1, 4093)],
}


def ragged_span_inputs(spans, dtype, dev, gen, hkv=HKV):
    """A packed buffer of ``spans`` (7 more rows outside every span) over
    a pool that holds just their blocks: scrambled placement, sentinel
    table tails, NaN in the stale rows of each row's last block."""
    import torch
    qlen = torch.tensor([q for q, _ in spans], dtype=torch.int32)
    kvlen = torch.tensor([k for _, k in spans], dtype=torch.int32)
    qstart = torch.zeros(len(spans), dtype=torch.int32)
    qstart[1:] = torch.cumsum(qlen, 0)[:-1]
    need = [-(-k // BS) for _, k in spans]
    nb = sum(need) + 1
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(3))
    tables = torch.full((len(spans), max(need) + 2), nb, dtype=torch.int32)
    at = 0
    for r, n in enumerate(need):
        tables[r, :n] = perm[at:at + n].to(torch.int32)
        at += n
    pool_k = torch.randn(nb, BS, hkv, D, generator=gen, device=dev).to(dtype)
    pool_v = torch.randn(nb, BS, hkv, D, generator=gen, device=dev).to(dtype)
    for r, (_, k) in enumerate(spans):
        if k % BS:
            pool_k[int(tables[r, k // BS]), k % BS:] = float("nan")
            pool_v[int(tables[r, k // BS]), k % BS:] = float("nan")
    q = torch.randn(int(qlen.sum()) + 7, H, D, generator=gen,
                    device=dev).to(dtype)
    return (q, pool_k, pool_v, tables.to(dev), qstart.to(dev),
            qlen.to(dev), kvlen.to(dev))


def ragged_working_blocks(qlen, kvlen, g, hkv=HKV):
    """Blocks of each grid that do work: every split of a span-1 row that
    starts inside it (one for a row of length 0), and every tile of a
    chunk span."""
    split = sum(max(1, -(-k // g["split_len"]))
                for q, k in zip(qlen, kvlen) if q == 1)
    tile = sum(-(-q // g["tile_rows"]) for q in qlen if q >= 2)
    return {"split_blocks": hkv * split, "tile_blocks": H * tile}


def ragged_edge_cases(dtype_name, dev, gen):
    """Each of RAGGED_EDGE, and its first case with 8 KV heads, against
    the plain version within TOL; rows outside every span exact zeros."""
    import torch
    from paddle_tpu_torch.kernels import ragged_attention
    dtype = getattr(torch, dtype_name)
    errs = {}
    cases = [(name, spans, HKV) for name, spans in RAGGED_EDGE.items()]
    cases.append(("gqa_8_kv_heads", RAGGED_EDGE["spans_2_63_64_65"], 8))
    for name, spans, hkv in cases:
        a = ragged_span_inputs(spans, dtype, dev, gen, hkv)
        got = ragged_attention.ragged_paged_attention(*a)
        want = ragged_attention.ragged_attention_reference(*a)
        torch.cuda.synchronize()
        errs[name] = _compare(f"ragged {name}", dtype_name, got, want)
        used = sum(q for q, _ in spans)
        if not bool((got[used:] == 0).all()):
            raise RuntimeError(f"ragged {name} {dtype_name}: rows outside "
                               f"every span not zero")
    return errs


def flash_inputs(dtype, dev, gen, B=4, S=512):
    import torch
    mk = lambda h: torch.randn(B, S, h, D, generator=gen,  # noqa: E731
                               device=dev).to(dtype)
    return mk(H), mk(HKV), mk(HKV)


# ---------------------------------------------------------------- phases
def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build():
    from paddle_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in _build.SOURCES}
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})


def _compare(name, dtype_name, got, want):
    import torch
    atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise RuntimeError(f"{name} {dtype_name}: kernel output not finite")
    err = (g - w).abs().max().item()
    ok = bool(((g - w).abs() <= atol + rtol * w.abs()).all())
    if not ok:
        raise RuntimeError(f"{name} {dtype_name}: max abs err {err} "
                           f"exceeds atol {atol} + rtol {rtol}")
    return err


def _compare_scaled(name, dtype_name, got, want):
    """Backward tolerance (``BWD_TOL``): returns (max abs err, max abs err
    over the reference's max abs)."""
    import torch
    atol, rtol = BWD_TOL[dtype_name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise RuntimeError(f"{name} {dtype_name}: kernel output not finite")
    scale = w.abs().max().item()
    err = (g - w).abs()
    if not bool((err <= atol * scale + rtol * w.abs()).all()):
        raise RuntimeError(f"{name} {dtype_name}: max abs err "
                           f"{err.max().item()} exceeds {atol} * max|ref| "
                           f"({scale}) + {rtol} * |ref|")
    return err.max().item(), err.max().item() / max(scale, 1e-30)


def bwd_inputs(dtype, dev, gen, B, S, Hk):
    """q, k, v, dO from the seed; O and LSE from the flash forward kernel,
    each held against the plain forward at these shapes first (a wrong O
    or LSE would pass unseen into both the kernels and the plain
    backward); delta as the wrapper computes it. Returns the inputs and
    the forward's (O, LSE) max-abs errors."""
    import torch
    from paddle_tpu_torch.kernels import flash
    from paddle_tpu_torch.kernels.flash_attention import (_ref_attention,
                                                          _ref_lse)
    mk = lambda h: torch.randn(B, S, h, D, generator=gen,  # noqa: E731
                               device=dev).to(dtype)
    q, k, v, do = mk(H), mk(Hk), mk(Hk), mk(H)
    o, lse = flash.flash_attention_fwd(q, k, v, True)
    tag = f"flash fwd B={B} S={S} Hk={Hk}"
    dtype_name = str(dtype).split(".")[-1]
    fwd_err = (_compare(tag + " O", dtype_name, o,
                        _ref_attention(q, k, v, True)),
               _compare(tag + " LSE", "float32", lse, _ref_lse(q, k, True)))
    torch.cuda.empty_cache()
    return (q, k, v, do, o, lse, flash.attention_delta(o, do)), fwd_err


def bwd_check(dtype_name, dev, gen, B, S, Hk):
    """All three gradients of both backward kernels against the plain
    backward; returns the largest (abs, relative-to-max) error."""
    import torch
    from paddle_tpu_torch.kernels import flash
    (q, k, v, do, o, lse, delta), fwd_err = bwd_inputs(
        getattr(torch, dtype_name), dev, gen, B, S, Hk)
    got = flash.flash_attention_bwd(q, k, v, o, lse, do, True)
    want = flash.flash_attention_bwd_reference(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    errs = [_compare_scaled(f"flash bwd {n} B={B} S={S} Hk={Hk}",
                            dtype_name, g, w)
            for n, g, w in zip(("dq", "dk", "dv"), got, want)]
    return {"fwd_o_lse": fwd_err, "bwd": (max(e[0] for e in errs),
                                          max(e[1] for e in errs))}


def bwd_case(name, dtype_name, dev, gen):
    """One backward kernel at the training shapes against its plain
    version: error, bitwise repeatability, times, bound. The
    library time is SDPA forward+backward less SDPA forward at the same
    shapes — the pair's yardstick, the same on both rows."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash
    dtype = getattr(torch, dtype_name)
    isz = torch.tensor([], dtype=dtype).element_size()
    B, S = TRAIN_B, TRAIN_S
    (q, k, v, do, o, lse, delta), fwd_err = bwd_inputs(dtype, dev, gen, B,
                                                       S, HKV)
    args = (q, k, v, do, lse, delta)
    if name == "flash_bwd_dkv":
        run = lambda: flash.flash_bwd_dkv(*args)  # noqa: E731
        plain = lambda: flash.flash_bwd_dkv_reference(*args)  # noqa: E731
        products, out_elems = 4, k.numel() + v.numel()
    else:
        run = lambda: (flash.flash_bwd_dq(*args),)  # noqa: E731
        plain = lambda: (flash.flash_bwd_dq_reference(*args),)  # noqa
        products, out_elems = 3, q.numel()
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    errs = [_compare_scaled(name, dtype_name, g, w)
            for g, w in zip(got, want)]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    if not bitwise:
        raise RuntimeError(f"{name} {dtype_name}: two launches differ")
    del got, again, want
    torch.cuda.empty_cache()
    pairs = B * H * S * (S + 1) // 2
    flops = products * 2 * pairs * D
    nbytes = ((2 * q.numel() + 2 * k.numel()) * isz + 2 * 4 * B * H * S
              + out_elems * isz)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    lib_fb = lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot)  # noqa
    with torch.no_grad():
        lib_f = time_ms(sdpa)
    row = {"name": name, "dtype": dtype_name,
           "shape": {"B": B, "S": S, "H": H, "Hk": HKV, "D": D},
           "max_abs_err": max(e[0] for e in errs),
           "max_err_over_max_ref": max(e[1] for e in errs),
           "fwd_o_lse_err": fwd_err,
           "tol": {"atol_x_max_ref": BWD_TOL[dtype_name][0],
                   "rtol": BWD_TOL[dtype_name][1]},
           "bitwise_repeatable": bitwise,
           "ms": time_ms(run, iters=5), "plain_ms": time_ms(plain, iters=3),
           "library_ms": time_ms(lib_fb, iters=5) - lib_f,
           "library": "SDPA fwd+bwd minus SDPA fwd (the pair)",
           "bytes": nbytes, "flops": flops,
           "bound_ms": bound_ms(nbytes, flops, dtype_name),
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / PEAK_FLOPS[dtype_name] else "operations"),
           "route": route(name, dtype_name)}
    row["tflops"] = flops / row["ms"] / 1e9
    row["x_library"] = row["ms"] / row["library_ms"]
    # the tail past a non-multiple-of-64 S, and GQA (8 KV heads)
    for tag, (b, s_, hk) in (("tail", (2, 300, HKV)), ("gqa", (2, 512, 8))):
        if name == BWD[0]:
            row[f"{tag}_err"] = bwd_check(dtype_name, dev, gen, b, s_, hk)
    del qt, kt, vt, q, k, v, do, o, lse, delta
    return row


def kernel_case(name, dtype_name, dev, gen):
    """One kernel against its plain version: error, times, bound."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import decode, flash, paged_decode, \
        ragged_attention
    from paddle_tpu_torch.kernels.flash_attention import _ref_attention
    dtype = getattr(torch, dtype_name)
    isz = torch.tensor([], dtype=dtype).element_size()
    if name == "paged_decode":
        q, pk, pv, tbl, lens = paged_inputs(dtype, dev, gen)
        run = lambda: paged_decode.paged_decode_attention(  # noqa: E731
            q, pk, pv, tbl, lens)
        plain = lambda: paged_decode.paged_decode_attention_reference(  # noqa
            q, pk, pv, tbl, lens)
        L = lens.long().cpu()
        kv_rows = int(L.sum())
        nbytes = (2 * kv_rows * HKV * D * isz + 2 * q.numel() * isz
                  + 4 * (tbl.numel() + lens.numel()))
        flops = 4 * kv_rows * H * D
        # library: SDPA over the same caches gathered dense (gather and
        # mask built outside the timing), masked by length
        smax = int(L.max())
        nblk = -(-smax // BS)
        idx = tbl[:, :nblk].long().clamp(0, NB - 1)
        kd = pk[idx].reshape(SLOTS, nblk * BS, HKV, D)[:, :smax]
        vd = pv[idx].reshape(SLOTS, nblk * BS, HKV, D)[:, :smax]
        kd = torch.nan_to_num(kd).transpose(1, 2).contiguous()
        vd = torch.nan_to_num(vd).transpose(1, 2).contiguous()
        mask = (torch.arange(smax, device=dev)[None, :]
                < L.clamp(min=1).to(dev)[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, kd, vd, attn_mask=mask, enable_gqa=H != HKV)
    elif name == "ragged_attention":
        q, pk, pv, tbl, qs, ql, kl = ragged_inputs(dtype, dev, gen)
        run = lambda: ragged_attention.ragged_paged_attention(  # noqa: E731
            q, pk, pv, tbl, qs, ql, kl)
        plain = lambda: ragged_attention.ragged_attention_reference(  # noqa
            q, pk, pv, tbl, qs, ql, kl)
        qlc, klc = ql.long().cpu(), kl.long().cpu()
        live = qlc > 0
        kv_rows = int(klc[live].sum())
        pairs = 0
        for n, k in zip(qlc.tolist(), klc.tolist()):
            pairs += sum(k - n + i + 1 for i in range(n))
        nbytes = (2 * kv_rows * HKV * D * isz + 2 * q.numel() * isz
                  + 4 * (tbl.numel() + 3 * SLOTS))
        flops = 4 * pairs * H * D
        # library: SDPA on the spans padded to the longest, causal mask
        # within each span (the same work, padded)
        qmax, kmax = int(qlc.max()), int(klc.max())
        qpad = torch.zeros(SLOTS, H, qmax, D, dtype=dtype, device=dev)
        kpad = torch.zeros(SLOTS, HKV, kmax, D, dtype=dtype, device=dev)
        vpad = torch.zeros_like(kpad)
        mask = torch.zeros(SLOTS, 1, qmax, kmax, dtype=torch.bool,
                           device=dev)
        for r in range(SLOTS):
            n, k = int(qlc[r]), int(klc[r])
            if n == 0:
                mask[r, :, :, 0] = True
                continue
            a = int(qs[r])
            qpad[r, :, :n] = q[a:a + n].transpose(0, 1)
            nblk = -(-k // BS)
            rows = pk[tbl[r, :nblk].long()].reshape(nblk * BS, HKV, D)[:k]
            kpad[r, :, :k] = rows.transpose(0, 1)
            rows = pv[tbl[r, :nblk].long()].reshape(nblk * BS, HKV, D)[:k]
            vpad[r, :, :k] = torch.nan_to_num(rows).transpose(0, 1)
            pos = k - n + torch.arange(qmax, device=dev)
            mask[r, 0] = torch.arange(kmax, device=dev)[None, :] \
                <= pos[:, None]
        kpad = torch.nan_to_num(kpad)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qpad, kpad, vpad, attn_mask=mask, enable_gqa=H != HKV)
    elif name == "decode":
        q, kc, vc, lens = dense_inputs(dtype, dev, gen)
        run = lambda: decode.decode_attention(q, kc, vc, lens)  # noqa
        plain = lambda: decode.decode_attention_reference(  # noqa: E731
            q, kc, vc, lens)
        L = lens.long().cpu()
        kv_rows = int(L.sum())
        nbytes = (2 * kv_rows * HKV * D * isz + 2 * q.numel() * isz
                  + 4 * lens.numel())
        flops = 4 * kv_rows * H * D
        # library: SDPA on the cache itself (stale NaN zeroed outside the
        # timing), masked by length
        kd = torch.nan_to_num(kc).transpose(1, 2).contiguous()
        vd = torch.nan_to_num(vc).transpose(1, 2).contiguous()
        mask = (torch.arange(MAX_SEQ, device=dev)[None, :]
                < L.to(dev)[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, kd, vd, attn_mask=mask)
        # GQA: 8 KV heads for the 32 query heads
        qg, kg, vg, lg = dense_inputs(dtype, dev, gen, hkv=8)
        gqa_err = _compare("decode GQA", dtype_name,
                           decode.decode_attention(qg, kg, vg, lg),
                           decode.decode_attention_reference(qg, kg, vg,
                                                             lg))
        del qg, kg, vg
    else:
        q, k, v = flash_inputs(dtype, dev, gen)
        run = lambda: flash.flash_attention(q, k, v, causal=True)  # noqa
        plain = lambda: _ref_attention(q, k, v, True)  # noqa: E731
        B, S = q.shape[0], q.shape[1]
        nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * isz \
            + 4 * B * H * S
        flops = 4 * B * H * D * S * (S + 1) // 2
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=H != HKV)
        # the tail past a non-multiple-of-64 S must be masked too
        q3, k3, v3 = flash_inputs(dtype, dev, gen, B=2, S=300)
        _compare("flash S=300", dtype_name,
                 flash.flash_attention(q3, k3, v3, causal=True),
                 _ref_attention(q3, k3, v3, True))
        got_lse = flash.flash_attention_fwd(q3, k3, v3, True)[1]
        from paddle_tpu_torch.kernels.flash_attention import _ref_lse
        _compare("flash lse", "float32", got_lse, _ref_lse(q3, k3, True))
    got = run()
    want = plain()
    torch.cuda.synchronize()
    err = _compare(name, dtype_name, got, want)
    extra = {}
    if name == "paged_decode":
        # split-KV: the same bits on a second launch (the splits are
        # combined in split order, whichever block finishes last)
        if not torch.equal(got, run()):
            raise RuntimeError(f"paged_decode {dtype_name}: two launches "
                               f"differ")
        g = paged_decode.LAST_GRID
        extra = {"bitwise_repeatable": True, "split_len": g["split_len"],
                 "n_split": g["n_split"], "grid_blocks": g["blocks"],
                 "active_blocks": HKV * sum(max(1, -(-n // g["split_len"]))
                                            for n in L.tolist())}
    if name == "decode":
        # split-KV over the dense cache: the same bits on a second launch,
        # and a row of length 0 writes zeros (the row of length S_max is
        # in the main inputs)
        if not torch.equal(got, run()):
            raise RuntimeError(f"decode {dtype_name}: two launches differ")
        g = dict(decode.LAST_GRID)
        l0 = lens.clone()
        l0[0] = 0
        got0 = decode.decode_attention(q, kc, vc, l0)
        _compare("decode length 0", dtype_name, got0,
                 decode.decode_attention_reference(q, kc, vc, l0))
        if not bool((got0[0] == 0).all()):
            raise RuntimeError(f"decode {dtype_name}: a row of length 0 "
                               f"is not zero")
        extra = {"bitwise_repeatable": True, "split_len": g["split_len"],
                 "n_split": g["n_split"], "grid_blocks": g["blocks"],
                 "active_blocks": HKV * sum(max(1, -(-n // g["split_len"]))
                                            for n in L.tolist()),
                 "gqa_err": gqa_err}
    if name == "ragged_attention":
        g = dict(ragged_attention.LAST_GRID)
        extra = {"grid": g,
                 "working": ragged_working_blocks(qlc.tolist(), klc.tolist(),
                                                  g),
                 "edge_err": ragged_edge_cases(dtype_name, dev, gen)}
    row = {"name": name, "dtype": dtype_name, "max_abs_err": err, **extra,
           "tol": dict(zip(("atol", "rtol"), TOL[dtype_name])),
           "ms": time_ms(run), "plain_ms": time_ms(plain, iters=3),
           "library_ms": time_ms(lib), "bytes": nbytes, "flops": flops,
           "bound_ms": bound_ms(nbytes, flops, dtype_name),
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / PEAK_FLOPS[dtype_name] else "operations"),
           "route": route(name, dtype_name)}
    row["tflops"] = flops / row["ms"] / 1e9
    row["x_library"] = row["ms"] / row["library_ms"]
    if name == "flash":
        # the forward and its SDPA yardstick at the training shape too
        del q, k, v, qt, kt, vt, got, want
        q, k, v = flash_inputs(dtype, dev, gen, B=TRAIN_B, S=TRAIN_S)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        flops = 4 * TRAIN_B * H * D * TRAIN_S * (TRAIN_S + 1) // 2
        row["train_shape"] = {"B": TRAIN_B, "S": TRAIN_S, "flops": flops,
                              "bound_ms": bound_ms(0, flops, dtype_name)}
        row["ms_train_shape"] = time_ms(
            lambda: flash.flash_attention(q, k, v, causal=True), iters=5)
        row["library_ms_train_shape"] = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True))
        row["tflops_train_shape"] = flops / row["ms_train_shape"] / 1e9
        row["x_library_train_shape"] = (row["ms_train_shape"]
                                        / row["library_ms_train_shape"])
    return row


def tick_inputs(dtype, dev, gen, layers, pools=None, rows=SLOTS,
                lens=None):
    """One tail tick on the default pool (block 32, 4096-row tables):
    at 8 rows, lengths from 0 to a near-full cache, row 7 masked (idle),
    row 3 sampled (T 0.8, top-k 40); at more rows, seeded lengths 0..800
    with every 9th row masked and every 5th sampled; scrambled block
    placement with sentinel tails; pools ``[layers, 1024, 32, 32, 128]``
    from the seed unless given. ``lens`` overrides the lengths."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import _rope_tables
    r = np.random.RandomState(3 if rows == SLOTS else rows)
    if rows == SLOTS:
        base = np.array([1, 31, 33, 700, 1601, 2500, 4093, 0], np.int32)
        app = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.int32)
        temps = np.array([0, 0, 0, 0.8, 0, 0, 0, 0], np.float32)
        topks = np.array([0, 0, 0, 40, 0, 0, 0, 0], np.int32)
    else:
        base = r.randint(0, 801, rows).astype(np.int32)
        app = (np.arange(rows) % 9 != 8).astype(np.int32)
        temps = np.where(np.arange(rows) % 5 == 3, 0.8, 0).astype(np.float32)
        topks = np.where(temps > 0, 40, 0).astype(np.int32)
    lens = base if lens is None else np.asarray(lens, np.int32)
    perm = np.random.RandomState(2).permutation(NB)
    tables = np.full((rows, MB), NB, np.int32)
    at = 0
    for b in range(rows):
        n = -(-int(lens[b] + app[b]) // BS)
        at = b * MB if rows == SLOTS else at
        tables[b, :n] = perm[at:at + n]
        at += n
    if at > NB:
        raise ValueError(f"{rows} rows need {at} blocks of the pool's {NB}")
    if pools is None:
        pools = tuple(torch.randn(layers, NB, BS, HKV, D, generator=gen,
                                  device=dev).to(dtype) for _ in range(2))
    keys = r.randint(0, 2 ** 32, (rows, 2), dtype=np.uint64).astype(
        np.int64)
    tok = torch.from_numpy(r.randint(0, 32000, rows)).to(dev)
    sin, cos = _rope_tables(MB * BS, D, 10000.0, device=dev)
    return dict(tables=tables, tables_dev=torch.from_numpy(tables).to(dev),
                sin=sin, cos=cos, tok=tok, pool_k=pools[0],
                pool_v=pools[1], lens=lens, kys=keys, app_mask=app,
                temps=temps, top_ks=topks)


def tick_cost(params, t, layers, isz):
    """(bytes, flops) one tick must move and do: every weight once, each
    valid cached K/V row once, the appended rows and the float32 logits
    written once; two flops per weight and row, 4*D per head and key."""
    import numpy as np
    att = t["lens"] + t["app_mask"]
    w = sum(params[k].numel() for k in ("wq", "wk", "wv", "wo", "w_gate",
                                        "w_up", "w_down", "input_ln",
                                        "post_ln", "final_norm", "lm_head"))
    R = len(att)
    V = params["embed"].shape[0]
    kv = int(att.sum()) * HKV * D * 2 * layers
    nbytes = (w + R * params["embed"].shape[1]) * isz + kv * isz \
        + int(np.sum(t["app_mask"])) * HKV * D * 2 * layers * isz \
        + R * V * 4
    proj = sum(params[k].numel() for k in ("wq", "wk", "wv", "wo", "w_gate",
                                           "w_up", "w_down", "lm_head"))
    flops = 2 * R * proj + 4 * int(att.sum()) * H * D * layers
    return nbytes, flops


def _tick(fn, params, tied, t, **kw):
    import torch
    from paddle_tpu_torch.serving.decode import _head
    with torch.inference_mode():
        return fn(params, _head(params, tied), **t, nh=H, nkv=HKV, hd=D,
                  eps=1e-5, **kw)


# LLaMA-7B widths at 2 layers for the fused tick's kernel check, at the
# default 8 rows and at 37 (past the 16 rows the kernel once took, and not
# a multiple of its 8-row tiles)
FUSED_LAYERS = 2
FUSED_WIDE_ROWS = 37


# The fused tick against its plain version: float32 holds TOL (summation
# order only). A bf16 tick rounds every projection to bf16, and layer 1's
# attention output already differs by an ulp where the kernel rounds P per
# 32-key tile and the plain version rounds the normalised P; the later
# layers and the logits carry that several ulps further. The unfused tick
# through the paged decode kernel misses TOL against the same plain version
# too (0.0625 on these inputs, H100), so bf16 is held to TOL's numbers
# scaled by each tensor's largest entry, the form of BWD_TOL.
def _compare_tick(name, dtype_name, got, want):
    if dtype_name == "float32":
        return _compare(name, dtype_name, got, want)
    return _compare_scaled(name, dtype_name, got, want)[0]


def _fused_vs_plain(p, tied, t, dtype_name, label):
    """One fused tick against its plain version on copies of ``t``'s
    pools: keys bit for bit, tokens equal in float32, logits and the
    appended K/V rows within the tolerance, nothing written outside the
    appended rows. Returns (logits err, appended rows err, tokens equal,
    logits of the plain version)."""
    import torch
    from paddle_tpu_torch.kernels import fused_decode_tick as fdt
    from paddle_tpu_torch.serving.decode import _keys_host
    base_k, base_v = t["pool_k"], t["pool_v"]
    got = _tick(fdt.fused_decode_tick, p, tied,
                dict(t, pool_k=base_k.clone(), pool_v=base_v.clone()),
                return_logits=True)
    want = _tick(fdt.fused_decode_tick_reference, p, tied,
                 dict(t, pool_k=base_k.clone(), pool_v=base_v.clone()),
                 return_logits=True)
    torch.cuda.synchronize()
    tokens_equal = got[0].tolist() == want[0].tolist()
    if not bool((_keys_host(got[3]) == _keys_host(want[3])).all()):
        raise RuntimeError(f"fused tick {label} {dtype_name}: keys differ")
    if dtype_name == "float32" and not tokens_equal:
        raise RuntimeError(f"fused tick {label} float32: tokens "
                           f"{got[0].tolist()} vs plain {want[0].tolist()}")
    logits_err = _compare_tick(f"fused tick {label} logits", dtype_name,
                               got[4], want[4])
    # the appended rows: live rows at (table[len // bs], len % bs)
    live = [b for b in range(len(t["lens"])) if t["app_mask"][b]]
    dev = base_k.device
    phys = torch.tensor([int(t["tables"][b, t["lens"][b] // BS])
                         for b in live], device=dev)
    prow = torch.tensor([int(t["lens"][b] % BS) for b in live], device=dev)
    rows_err = max(_compare_tick(f"fused tick {label} appended {n}",
                                 dtype_name, g[:, phys, prow],
                                 w[:, phys, prow])
                   for n, g, w in (("K", got[1], want[1]),
                                   ("V", got[2], want[2])))
    for g, b in ((got[1], base_k), (got[2], base_v)):
        untouched = g.clone()
        untouched[:, phys, prow] = b[:, phys, prow]
        if not torch.equal(untouched, b):
            raise RuntimeError(f"fused tick {label} {dtype_name} wrote "
                               f"outside the appended rows")
    return logits_err, rows_err, tokens_equal, want[4]


def _layer0_attention_bits(p, tied, t):
    """The fused tick's attention output at layer 0 (a one-layer tick:
    the stacked weights and pools cut to their first layer) against the
    paged decode kernel at the tick's own q and updated pool: True when
    bit for bit equal."""
    import torch
    from paddle_tpu_torch.kernels import fused_decode_tick as fdt
    from paddle_tpu_torch.kernels import paged_decode
    from paddle_tpu_torch.models.llama import STACK_KEYS
    p1 = {k: v[:1] if k in STACK_KEYS else v for k, v in p.items()}
    t1 = dict(t, pool_k=t["pool_k"][:1].clone(),
              pool_v=t["pool_v"][:1].clone())
    _tick(fdt.fused_decode_tick, p1, tied, t1)
    q, attn = fdt.LAST_SCRATCH["q"], fdt.LAST_SCRATCH["attn"]
    with torch.inference_mode():
        want = paged_decode.paged_decode_attention(
            q, t1["pool_k"][0], t1["pool_v"][0], t["tables_dev"],
            t["lens"] + t["app_mask"])
    torch.cuda.synchronize()
    same = bool(torch.equal(attn, want))
    del t1, p1
    return same


def fused_case(name, dtype_name, dev, gen):
    """The fused tick kernel against its plain version (the scanned tick
    with the plain paged attention) at llama_7b widths, 2 layers, at 8 and
    at 37 rows (``_fused_vs_plain``); the layer-0 attention bit for bit
    against paged decode at both; kernel, plain and scanned-tick (the
    kernels' tick without fusion) milliseconds, the grid and the byte
    bound."""
    import torch
    from paddle_tpu_torch.kernels import fused_decode_tick as fdt
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_7b,
                                               llama_decode_params)
    from paddle_tpu_torch.serving.decode import _fused_decode_tick
    dtype = getattr(torch, dtype_name)
    isz = torch.tensor([], dtype=dtype).element_size()
    model = LlamaForCausalLM(llama_7b(num_hidden_layers=FUSED_LAYERS,
                                      dtype=dtype_name), device=dev, seed=6)
    p, tied = llama_decode_params(model)
    t = tick_inputs(dtype, dev, gen, FUSED_LAYERS)
    logits_err, rows_err, tokens_equal, want_logits = _fused_vs_plain(
        p, tied, t, dtype_name, "8 rows")
    # the yardstick of that spread: the unfused tick through the kernels
    scan = _tick(_fused_decode_tick, p, tied,
                 dict(t, pool_k=t["pool_k"].clone(),
                      pool_v=t["pool_v"].clone()), return_logits=True)
    scan_err = (scan[4] - want_logits).abs().max().item()
    del scan, want_logits
    bits = _layer0_attention_bits(p, tied, t)
    torch.cuda.empty_cache()
    run_t = dict(t, pool_k=t["pool_k"].clone(), pool_v=t["pool_v"].clone())
    nbytes, flops = tick_cost(p, t, FUSED_LAYERS, isz)
    row = {"name": name, "dtype": dtype_name,
           "layers": FUSED_LAYERS, "rows": SLOTS,
           "max_abs_err": max(logits_err, rows_err),
           "logits_err": logits_err, "appended_rows_err": rows_err,
           "unfused_kernels_vs_plain_logits_err": scan_err,
           "tokens_equal": tokens_equal, "keys_equal": True,
           "layer0_attention_equals_paged_decode": bits,
           "tol": dict(zip(("atol", "rtol"), TOL[dtype_name])),
           "ms": time_ms(lambda: _tick(fdt.fused_decode_tick, p, tied,
                                       run_t)),
           **{k: fdt.LAST_GRID[k] for k in ("blocks_per_sm", "split_len",
                                             "n_split")},
           "grid_blocks": fdt.LAST_GRID["blocks"],
           "plain_ms": time_ms(lambda: _tick(
               fdt.fused_decode_tick_reference, p, tied, run_t), iters=3),
           "scanned_tick_ms": time_ms(lambda: _tick(
               _fused_decode_tick, p, tied, run_t)),
           "library_ms": None,
           "library": "none: no single PyTorch call computes a tick",
           "bytes": nbytes, "flops": flops,
           "bound_ms": bound_ms(nbytes, flops, dtype_name),
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / PEAK_FLOPS[dtype_name] else "operations")}
    del run_t, t
    torch.cuda.empty_cache()
    # past the old row cap: 37 rows, lengths 0..800
    t = tick_inputs(dtype, dev, gen, FUSED_LAYERS, rows=FUSED_WIDE_ROWS)
    w_logits, w_rows, w_tokens, _ = _fused_vs_plain(
        p, tied, t, dtype_name, f"{FUSED_WIDE_ROWS} rows")
    w_bits = _layer0_attention_bits(p, tied, t)
    run_t = dict(t, pool_k=t["pool_k"].clone(), pool_v=t["pool_v"].clone())
    nbytes, flops = tick_cost(p, t, FUSED_LAYERS, isz)
    row["wide"] = {
        "rows": FUSED_WIDE_ROWS, "logits_err": w_logits,
        "appended_rows_err": w_rows, "tokens_equal": w_tokens,
        "keys_equal": True, "layer0_attention_equals_paged_decode": w_bits,
        "ms": time_ms(lambda: _tick(fdt.fused_decode_tick, p, tied, run_t)),
        "grid_blocks": fdt.LAST_GRID["blocks"],
        "blocks_per_sm": fdt.LAST_GRID["blocks_per_sm"],
        "scanned_tick_ms": time_ms(lambda: _tick(
            _fused_decode_tick, p, tied, run_t)),
        "bytes": nbytes, "bound_ms": bound_ms(nbytes, flops, dtype_name)}
    row["max_abs_err"] = max(row["max_abs_err"], w_logits, w_rows)
    if not (bits and w_bits):
        raise RuntimeError(f"fused tick {dtype_name}: layer-0 attention "
                           f"differs from paged decode (8 rows: {bits}, "
                           f"{FUSED_WIDE_ROWS} rows: {w_bits})")
    del model, p, t, run_t
    return row


def phase_kernels():
    import torch
    from paddle_tpu_torch.kernels import reset_launches
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for dtype_name in ("bfloat16", "float32"):
        for name in REPLACES:
            case = (bwd_case if name in BWD else
                    fused_case if name == "fused_decode_tick" else
                    kernel_case)
            row = case(name, dtype_name, dev, gen)
            emit({"phase": "kernels", **row})
            rows[(name, dtype_name)] = row
            torch.cuda.empty_cache()
    reset_launches()
    # span-1 ragged rows against the paged decode kernel: decode row b with
    # length L and a span-1 row with kvlen L attend the same keys through
    # the same split-KV walk. The split rule counts rows, so their splits
    # (and bits) agree only where the two calls have as many rows, as
    # here; they are held to TOL and ``bitwise`` reports whether they also
    # share the bits
    from paddle_tpu_torch.kernels import paged_decode, ragged_attention
    q, pk, pv, tbl, lens = paged_inputs(torch.bfloat16, dev, gen)
    one = torch.ones(SLOTS, dtype=torch.int32, device=dev)
    a = paged_decode.paged_decode_attention(q, pk, pv, tbl, lens)
    b = ragged_attention.ragged_paged_attention(
        q, pk, pv, tbl, torch.arange(SLOTS, dtype=torch.int32, device=dev),
        one * (lens > 0), lens)
    diff = _compare("span-1 ragged vs paged decode", "bfloat16", b, a)
    emit({"phase": "kernels", "check": "span1_ragged_vs_paged_decode",
          "max_abs_diff": diff, "bitwise": diff == 0.0})
    reset_launches()
    return rows


def _requests(GenerationRequest, short, long_len, new, vocab, seed):
    import numpy as np
    r = np.random.RandomState(seed)
    reqs = [GenerationRequest(prompt=r.randint(0, vocab, n).astype(np.int32),
                              max_new_tokens=new) for n in short]
    reqs.append(GenerationRequest(
        prompt=r.randint(0, vocab, long_len).astype(np.int32),
        max_new_tokens=new))
    return reqs


#: the engine's three decode programs: (label, knobs, the kernel only it
#: launches)
ENGINES = (("default", {}, None),
           ("fused_tick", {"fused_tick": True}, "fused_decode_tick"),
           ("dense", {"paged_attn": False}, "decode"))


def phase_engine():
    """fp32, 2 layers, for the default, the fused-tick and the dense
    engine: kernels vs plain versions, greedy streams equal; the engine's
    own kernel launches with the kernels on and never with them off; the
    fused engine's streams equal the default engine's."""
    import torch
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    cfg = llama_7b(num_hidden_layers=2, dtype="float32")
    model = LlamaForCausalLM(cfg, device="cuda", seed=1)
    on_streams = {}
    for label, knob, own in ENGINES:
        streams, launches, own_launches = {}, {}, {}
        try:
            for use in (True, False):
                set_flags({"FLAGS_use_cuda_kernels": use})
                reset_launches()
                eng = ContinuousBatchingEngine(model, headroom_mult=None,
                                               **knob)
                outs = eng.generate(_requests(
                    GenerationRequest, (37, 130, 300), 700, 16,
                    cfg.vocab_size, seed=3))
                streams[use] = [o.tolist() for o in outs]
                launches[use] = sum(LAUNCHES.values())
                own_launches[use] = LAUNCHES[own] if own else None
                del eng
                torch.cuda.empty_cache()
        finally:
            set_flags({"FLAGS_use_cuda_kernels": True})
        same = streams[True] == streams[False]
        on_streams[label] = streams[True]
        emit({"phase": "engine", "engine": label, "layers": 2,
              "dtype": "float32", "greedy_streams_equal": same,
              "tokens": sum(len(s) for s in streams[True]),
              "launches_kernels": launches[True],
              "launches_plain": launches[False],
              "own_kernel": own, "own_launches_kernels": own_launches[True],
              "own_launches_plain": own_launches[False]})
        if not launches[True] or launches[False] or (
                own and not own_launches[True]):
            raise RuntimeError(f"engine {label} launches: kernels "
                               f"{launches[True]} ({own}: "
                               f"{own_launches[True]}), plain "
                               f"{launches[False]}")
        if not same:
            raise RuntimeError(f"engine {label}: greedy streams differ: "
                               f"{streams}")
    fused_same = on_streams["fused_tick"] == on_streams["default"]
    emit({"phase": "engine", "check": "fused_tick_vs_default",
          "greedy_streams_equal": fused_same})
    if not fused_same:
        raise RuntimeError(f"fused-tick streams differ from the default "
                           f"engine's: {on_streams}")
    _engine_wide(model, cfg)
    del model
    torch.cuda.empty_cache()


#: the fused engine past the 16 rows its kernel once took: slots, requests
WIDE_SLOTS, WIDE_REQUESTS = 32, 20


def _engine_wide(model, cfg):
    """fp32, kernels on: WIDE_REQUESTS requests through the default and
    the fused-tick engine at WIDE_SLOTS slots, more than 16 in flight at
    once; the fused engine's greedy streams must equal the default's, one
    fused launch per tail tick of WIDE_SLOTS rows."""
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    reqs = _requests(GenerationRequest, tuple(range(25, 500, 25)), 700, 12,
                     cfg.vocab_size, seed=11)
    runs = {}
    for label, knob in (("default", {}), ("fused_tick", {"fused_tick": True})):
        reset_launches()
        eng = ContinuousBatchingEngine(model, num_slots=WIDE_SLOTS,
                                       max_seq_len=1024, headroom_mult=None,
                                       **knob)
        seqs = [eng.submit(q) for q in reqs]
        most = 0
        while eng.has_work():
            eng.step()
            most = max(most, sum(x is not None for x in eng._slots))
        torch.cuda.synchronize()
        runs[label] = ([list(x.tokens) for x in seqs], most,
                       LAUNCHES["fused_decode_tick"],
                       eng.stats["decode_steps"] - eng.stats["decode_calls"])
        del eng
        torch.cuda.empty_cache()
    same = runs["fused_tick"][0] == runs["default"][0]
    _, most, fused, tail = runs["fused_tick"]
    emit({"phase": "engine", "check": "fused_tick_wide_vs_default",
          "num_slots": WIDE_SLOTS, "requests": len(reqs),
          "most_in_flight": most, "greedy_streams_equal": same,
          "tokens": sum(len(x) for x in runs["fused_tick"][0]),
          "fused_launches": fused, "tail_ticks": tail})
    if not same or most <= 16 or fused != tail or not fused:
        raise RuntimeError(f"wide fused engine: streams equal {same}, "
                           f"{most} in flight, {fused} fused launches for "
                           f"{tail} tail ticks")


def _serve_requests(GenerationRequest, vocab):
    """7 short prompts (100-500 tokens, one seeded top-k) and one
    1600-token prompt that chunks, 64 new tokens each."""
    import numpy as np
    reqs = _requests(GenerationRequest, (100, 180, 250, 333, 410, 470),
                     1600, 64, vocab, seed=7)
    r = np.random.RandomState(8)
    reqs.insert(3, GenerationRequest(
        prompt=r.randint(0, vocab, 500).astype(np.int32),
        max_new_tokens=64, temperature=0.8, top_k=40, seed=1234))
    return reqs


def _serve(model, reqs, **knob):
    """One engine run to completion on the default geometry (plus
    ``knob``); returns (seqs, engine, steps, wall)."""
    import torch
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, **knob)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    seqs = [eng.submit(q) for q in reqs]
    while eng.has_work():
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    return seqs, eng, steps, time.perf_counter() - t0


def _expected_serve_launches(label, eng, layers):
    """Launch counts the code implies for one serve run: an int is exact,
    ``"+"`` means at least one."""
    st = eng.stats
    if label == "default":
        return {"flash": "+", "ragged_attention": "+", "paged_decode": "+",
                "fused_decode_tick": 0, "decode": 0}
    if label == "fused_tick":
        # one launch per tail tick (decode ticks past tick 0 of a step),
        # and no paged decode: the fused kernel replaces it there
        return {"flash": "+", "ragged_attention": "+", "paged_decode": 0,
                "fused_decode_tick": st["decode_steps"] - st["decode_calls"],
                "decode": 0}
    return {"flash": "+", "ragged_attention": 0, "paged_decode": 0,
            "fused_decode_tick": 0, "decode": layers * st["decode_steps"]}


def fused_tick_timing(eng, layers):
    """One tail tick at the serve geometry and depth on the engine's pool:
    the fused kernel and the scanned tick through the kernels (CUDA
    events), beside the tick's byte bound; and the fused tick again with
    every row at length 1, whose attention reads almost nothing: the
    difference between the two is the attention's share of the tick."""
    import torch
    from paddle_tpu_torch.kernels import fused_decode_tick as fdt
    from paddle_tpu_torch.serving.decode import _fused_decode_tick
    pool = eng.cache.pool
    t = tick_inputs(pool.k.dtype, pool.k.device, None, layers,
                    pools=(pool.k, pool.v))
    t1 = tick_inputs(pool.k.dtype, pool.k.device, None, layers,
                     pools=(pool.k, pool.v), lens=[1] * SLOTS)
    p, tied = eng._params, eng._tied
    nbytes, flops = tick_cost(p, t, layers, pool.k.element_size())
    tick = time_ms(lambda: _tick(fdt.fused_decode_tick, p, tied, t))
    grid = dict(fdt.LAST_GRID)
    tick1 = time_ms(lambda: _tick(fdt.fused_decode_tick, p, tied, t1))
    return {"tick_ms": tick, "grid_blocks": grid["blocks"],
            "blocks_per_sm": grid["blocks_per_sm"],
            "tick_len1_ms": tick1, "attention_ms": tick - tick1,
            "scanned_tick_ms": time_ms(lambda: _tick(_fused_decode_tick, p,
                                                     tied, t)),
            "tick_bytes": nbytes,
            "tick_bound_ms": bound_ms(nbytes, flops, "bfloat16")}, t


def _serve_run(model, cfg, reqs, label, knob, profile):
    """One measured serve run of one engine: a warm-up run first, counts
    set to 0 just before the measured run and read just after it."""
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import GenerationRequest
    # warm-up: first use of cuBLAS, the kernels and the allocator is not
    # serving time (a short and a long prompt touch every program)
    warm = _serve(model, _requests(GenerationRequest, (100,), 600, 9,
                                   cfg.vocab_size, seed=5), **knob)
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seqs, eng, steps, wall = _serve(model, reqs, **knob)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if any(launches[n] for n in BWD):
        raise RuntimeError(f"serving launched a backward kernel: {launches}")
    toks = [s.tokens for s in seqs]
    for s in seqs:
        if s.finish_reason != "length" or len(s.tokens) != 64:
            raise RuntimeError(f"{label} request {s.request_id}: "
                               f"{s.finish_reason}, {len(s.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in s.tokens):
            raise RuntimeError("token id out of the vocabulary")
    decoded = sum(len(t) for t in toks)
    want = _expected_serve_launches(label, eng, cfg.num_hidden_layers)
    line = {"phase": "serve", "engine": label, "knobs": knob,
            "layers": cfg.num_hidden_layers, "dtype": "bfloat16",
            "requests": len(reqs), "decoded_tokens": decoded,
            "wall_s": wall, "decoded_tok_per_s": decoded / wall,
            "steps": steps, "mean_step_ms": 1e3 * wall / steps,
            "decode_ticks": eng.stats["decode_steps"],
            "tail_ticks": (eng.stats["decode_steps"]
                           - eng.stats["decode_calls"]),
            "prefill_chunks": eng.stats["prefill_chunks"],
            "peak_mem_gb": peak,
            "launches": {n: launches[n] for n in want},
            "launches_expected": want,
            "first_tokens": [t[:4] for t in toks]}
    tick = None
    if label == "fused_tick":
        timing, tick = fused_tick_timing(eng, cfg.num_hidden_layers)
        line.update(timing)
    emit(line)
    bad = {n: (launches[n], w) for n, w in want.items()
           if (launches[n] <= 0 if w == "+" else launches[n] != w)}
    if bad:
        raise RuntimeError(f"{label} serve launches (got, expected): {bad}")
    del eng, tick
    gc.collect()
    torch.cuda.empty_cache()
    if profile and label in ("default", "dense"):
        phase_profile(model, reqs, toks, label, knob)
    if profile and label == "fused_tick":
        phase_profile_fused(model, cfg, reqs, toks)
    return launches, toks


def phase_serve(model, profile=False):
    """The main runs: 7B widths, bf16, 8 requests through each of the
    engine's three decode programs (the default engine, ``fused_tick``,
    ``paged_attn=False``), one engine freed before the next. With
    ``profile``, a repeat of each run under ``torch.profiler`` reports
    device time by kernel and the device's busy share. Returns each
    kernel's launches on the run of its path."""
    from paddle_tpu_torch.serving import GenerationRequest
    cfg = model.config
    reqs = _serve_requests(GenerationRequest, cfg.vocab_size)
    runs = {label: _serve_run(model, cfg, reqs, label, knob, profile)
            for label, knob, _ in ENGINES}
    streams = {label: toks for label, (_, toks) in runs.items()}
    emit({"phase": "serve", "check": "streams_vs_default",
          "equal": {label: streams[label] == streams["default"]
                    for label in streams}})
    launches = {n: runs["default"][0][n]
                for n in ("flash", "ragged_attention", "paged_decode")}
    for label, _, own in ENGINES[1:]:
        launches[own] = runs[label][0][own]
    return launches


# ------------------------------------------------------------- front door
GEN_BATCH, GEN_PROMPT, GEN_NEW, GEN_CHUNK = 4, 128, 64, 16


def _generate_ticks(new, chunk):
    """The unified steps and tail ticks ``generate`` runs for ``new``
    tokens when no row stops early: token 0 comes from the prefill, then
    each step fuses the largest power of two fitting the chunk and the
    rows' remaining budget (``FIFOScheduler.choose_num_steps``)."""
    steps, tail, left = 0, 0, new - 1
    while left:
        n = 1
        while n * 2 <= min(left, chunk):
            n *= 2
        steps, tail, left = steps + 1, tail + n - 1, left - n
    return steps, tail


def _launch_check(label, got, want):
    bad = {n: (got[n], w) for n, w in want.items() if got[n] != w}
    if bad:
        raise RuntimeError(f"{label} launches (got, expected): {bad}")


def phase_generate(model):
    """``model.generate`` at llama_7b width (32 layers, bf16): B=4 prompts
    of 128 tokens, 64 new tokens, greedy and then seeded top-k twice (the
    two equal); both equal a direct engine run with the same keys; flash,
    ragged and paged decode launches equal what the code implies. Then
    the fp32 check at 7B widths, 2 layers: kernels vs plain versions."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core import random as prng
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    cfg = model.config
    L = cfg.num_hidden_layers
    ids = np.random.RandomState(17).randint(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    model.generate(ids[:, :32], max_new_tokens=4)          # warm-up
    sampled = dict(temperature=0.8, top_k=40, seed=5)
    runs = {}
    for label, kw in (("greedy", {}), ("top_k", sampled),
                      ("top_k_again", sampled)):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=GEN_NEW, **kw)
        torch.cuda.synchronize()
        runs[label] = (out.cpu().numpy(), time.perf_counter() - t0,
                       dict(LAUNCHES))
    steps, tail = _generate_ticks(GEN_NEW, GEN_CHUNK)
    want = {"flash": L, "ragged_attention": L * steps,
            "paged_decode": L * tail, "fused_decode_tick": 0, "decode": 0}
    # the direct engine with generate's own geometry and fold_in keys
    direct = {}
    for label, kw in (("greedy", dict(seed=0)), ("top_k", sampled)):
        base = prng.PRNGKey(kw["seed"])
        eng = ContinuousBatchingEngine(
            model, num_slots=GEN_BATCH, max_seq_len=GEN_PROMPT + GEN_NEW,
            prefill_bucketing="exact", decode_chunk=GEN_CHUNK)
        outs = eng.generate([GenerationRequest(
            prompt=ids[i], max_new_tokens=GEN_NEW,
            temperature=kw.get("temperature", 0.0),
            top_k=kw.get("top_k", 0),
            prng_key=prng.fold_in(base, i).numpy())
            for i in range(GEN_BATCH)])
        direct[label] = np.stack([np.asarray(o) for o in outs])
        del eng
    tokens = GEN_BATCH * GEN_NEW
    emit({"phase": "generate", "layers": L, "dtype": cfg.dtype,
          "batch": GEN_BATCH, "prompt": GEN_PROMPT,
          "new_tokens": GEN_NEW, "decode_chunk": GEN_CHUNK,
          "wall_s": {k: v[1] for k, v in runs.items()},
          "tok_per_s": {k: tokens / v[1] for k, v in runs.items()},
          "launches": {n: runs["greedy"][2][n] for n in want},
          "launches_expected": want,
          "unified_steps": steps, "tail_ticks": tail,
          "seeded_repeat_equal": bool(np.array_equal(
              runs["top_k"][0], runs["top_k_again"][0])),
          "greedy_equals_direct": bool(np.array_equal(
              runs["greedy"][0], direct["greedy"])),
          "top_k_equals_direct": bool(np.array_equal(
              runs["top_k"][0], direct["top_k"])),
          "first_tokens": runs["greedy"][0][:, :4].tolist()})
    for label, (out, _, launches) in runs.items():
        _launch_check(f"generate {label}", launches, want)
        if out.shape != (GEN_BATCH, GEN_NEW) or out.min() < 0 \
                or out.max() >= cfg.vocab_size:
            raise RuntimeError(f"generate {label}: ids {out.shape} out of "
                               f"range")
    if not np.array_equal(runs["top_k"][0], runs["top_k_again"][0]):
        raise RuntimeError("two seeded generate calls gave other ids")
    for label in ("greedy", "top_k"):
        if not np.array_equal(runs[label][0], direct[label]):
            raise RuntimeError(f"generate {label} differs from the direct "
                               f"engine run")
    # fp32, 7B widths, 2 layers: kernels vs plain versions
    small = LlamaForCausalLM(llama_7b(num_hidden_layers=2,
                                      dtype="float32"), device="cuda",
                             seed=2)
    fp32 = {}
    try:
        for use in (True, False):
            set_flags({"FLAGS_use_cuda_kernels": use})
            reset_launches()
            fp32[use] = (small.generate(ids, max_new_tokens=32).cpu().numpy(),
                         dict(LAUNCHES))
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    same = bool(np.array_equal(fp32[True][0], fp32[False][0]))
    emit({"phase": "generate", "check": "fp32_kernels_vs_plain",
          "layers": 2, "ids_equal": same,
          "launches_kernels": {n: fp32[True][1][n] for n in want},
          "launches_plain": sum(fp32[False][1].values())})
    del small
    torch.cuda.empty_cache()
    if not same or sum(fp32[False][1].values()) \
            or not fp32[True][1]["paged_decode"]:
        raise RuntimeError("fp32 generate: kernels and plain versions "
                           "differ, or the launches are wrong")
    return runs["greedy"][2]


def parse_prometheus(text):
    """Strict Prometheus v0.0.4 text parse: ``{family: {"type",
    "samples": {(name, labels): value}}}``; raises on a malformed line, a
    sample outside its family's block or a missing final newline."""
    import re
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})? '
                        r'([^ ]+)$')
    if not text.endswith("\n"):
        raise ValueError("exposition must end with a newline")
    fams, cur = {}, None
    for line in text.splitlines():
        if not line.strip() or line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[7:].partition(" ")
            if kind not in ("counter", "gauge", "histogram"):
                raise ValueError(f"bad TYPE line {line!r}")
            fams[name] = {"type": kind, "samples": {}}
            cur = name
            continue
        m = sample.match(line)
        if not m or cur is None or not m.group(1).startswith(cur):
            raise ValueError(f"malformed sample line {line!r}")
        labels = tuple(re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"',
                                  m.group(2) or ""))
        fams[cur]["samples"][(m.group(1), labels)] = float(m.group(3))
    return fams


def _http(url, payload=None, timeout=600):
    """GET (or POST ``payload`` as JSON); returns the decoded body."""
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=timeout) as r:
        return r.read().decode()


def _sse(url, payload, timeout=600):
    """POST with stream=true; returns (token ids, finish_reason)."""
    import urllib.request
    body = json.dumps(dict(payload, stream=True)).encode()
    toks, reason = [], None
    with urllib.request.urlopen(urllib.request.Request(url, data=body),
                                timeout=timeout) as r:
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            ch = json.loads(line[6:])["choices"][0]
            if ch["finish_reason"] is not None:
                reason = ch["finish_reason"]
            else:
                toks.append(ch["token_id"])
    return toks, reason


def _payload(q):
    p = {"prompt": [int(t) for t in q.prompt],
         "max_tokens": int(q.max_new_tokens)}
    if q.temperature:
        p.update(temperature=q.temperature, top_k=q.top_k, seed=q.seed)
    return p


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def phase_server(model):
    """``serve(model, port=0)`` at its defaults on the card (decode_chunk
    1, 8 slots, cost on, trace off) under 8 concurrent HTTP clients (4
    blocking, 4 SSE) on the serve phase's requests, against a direct
    engine run; then the fault leg and the CLI leg."""
    import threading
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    from paddle_tpu_torch.serving.server import serve
    cfg = model.config
    L = cfg.num_hidden_layers
    reqs = _serve_requests(GenerationRequest, cfg.vocab_size)
    # the direct run: the same requests, the server's engine geometry,
    # each admitted alone in its own step as the clients below are (a
    # cold prefill's GEMMs take the group's rows; bf16 results of another
    # grouping may differ in the last bits and flip a greedy token)
    eng = ContinuousBatchingEngine(model, num_slots=8, decode_chunk=1)
    eng.generate(_requests(GenerationRequest, (100,), 600, 4,
                           cfg.vocab_size, seed=5))            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs = []
    for q in reqs:
        seqs.append(eng.submit(q))
        eng.step()
    while eng.has_work():
        eng.step()
    torch.cuda.synchronize()
    direct_wall = time.perf_counter() - t0
    want = [list(x.tokens) for x in seqs]
    del eng, seqs
    gc.collect()
    torch.cuda.empty_cache()
    srv = serve(model, port=0)
    try:
        gw = srv.gateway
        url = srv.url + "/v1/completions"
        _http(url, {"prompt": [1, 2, 3, 4, 5], "max_tokens": 4})  # warm-up
        eng = gw.engine
        steps0, prefill0 = eng.stats["unified_steps"], \
            gw.cost.kind_calls("prefill")
        reset_launches()
        got, errors, trace = [None] * len(reqs), [], {}

        def client(i):
            try:
                if i % 2:
                    got[i] = _sse(url, _payload(reqs[i]))
                else:
                    doc = json.loads(_http(url, _payload(reqs[i])))
                    ch = doc["choices"][0]
                    got[i] = (ch["token_ids"], ch["finish_reason"])
            except Exception as e:                  # noqa: BLE001
                errors.append(f"client {i}: {e!r}")

        def tracer():
            try:
                trace["doc"] = json.loads(_http(
                    srv.url + "/debug/trace?steps=8&timeout_s=300"))
            except Exception as e:                  # noqa: BLE001
                errors.append(f"trace: {e!r}")

        # the clients run concurrently; each starts once the one before
        # holds its slot, so each prompt is admitted alone, as above
        threads = []
        t0 = time.perf_counter()
        for i in range(len(reqs)):
            threads.append(threading.Thread(target=client, args=(i,)))
            threads[-1].start()
            if i == 0:
                threads.append(threading.Thread(target=tracer))
                threads[-1].start()
            deadline = time.monotonic() + 300
            while eng.num_active < i + 1 and time.monotonic() < deadline \
                    and not errors:
                time.sleep(0.002)
        for t in threads:
            t.join(timeout=900)
        gw_wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        steps = eng.stats["unified_steps"] - steps0
        prefills = gw.cost.kind_calls("prefill") - prefill0
        fams = parse_prometheus(_http(srv.url + "/metrics"))
        health = json.loads(_http(srv.url + "/healthz"))
        profile = json.loads(_http(srv.url + "/debug/profile"))
        ttft = [gw._m_ttft.quantile(q) for q in (0.5, 0.9)]
        tpot = [gw._m_tpot.quantile(q) for q in (0.5, 0.9)]
    finally:
        srv.shutdown(drain=False, timeout=120)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"server clients failed: {errors}")
    streams = [list(g[0]) for g in got]
    names = {e["name"] for e in trace["doc"]["traceEvents"]}
    calls = {}
    for p in profile["programs"]:
        calls[p["kind"]] = calls.get(p["kind"], 0) + p["calls"]
    comp = fams["serving_decode_compilations"]["samples"][
        ("serving_decode_compilations", ())]
    expect = {"flash": L * prefills, "ragged_attention": L * steps,
              "paged_decode": 0, "fused_decode_tick": 0, "decode": 0}
    line = {"phase": "server", "layers": L, "dtype": cfg.dtype,
            "clients": len(reqs), "blocking": len(reqs) // 2,
            "sse": len(reqs) - len(reqs) // 2,
            "decoded_tokens": sum(len(s) for s in streams),
            "gateway_wall_s": gw_wall, "direct_wall_s": direct_wall,
            "gateway_over_direct": gw_wall / direct_wall,
            "ttft_p50_s": ttft[0], "ttft_p90_s": ttft[1],
            "tpot_p50_s": tpot[0], "tpot_p90_s": tpot[1],
            "steps_with_work": steps, "prefill_calls": prefills,
            "launches": {n: launches[n] for n in expect},
            "launches_expected": expect,
            "decode_compilations": comp, "healthz": health["status"],
            "trace_spans": sorted(names & {"plan", "launch",
                                           "host-accept", "step"}),
            "profile_ragged_calls": calls.get("ragged"),
            "engine_unified_steps": eng.stats["unified_steps"],
            "streams_equal_direct": streams == want,
            "first_diff": [_first_diff(s, w) for s, w in zip(streams, want)]}
    emit(line)
    if streams != want or any(g[1] != "length" for g in got):
        raise RuntimeError("server streams differ from the direct run")
    _launch_check("server", launches, expect)
    if comp != 1 or health["status"] != "ok" \
            or not {"plan", "launch", "host-accept"} <= names \
            or calls.get("ragged") != eng.stats["unified_steps"]:
        raise RuntimeError(f"server checks failed: {line}")
    del srv, gw, eng
    gc.collect()
    torch.cuda.empty_cache()
    _rebuild_memory(model)
    _server_faults()
    _server_cli()
    return launches


def _rebuild_memory(model):
    """The rebuild at the serving geometry: ``serve(model, port=0)`` (8
    slots x 4096 tokens: a 16 GiB pool at 7B bf16) with a fatal fault at
    plan step 2 under two requests; the peak memory above what was held
    before the server shows whether the rebuild held one pool or two
    (the dead engine's pool is released before the factory runs)."""
    import torch
    from paddle_tpu_torch.serving import GenerationRequest
    from paddle_tpu_torch.serving.faults import FaultPlan
    from paddle_tpu_torch.serving.server import serve
    reqs = _requests(GenerationRequest, (100,), 300, 16,
                     model.config.vocab_size, seed=29)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    srv = serve(model, port=0, fault_hook=FaultPlan().at_step(2, "fatal"))
    try:
        gw = srv.gateway
        pool_gb = (gw.engine.cache.pool.block_nbytes
                   * gw.engine.cache.pool.num_blocks / 2 ** 30)
        outs = [st.result() for st in [gw.submit(q) for q in reqs]]
        restarts = gw.restarts
    finally:
        srv.shutdown(drain=False, timeout=120)
    over = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    line = {"phase": "server", "check": "rebuild_memory", "layers":
            model.config.num_hidden_layers, "dtype": model.config.dtype,
            "engine_restarts": restarts,
            "finish_reasons": [r for _, r in outs],
            "pool_gb": pool_gb, "peak_over_base_gb": over,
            "pools_at_peak": over / pool_gb}
    emit(line)
    del srv, gw
    gc.collect()
    torch.cuda.empty_cache()
    if restarts != 1 or any(r != "length" for _, r in outs) \
            or over >= 2 * pool_gb:
        raise RuntimeError(f"rebuild at the serving geometry: {line}")


#: scripts/bench_chaos.py's plan, geometry and workload shape
CHAOS_SLOTS, CHAOS_BLOCK, CHAOS_CHUNK = 4, 16, 32


def _chaos_requests(GenerationRequest, vocab):
    import numpy as np
    rng = np.random.RandomState(23)
    reqs = []
    for i in range(10):
        kw = dict(temperature=0.8, top_k=5, seed=200 + i) if i % 4 == 3 \
            else {}
        reqs.append(GenerationRequest(
            prompt=rng.randint(0, vocab, (12,)).astype(np.int32),
            max_new_tokens=12, **kw))
    for _ in range(2):
        reqs.append(GenerationRequest(
            prompt=rng.randint(0, vocab, (160,)).astype(np.int32),
            max_new_tokens=6))
    return reqs


def _server_faults():
    """fp32, 7B widths, 2 layers: the chaos plan ``transient@3, pool@6,
    fatal@10, nan@15`` through ``serve(..., fault_hook=plan)``; no request
    lost, streams equal the fault-free run, two rebuilds (fatal, nan),
    and the peak memory across them."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    from paddle_tpu_torch.serving.faults import FaultPlan
    from paddle_tpu_torch.serving.server import serve
    model = LlamaForCausalLM(llama_7b(num_hidden_layers=2, dtype="float32"),
                             device="cuda", seed=3)
    # max_seq_len at the model's default (4096): a pool the size serving
    # holds, so the peak shows whether a rebuild held two of them
    geo = dict(num_slots=CHAOS_SLOTS, prefix_block_size=CHAOS_BLOCK,
               prefill_chunk=CHAOS_CHUNK)
    model_gb = sum(p.numel() * p.element_size()
                   for p in model.parameters()) / 2 ** 30
    reqs = _chaos_requests(GenerationRequest, model.config.vocab_size)
    want = [o.tolist() for o in ContinuousBatchingEngine(
        model, decode_chunk=1, **geo).generate(reqs)]
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plan = (FaultPlan().at_step(3, "transient").at_step(6, "pool")
            .at_step(10, "fatal").at_step(15, "nan"))
    srv = serve(model, port=0, fault_hook=plan, max_restarts=32,
                max_queue=len(reqs) + 4, **geo)
    try:
        gw = srv.gateway
        pool_gb = (gw.engine.cache.pool.block_nbytes
                   * gw.engine.cache.pool.num_blocks / 2 ** 30)
        streams = [gw.submit(q) for q in reqs]
        outs = []
        for st in streams:
            try:
                ids, reason = st.result()
                outs.append((ids.tolist(), reason))
            except RuntimeError:
                outs.append((st.tokens(), st.finish_reason))
        restarts = gw.restarts
        health = json.loads(_http(srv.url + "/healthz"))
    finally:
        srv.shutdown(drain=False, timeout=120)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    over = peak - base / 2 ** 30
    lost = sum(r not in ("stop", "length") for _, r in outs)
    line = {"phase": "server", "check": "faults", "layers": 2,
            "dtype": "float32", "plan": plan.log, "requests": len(reqs),
            "requests_lost": lost, "engine_restarts": restarts,
            "healthz_engine_restarts": health["engine_restarts"],
            "streams_equal_fault_free": [o[0] for o in outs] == want,
            "first_diff": [_first_diff(o[0], w)
                           for o, w in zip(outs, want)],
            "peak_mem_gb": peak, "peak_over_base_gb": over,
            "model_gb": model_gb, "pool_gb": pool_gb}
    emit(line)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if lost or restarts != 2 or [o[0] for o in outs] != want:
        raise RuntimeError(f"fault leg failed: {line}")


def _server_cli():
    """``python -m paddle_tpu_torch.serving.server --preset 350m
    --decode-attention pallas --port 0 --quiet`` as a subprocess: read the
    banner, POST one completion, SIGTERM, expect a drain and exit 0."""
    import os
    import select
    import signal
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.server",
         "--preset", "350m", "--decode-attention", "pallas", "--port", "0",
         "--quiet"], cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=dict(os.environ))
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 600)
        if not ready:
            raise RuntimeError("server CLI printed no banner")
        banner = json.loads(proc.stdout.readline())
        t0 = time.perf_counter()
        doc = json.loads(_http(banner["listening"] + "/v1/completions",
                               {"prompt": list(range(1, 40)),
                                "max_tokens": 16}))
        first_request_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    toks = doc["choices"][0]["token_ids"]
    line = {"phase": "server", "check": "cli", "preset": banner["preset"],
            "kv_dtype": banner["kv_dtype"], "tokens": len(toks),
            "first_request_s": first_request_s, "exit_code": rc,
            "drained": "# draining" in err and "# stopped" in err}
    emit(line)
    if rc != 0 or len(toks) != 16 or not line["drained"]:
        raise RuntimeError(f"server CLI leg failed: {line} {err[-2000:]}")


def _device_rows(prof):
    """(device us, calls, name) per kernel from a torch.profiler run,
    largest first: device-side events only (a CPU op's row repeats the
    device time of the kernels it launched)."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    return sorted(rows, reverse=True)


def _profile_line(phase, rows, wall, **extra):
    """Busy share, the 14 largest device kernels, and every kernel of the
    port (``pt::``) with its share of the device time."""
    busy_us = sum(r[0] for r in rows)
    emit({"phase": phase, "wall_s": wall, **extra,
          "device_busy_s": busy_us / 1e6,
          "device_busy_share": busy_us / 1e6 / wall if rows else None,
          "top": [{"name": k[:90], "calls": c, "device_ms": us / 1e3}
                  for us, c, k in rows[:14]],
          "port_kernels": [{"name": k.split("(")[0][:70], "calls": c,
                            "device_ms": us / 1e3,
                            "share": us / busy_us}
                           for us, c, k in rows if "pt::" in k]})


def phase_profile(model, reqs, want, label, knob):
    """Device time by kernel over a repeat of one engine's serve run (the
    default engine's line is ``profile``, another's ``profile_<label>``)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        seqs, _, steps, wall = _serve(model, reqs, **knob)
    if [s.tokens for s in seqs] != want:
        raise RuntimeError(f"the profiled {label} repeat sampled other "
                           f"tokens")
    _profile_line("profile" if label == "default" else f"profile_{label}",
                  _device_rows(prof), wall, steps=steps)


def phase_profile_fused(model, cfg, reqs, want, scanned_ticks=5):
    """The fused serve run under ``torch.profiler``: one device kernel per
    tail tick (the fused kernel's device launches equal the tail ticks,
    and no paged decode kernel runs), its device time per launch beside
    its bound, and the device time of the scanned tail tick (the kernels'
    tick without fusion: paged decode and cuBLAS launches) at the same
    geometry."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from paddle_tpu_torch.serving.decode import _fused_decode_tick
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        seqs, eng, steps, wall = _serve(model, reqs, fused_tick=True)
    rows = _device_rows(prof)
    tail = eng.stats["decode_steps"] - eng.stats["decode_calls"]
    fused = [(us, c) for us, c, k in rows if "fused_tick_kernel" in k]
    paged = sum(c for _, c, k in rows if "paged_decode_kernel" in k)
    n_fused = sum(c for _, c in fused)
    fused_us = sum(us for us, _ in fused)
    t = tick_inputs(eng.cache.pool.k.dtype, eng.cache.pool.k.device, None,
                    cfg.num_hidden_layers,
                    pools=(eng.cache.pool.k, eng.cache.pool.v))
    p, tied = eng._params, eng._tied
    nbytes, flops = tick_cost(p, t, cfg.num_hidden_layers, 2)
    _tick(_fused_decode_tick, p, tied, t)          # warm
    torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof2:
        for _ in range(scanned_ticks):
            _tick(_fused_decode_tick, p, tied, t)
        torch.cuda.synchronize()
    srows = _device_rows(prof2)
    _profile_line("profile_fused", rows, wall, steps=steps,
                  tail_ticks=tail, fused_device_launches=n_fused,
                  paged_decode_device_launches=paged,
                  fused_device_ms_per_launch=(fused_us / n_fused / 1e3
                                              if n_fused else None),
                  tick_bound_ms=bound_ms(nbytes, flops, "bfloat16"),
                  scanned_tick_device_ms=(sum(r[0] for r in srows)
                                          / scanned_ticks / 1e3),
                  scanned_tick_device_kernels=(sum(r[1] for r in srows)
                                               / scanned_ticks))
    del eng, t
    if n_fused != tail or paged:
        raise RuntimeError(f"profiled fused run: {n_fused} fused kernels "
                           f"for {tail} tail ticks, {paged} paged decode")
    if [s.tokens for s in seqs] != want:
        raise RuntimeError("the profiled fused repeat sampled other tokens")


# ---------------------------------------------------------------- training
# the deepest llama_7b cut whose whole train phase fits one 80 GB H100:
# at 16 layers the accumulated step's update runs out of memory
TRAIN_LAYERS = 15
# kernels vs plain versions through a whole forward+backward. fp32: loss
# to 1e-5 relative, each gradient to 1e-4 of its largest entry. Both run
# fp32 and differ only in summation order, which the backward carries
# through two layers of matmuls; the first H100 run read 8.5e-8 and at
# most 3.6e-6, so the bounds keep a 28x margin. bf16: the flash kernels
# round P per 64-key tile against a running max where the plain forward
# rounds the normalised P, so attention outputs differ by an ulp here and
# there, and two layers of bf16 matmuls carry that into the loss and every
# gradient: loss to 2e-2 relative, each gradient in BWD_TOL's form.
PARITY_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
PARITY_GRAD_TOL = 1e-4


def _train_ids(vocab, B, S, seed):
    import numpy as np
    import torch
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S))
    return torch.as_tensor(ids, device="cuda")


def _grad_ok(dtype_name, got, want):
    """fp32: max|err| <= PARITY_GRAD_TOL * max|ref|; bf16: BWD_TOL's form,
    elementwise."""
    err = (got - want).abs()
    size = want.abs().max()
    if dtype_name == "float32":
        return bool(err.max() <= PARITY_GRAD_TOL * size)
    atol, rtol = BWD_TOL[dtype_name]
    return bool((err <= atol * size + rtol * want.abs()).all())


def phase_train_parity():
    """2 layers at llama_7b widths, B=1, S=500 (a tail past the 64-row
    tiles): kernels against plain versions through the model, in fp32
    (the CUDA-core kernels) and in bf16 (the tensor-core forward, dK/dV
    and dQ)."""
    for dtype_name in ("float32", "bfloat16"):
        _train_parity(dtype_name)


def _train_parity(dtype_name):
    import torch
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    cfg = llama_7b(num_hidden_layers=2, dtype=dtype_name)
    model = LlamaForCausalLM(cfg, device="cuda", seed=2)
    ids = _train_ids(cfg.vocab_size, 1, 500, seed=4)
    runs = {}
    try:
        for use in (True, False):
            set_flags({"FLAGS_use_cuda_kernels": use})
            model.zero_grad(set_to_none=True)
            reset_launches()
            loss = model(ids, ids)
            loss.backward()
            torch.cuda.synchronize()
            grads = {n: p.grad.float() for n, p in model.named_parameters()}
            runs[use] = (float(loss.detach()), grads, dict(LAUNCHES))
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    (lk, gk, nk), (lp, gp, npl) = runs[True], runs[False]
    errs = {n: ((gk[n] - gp[n]).abs().max()
                / gp[n].abs().max().clamp(min=1e-30)).item() for n in gp}
    bad = [n for n in gp if not _grad_ok(dtype_name, gk[n], gp[n])]
    loss_rtol = PARITY_LOSS_RTOL[dtype_name]
    want = {"flash": 4, "flash_bwd_dkv": 2, "flash_bwd_dq": 2}
    emit({"phase": "train_parity", "layers": 2, "dtype": dtype_name,
          "B": 1, "S": 500, "loss_kernels": lk, "loss_plain": lp,
          "loss_rel_err": abs(lk - lp) / abs(lp),
          "grad_err_over_max": errs,
          "tol": {"loss_rtol": loss_rtol,
                  "grad": (f"{PARITY_GRAD_TOL} x max|ref|"
                           if dtype_name == "float32" else
                           "BWD_TOL: {} x max|ref| + {} x |ref|".format(
                               *BWD_TOL[dtype_name]))},
          "launches_kernels": {n: nk[n] for n in want},
          "launches_plain": sum(npl.values())})
    if not abs(lk - lp) <= loss_rtol * abs(lp):
        raise RuntimeError(f"train parity {dtype_name}: loss {lk} vs plain "
                           f"{lp}")
    if bad:
        raise RuntimeError(f"train parity {dtype_name}: gradients off: "
                           f"{ {n: errs[n] for n in bad} }")
    if {n: nk[n] for n in want} != want or sum(npl.values()):
        raise RuntimeError(f"train parity launches: kernels {nk}, plain "
                           f"{npl}")
    del model, runs, gk, gp


def phase_train(profile=False, layers=TRAIN_LAYERS):
    """The training run: ``layers`` (15) layers of llama_7b in bf16,
    B=4, S=2048."""
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    cfg = llama_7b(num_hidden_layers=layers, dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    trainer = TrainStep(model, lambda loss, _lab: loss, opt)
    B, S = TRAIN_B, TRAIN_S
    ids = _train_ids(cfg.vocab_size, B, S, seed=0)
    batch = ((ids, ids), (ids,))
    t0 = time.perf_counter()
    warm = float(trainer.step(*batch))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = trainer.step(*batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    accum_loss = float(trainer.accum_step(*batch, 2))
    torch.cuda.synchronize()
    accum_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    mean_s = sum(step_s) / len(step_s)
    micro = 3 + 2            # microbatches in the counted window
    want = {"flash": 2 * layers * micro,
            "flash_bwd_dkv": layers * micro,
            "flash_bwd_dq": layers * micro}
    emit({"phase": "train", "layers": layers, "dtype": "bfloat16",
          "B": B, "S": S, "params": model.num_params(),
          "warmup_loss": warm, "warmup_s": warm_s, "losses": losses,
          "accum2_loss": accum_loss, "step_ms": [1e3 * t for t in step_s],
          "mean_step_ms": 1e3 * mean_s, "tokens_per_s": B * S / mean_s,
          "accum2_step_ms": 1e3 * accum_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "warmup_peak_mem_gb": warm_peak,
          "launches": {n: launches[n] for n in want},
          "launches_expected": want})
    finite = all(map(math.isfinite, losses + [warm, accum_loss]))
    if not finite or not losses[2] < losses[0]:
        raise RuntimeError(f"train: losses {warm}, {losses}, {accum_loss} "
                           f"not finite and falling")
    if {n: launches[n] for n in want} != want:
        raise RuntimeError(f"train launches {launches}, expected {want}")
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.step(*batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = _device_rows(prof)
        busy = sum(r[0] for r in rows) / 1e6
        _profile_line("train_profile", rows, wall,
                      busy_share_of_unprofiled_step=busy / mean_s)
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="kernels,engine,serve,generate,server,"
                            "train_parity,train",
                    help="comma list of phases after device+build")
    ap.add_argument("--profile", action="store_true",
                    help="repeat the three serve runs and one train "
                         "step under torch.profiler and report device time "
                         "by kernel")
    ap.add_argument("--train-layers", type=int, default=TRAIN_LAYERS,
                    help="decoder layers of the train phase (default "
                         f"{TRAIN_LAYERS}, the deepest that fits)")
    args = ap.parse_args(argv)
    if not (ROOT / "paddle_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    phases = set(args.phases.split(","))
    smi = phase_device()
    phase_build()
    rows = phase_kernels() if "kernels" in phases else {}
    if "engine" in phases:
        phase_engine()
    launches = {}
    if phases & {"serve", "generate", "server"}:
        # one llama_7b (32 layers, bf16, seed 0) for the three phases
        from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
        model = LlamaForCausalLM(llama_7b(dtype="bfloat16"), device="cuda",
                                 seed=0)
        if "serve" in phases:
            launches = phase_serve(model, args.profile)
        if "generate" in phases:
            phase_generate(model)
        if "server" in phases:
            phase_server(model)
        del model
    gc.collect()
    torch.cuda.empty_cache()      # the serve model is gone before training
    if "train_parity" in phases:
        phase_train_parity()
    train = (phase_train(args.profile, args.train_layers)
             if "train" in phases else {})
    kernels = []
    for name in REPLACES:
        row = rows.get((name, "bfloat16"), {})
        path = train if name in BWD else launches
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": path.get(name, 0),
            **{k: row.get(k) for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms", "tflops")},
            "math": route(name, "bfloat16")})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
