#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

Phases, each printing one JSON line; any failure exits nonzero:

1. device  — the card's name and power limit (``nvidia-smi``); TF32 off.
2. build   — compile the CUDA sources of ``paddle_tpu_torch/csrc`` (five
             kernels in four sources, one ``nvcc`` each, in parallel).
3. kernels — each kernel against its plain PyTorch version, bf16 and fp32:
             the three serving kernels at the LLaMA-7B serving shapes, the
             two flash-backward kernels at the training shapes (B=4,
             S=2048, 32 heads of 128) plus a tail (S=300) and a GQA
             (8 KV heads) check, dK/dV bitwise equal across two launches,
             and the flash forward's O and LSE at each of those shapes;
             max-abs error against the stated tolerance, kernel / plain /
             library milliseconds (a PyTorch call on the same work, a
             yardstick the port never calls) and the least time the card
             could take (``bound_ms``).
4. engine  — llama_7b widths at 2 layers in fp32, the default engine
             through the kernels against the plain versions
             (``FLAGS_use_cuda_kernels`` on, then off): the greedy token
             streams must be equal.
5. serve   — llama_7b at full width and depth (32 layers) in bf16 with
             seeded random weights: the default engine serves 8 requests
             (7 short prompts, one long prompt that rides the ragged
             kernel in chunks, one seeded top-k request), 64 new tokens
             each; every serving kernel must have launched on this path.
6. train_parity — llama_7b widths at 2 layers in fp32, B=1, S=500: one
             forward+backward through the kernels and one through the
             plain versions (``FLAGS_use_cuda_kernels`` off); the losses
             and every parameter's gradient must agree.
7. train   — llama_7b widths at 15 layers in bf16 (the deepest whose
             steps fit one 80 GB card: 16 run out of memory in the
             accumulated step's update), B=4, S=2048, full
             recompute, AdamW(1e-4) with ClipGradByGlobalNorm(1.0) through
             ``TrainStep``: a warm-up step, three timed steps and one
             ``accum_step(accum=2)`` on a repeated seeded batch. Losses
             finite and falling; flash forward, dK/dV and dQ launch counts
             equal to what the code implies.

``--profile`` repeats the serve run and one train step under
``torch.profiler`` and reports device time by kernel and the device's busy
share. Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and
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
}
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
    version: error, bitwise repeatability of dK/dV, times, bound. The
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
           "dkdv_bitwise_repeatable": bitwise if name == BWD[0] else None,
           "ms": time_ms(run, iters=5), "plain_ms": time_ms(plain, iters=3),
           "library_ms": time_ms(lib_fb, iters=5) - lib_f,
           "library": "SDPA fwd+bwd minus SDPA fwd (the pair)",
           "bytes": nbytes, "flops": flops,
           "bound_ms": bound_ms(nbytes, flops, dtype_name),
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / PEAK_FLOPS[dtype_name] else "operations")}
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
    from paddle_tpu_torch.kernels import flash, paged_decode, \
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
    row = {"name": name, "dtype": dtype_name, "max_abs_err": err,
           "tol": dict(zip(("atol", "rtol"), TOL[dtype_name])),
           "ms": time_ms(run), "plain_ms": time_ms(plain, iters=3),
           "library_ms": time_ms(lib), "bytes": nbytes, "flops": flops,
           "bound_ms": bound_ms(nbytes, flops, dtype_name),
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / PEAK_FLOPS[dtype_name] else "operations")}
    return row


def phase_kernels():
    import torch
    from paddle_tpu_torch.kernels import reset_launches
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for dtype_name in ("bfloat16", "float32"):
        for name in REPLACES:
            case = bwd_case if name in BWD else kernel_case
            row = case(name, dtype_name, dev, gen)
            emit({"phase": "kernels", **row})
            rows[(name, dtype_name)] = row
            torch.cuda.empty_cache()
    reset_launches()
    # span-1 ragged rows against the paged decode kernel (shared tile
    # arithmetic): decode row b with length L equals a span-1 row with
    # kvlen L
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


def phase_engine():
    """fp32, 2 layers: kernels vs plain versions, greedy streams equal."""
    import torch
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          GenerationRequest)
    cfg = llama_7b(num_hidden_layers=2, dtype="float32")
    model = LlamaForCausalLM(cfg, device="cuda", seed=1)
    streams, launches = {}, {}
    try:
        for use in (True, False):
            set_flags({"FLAGS_use_cuda_kernels": use})
            reset_launches()
            eng = ContinuousBatchingEngine(model, headroom_mult=None)
            outs = eng.generate(_requests(GenerationRequest, (37, 130, 300),
                                          700, 16, cfg.vocab_size, seed=3))
            streams[use] = [o.tolist() for o in outs]
            launches[use] = sum(LAUNCHES.values())
            del eng
            torch.cuda.empty_cache()
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    same = streams[True] == streams[False]
    emit({"phase": "engine", "layers": 2, "dtype": "float32",
          "greedy_streams_equal": same,
          "tokens": sum(len(s) for s in streams[True]),
          "launches_kernels": launches[True],
          "launches_plain": launches[False]})
    if not launches[True] or launches[False]:
        raise RuntimeError(f"engine launches: kernels {launches[True]}, "
                           f"plain {launches[False]}")
    if not same:
        raise RuntimeError(f"greedy streams differ: {streams}")
    del model
    torch.cuda.empty_cache()


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


def _serve(model, reqs):
    """One default-engine run to completion; returns (seqs, steps, wall)."""
    import torch
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model)   # the default geometry
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    seqs = [eng.submit(q) for q in reqs]
    while eng.has_work():
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    return seqs, eng, steps, time.perf_counter() - t0


def phase_serve(profile=False):
    """The main run: 7B widths, bf16, the default engine over 8 requests.
    With ``profile``, a second identical run under ``torch.profiler``
    reports device time by kernel and the device's busy share."""
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.serving import GenerationRequest
    cfg = llama_7b(dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    reqs = _serve_requests(GenerationRequest, cfg.vocab_size)
    # warm-up: first use of cuBLAS, the kernels and the allocator is not
    # serving time (a short and a chunked prompt touch every program)
    _serve(model, _requests(GenerationRequest, (100,), 600, 9,
                            cfg.vocab_size, seed=5))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seqs, eng, steps, wall = _serve(model, reqs)
    launches = {n: LAUNCHES[n] for n in REPLACES if n not in BWD}
    if any(LAUNCHES[n] for n in BWD):
        raise RuntimeError(f"serving launched a backward kernel: {LAUNCHES}")
    toks = [s.tokens for s in seqs]
    for s in seqs:
        if s.finish_reason != "length" or len(s.tokens) != 64:
            raise RuntimeError(f"request {s.request_id}: "
                               f"{s.finish_reason}, {len(s.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in s.tokens):
            raise RuntimeError("token id out of the vocabulary")
    decoded = sum(len(t) for t in toks)
    emit({"phase": "serve", "layers": cfg.num_hidden_layers,
          "dtype": "bfloat16",
          "requests": len(reqs), "decoded_tokens": decoded,
          "wall_s": wall, "decoded_tok_per_s": decoded / wall,
          "steps": steps, "mean_step_ms": 1e3 * wall / steps,
          "prefill_chunks": eng.stats["prefill_chunks"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": launches,
          "first_tokens": [t[:4] for t in toks]})
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")
    if profile:
        phase_profile(model, reqs, [s.tokens for s in seqs])
    return launches


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
    busy_us = sum(r[0] for r in rows)
    emit({"phase": phase, "wall_s": wall, **extra,
          "device_busy_s": busy_us / 1e6,
          "device_busy_share": busy_us / 1e6 / wall if rows else None,
          "top": [{"name": k[:90], "calls": c, "device_ms": us / 1e3}
                  for us, c, k in rows[:14]]})


def phase_profile(model, reqs, want):
    """Device time by kernel over a repeat of the main run."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        seqs, _, steps, wall = _serve(model, reqs)
    if [s.tokens for s in seqs] != want:
        raise RuntimeError("the profiled repeat sampled other tokens")
    _profile_line("profile", _device_rows(prof), wall, steps=steps)


# ---------------------------------------------------------------- training
# the deepest llama_7b cut whose whole train phase fits one 80 GB H100:
# at 16 layers the accumulated step's update runs out of memory
TRAIN_LAYERS = 15
# kernels vs plain versions through a whole fp32 forward+backward: loss
# to 1e-5 relative, each gradient to 1e-4 of its largest entry. Both run
# fp32 and differ only in summation order, which the backward carries
# through two layers of matmuls; the first H100 run read 8.5e-8 and at
# most 3.6e-6, so the bounds keep a 28x margin.
PARITY_LOSS_RTOL, PARITY_GRAD_TOL = 1e-5, 1e-4


def _train_ids(vocab, B, S, seed):
    import numpy as np
    import torch
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S))
    return torch.as_tensor(ids, device="cuda")


def phase_train_parity():
    """fp32, 2 layers at llama_7b widths, B=1, S=500 (a tail past the
    64-row tiles): kernels against plain versions through the model."""
    import torch
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    cfg = llama_7b(num_hidden_layers=2, dtype="float32")
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
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            runs[use] = (float(loss.detach()), grads, dict(LAUNCHES))
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    (lk, gk, nk), (lp, gp, npl) = runs[True], runs[False]
    errs = {n: ((gk[n].float() - gp[n].float()).abs().max()
                / gp[n].float().abs().max().clamp(min=1e-30)).item()
            for n in gp}
    want = {"flash": 4, "flash_bwd_dkv": 2, "flash_bwd_dq": 2}
    emit({"phase": "train_parity", "layers": 2, "dtype": "float32",
          "B": 1, "S": 500, "loss_kernels": lk, "loss_plain": lp,
          "loss_rel_err": abs(lk - lp) / abs(lp),
          "grad_err_over_max": errs,
          "tol": {"loss_rtol": PARITY_LOSS_RTOL,
                  "grad_x_max": PARITY_GRAD_TOL},
          "launches_kernels": {n: nk[n] for n in want},
          "launches_plain": sum(npl.values())})
    if not abs(lk - lp) <= PARITY_LOSS_RTOL * abs(lp):
        raise RuntimeError(f"train parity: loss {lk} vs plain {lp}")
    bad = {n: e for n, e in errs.items() if not e <= PARITY_GRAD_TOL}
    if bad:
        raise RuntimeError(f"train parity: gradients off: {bad}")
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
                    default="kernels,engine,serve,train_parity,train",
                    help="comma list of phases after device+build")
    ap.add_argument("--profile", action="store_true",
                    help="repeat the serve run and one train step under "
                         "torch.profiler and report device time by "
                         "kernel")
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
    launches = phase_serve(args.profile) if "serve" in phases else {}
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
                                       "library_ms")}})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
