"""Time the quantized kernels of one checkout (argv[1], a directory holding
``paddle_tpu_torch`` and ``chip_smoke.py``) on a CUDA card, at the shapes
``chip_smoke.py`` uses, by CUDA events:

- paged decode with bf16 queries over the smoke's 8 decode rows of the
  LLaMA-7B pool (lengths 0 to 4093) on a bf16 pool and on int8 and fp8
  pools, with each output's max-abs error against the plain version and
  a SHA-256 of its bytes; the SHA-256 of paged decode with float32
  queries on a float32 pool and of dense decode (bf16 and float32) over
  the smoke's dense cache, the page walk's other callers;
- ragged attention with bf16 queries over the smoke's packed tick-0 buffer
  (LLaMA-7B heads, 8 rows, one 500-token chunk) on a bf16 pool and on
  int8 and fp8 pools, with the chunk tile's rows, each output's max-abs
  error against the plain version and a SHA-256 of its bytes;
- the fused decode tick in bf16 at LLaMA-7B widths, 8 rows: the dense
  tick, int8 weights on a bf16 pool (``w8``), an int8 pool with dense
  weights (``int8``) and with int8 weights (``int8_w8``), and int8
  weights on an fp8 pool (``fp8_w8``), at 2 layers and at 32 (the
  32-layer leg: all but ``fp8_w8``), with the logits' max-abs error
  against the plain tick at 2 layers.

Each paged decode row also has its device time by the profiler
(``device_ms``: the events time back-to-back calls, which the host's
per-call work can hold up). ``--paged`` times paged decode only;
``--ticks [NAMES]`` the ticks only (a comma list, default the dense
and ``w8`` ticks); ``--build-only``
builds the libraries a run needs and stops (start several at once, then
time them in turns). ``--patch NAME`` first copies the
checkout's ``paddle_tpu_torch`` under its ``build/`` directory and edits
a source in the copy (``PATCHES``: the fused tick's, the split-KV walk's
or the split rule's): a probe of what one part costs, whose values are
then wrong (only its time means anything; the logits check is skipped),
and never a kernel of the port. The edit must find its text, or the
script stops.

Prints one JSON line. To compare two trees on one card, run it in turns
from one command, for example parent, change, change, parent:

    for r in build/parent . . build/parent; do
        python3 scripts/quant_timing.py $r; done
"""
import argparse
import hashlib
import json
import shutil
import sys
from pathlib import Path

_TICK = "csrc/fused_decode_tick.cuh"
_WALK = "csrc/split_kv.cuh"
#: probe edits: name -> [(file under paddle_tpu_torch, text, replacement)]
PATCHES = {
    # the tick before the two-tile int8 chunks: its int8 weights'
    # shared-memory dequant pass deleted
    "skip-dequant": [(_TICK, "if constexpr (W8) dequant_w(cb + i, i % kStages);",
                      "")],
    # the int8 ring's depth (stages-2 .. stages-6)
    **{f"stages-{n}": [(_TICK, "static constexpr int STAGES = R8 ? 3 : kStages;",
                        f"static constexpr int STAGES = R8 ? {n} : "
                        f"kStages;")]
       for n in range(2, 7)},
    # no chunk processing (bf16 int8 and dense): the weights stream, no
    # product, no piece, no epilogue
    "no-process": [
        (_TICK, "    if constexpr (R8) {\n      // two k-steps",
         "    if constexpr (R8) { return; }\n"
         "    if constexpr (R8) {\n      // two k-steps"),
        (_TICK, "    } else if constexpr (Q::BF) {\n"
         "      // A fragments of this warp's 16 columns",
         "    } else if constexpr (Q::BF) {\n      if (true) return;\n"
         "      // A fragments of this warp's 16 columns")],
    # no int8-to-bf16 conversion: the read bits go to the MMAs as they are
    "no-convert": [(_TICK, "        af[m][0] = dq2(x0, b0, x1, b0, sc[2 * m]);",
                    "        af[m][0] = x0 ^ x1; continue;")],
    # no tickets and no group epilogues (every GEMV kind)
    "no-epilogue": [(_TICK, "    if (!last) return;", "    return;")],
    # no MMAs in the int8 chunks: the fragments and X reads stay
    "no-mma": [(_TICK, "              tc::mma(cf[m], af0[m], bf[0], bf[1]);\n"
                "              tc::mma(cf[m], af1[m], bf[2], bf[3]);",
                "              cf[m][0] += __uint_as_float(af0[m][0] ^ "
                "af1[m][1] ^ bf[0] ^ bf[3]);")],
    # the quantized walk: pages stream, nothing is computed on them
    "walk-no-compute": [(_WALK, "    if (pw >= s1) continue;         // no key",
                         "    continue;         // no key")],
    # ... scores and softmax but no P V
    "walk-no-pv": [(_WALK, "    if constexpr (GM * KW <= 64) {\n#pragma unroll\n"
                    "      for (int j = 0; j < KW; ++j) pv_key(j);",
                    "    if constexpr (GM * KW <= 64) {\n#pragma unroll\n"
                    "      for (int j = 0; j < 0; ++j) pv_key(j);")],
    # a warp's ring depth (walk-stages-2 .. walk-stages-4)
    **{f"walk-stages-{n}": [(_WALK, "static constexpr int NST = 4;",
                             f"static constexpr int NST = {n};")]
       for n in range(2, 5)},
    # the quantized walk as a call of its own (its own register budget
    # inside the fused tick)
    "walk-noinline": [(_WALK, "__device__ __forceinline__ void narrow_walk(",
                       "__device__ __noinline__ void narrow_walk(")],
    # the tick's attention compiled with one accumulator width only (a
    # probe of the code size: right for G * D <= 128 only)
    "tick-walk-nacc1": [(_TICK, "    PT_WALK(4);", "    PT_WALK(1);"),
                        (_TICK, "    PT_WALK(skv::kMaxAcc);",
                         "    PT_WALK(1);")],
    # the tick's attention without one of its accumulator widths (probes
    # of which inlined walk raises its register pressure: right for
    # G * D <= 128 only)
    "tick-walk-no4": [(_TICK, "    PT_WALK(4);", "    PT_WALK(1);")],
    "tick-walk-no16": [(_TICK, "    PT_WALK(skv::kMaxAcc);",
                        "    PT_WALK(4);")],
    # four times the splits (every walk: the split rule is shared)
    "split-x4": [("kernels/split_kv.py", "BLOCKS_PER_SM = 8",
                  "BLOCKS_PER_SM = 32")],
}

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("root")
ap.add_argument("--ticks", nargs="?", const="dense,w8", default=None,
                metavar="NAMES",
                help="the ticks only: a comma list of TICKS (default "
                     "dense,w8)")
ap.add_argument("--paged", action="store_true",
                help="paged decode (and the page walk's bits) only")
ap.add_argument("--build-only", action="store_true",
                help="build the libraries this run needs, then stop")
ap.add_argument("--patch", choices=sorted(PATCHES),
                help="time a copy with this edit (a probe)")
args = ap.parse_args()
root = Path(args.root).resolve()
pkg_root = root
if args.patch:
    # (the copy's build/kernels keeps its libraries from run to run)
    pkg_root = root / "build" / f"probe_{args.patch}"
    shutil.rmtree(pkg_root / "paddle_tpu_torch", ignore_errors=True)
    shutil.copytree(root / "paddle_tpu_torch", pkg_root / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, old, new in PATCHES[args.patch]:
        src = pkg_root / "paddle_tpu_torch" / name
        text = src.read_text()
        if old not in text:
            raise SystemExit(f"--patch {args.patch}: this checkout's {name} "
                             f"has no text to edit")
        src.write_text(text.replace(old, new))
sys.path.insert(0, str(pkg_root))
sys.path.insert(1, str(root))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import fused_decode_tick as fdt  # noqa: E402
from paddle_tpu_torch.kernels import ragged_attention as rag  # noqa: E402
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,  # noqa: E402
                                           llama_7b, llama_decode_params)
from paddle_tpu_torch.serving.decode import \
    quantize_decode_params  # noqa: E402

dev = torch.device("cuda")
TICKS = {"dense": (None, False), "w8": (None, True),
         "int8": ("int8", False), "int8_w8": ("int8", True),
         "fp8_w8": ("fp8", True)}
if args.ticks:
    TICKS = {k: TICKS[k] for k in args.ticks.split(",")}
if args.paged:
    TICKS = {}
_build.build_all(([] if args.ticks else ["paged_decode", "decode"]) + (
    [] if args.ticks or args.paged else ["ragged_attention"]) + [
    _build.FUSED_VARIANTS[0 if kv is None else {"int8": 1, "fp8": 2}[kv], w8]
    for kv, w8 in TICKS.values()])
if args.build_only:
    sys.exit(0)


def ev(fn, n=20):
    return cs.time_ms(fn, iters=n, warmup=3)


def dev_ms(fn, n=50):
    """Device time a call by the profiler's kernel rows."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0) / 1e3 / n


def digest(t):
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


out = {"root": str(root), "patch": args.patch,
       "card": torch.cuda.get_device_name(0)}

# ---------------------------------------- paged decode and the page walk
if not args.ticks:
    from paddle_tpu_torch.kernels import decode as dec
    from paddle_tpu_torch.kernels import paged_decode as pd
    gen = torch.Generator(device=dev).manual_seed(0)
    q, pk, pv, tbl, lens = cs.paged_inputs(torch.bfloat16, dev, gen)
    pools = {"bf16": (pk, pv, None, None)}
    for mode in ("int8", "fp8"):
        pools[mode] = cs.quantize_pool(pk, pv, mode, gen)
    for mode, (kd, vd, ks, vs) in pools.items():
        a = (q, kd, vd, tbl, lens, ks, vs)
        got = pd.paged_decode_attention(*a)
        want = pd.paged_decode_attention_reference(*a)
        torch.cuda.synchronize()
        out[f"paged_{mode}"] = {
            "ms": ev(lambda: pd.paged_decode_attention(*a), 100),
            "device_ms": dev_ms(lambda: pd.paged_decode_attention(*a)),
            "split_len": pd.LAST_GRID["split_len"],
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "sha256": digest(got)}
    del q, pk, pv, pools, got, want
    q, pk, pv, tbl, lens = cs.paged_inputs(torch.float32, dev, gen)
    out["paged_fp32_sha256"] = digest(pd.paged_decode_attention(
        q, pk, pv, tbl, lens))
    del q, pk, pv
    for dtype in (torch.bfloat16, torch.float32):
        a = cs.dense_inputs(dtype, dev, gen)
        out[f"dense_decode_{str(dtype)[6:]}_sha256"] = digest(
            dec.decode_attention(*a))
        del a
    torch.cuda.empty_cache()

# ------------------------------------------------------ ragged attention
if not args.ticks and not args.paged:
    gen = torch.Generator(device=dev).manual_seed(0)
    q, pk, pv, tbl, qs, ql, kl = cs.ragged_inputs(torch.bfloat16, dev, gen)
    pools = {"bf16": (pk, pv, None, None)}
    for mode in ("int8", "fp8"):
        pools[mode] = cs.quantize_pool(pk, pv, mode, gen)
    for mode, (kd, vd, ks, vs) in pools.items():
        a = (q, kd, vd, tbl, qs, ql, kl, ks, vs)
        got = rag.ragged_paged_attention(*a)
        want = rag.ragged_attention_reference(*a)
        torch.cuda.synchronize()
        out[f"ragged_{mode}"] = {
            "ms": ev(lambda: rag.ragged_paged_attention(*a), 50),
            "tile_rows": rag.LAST_GRID["tile_rows"],
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "sha256": digest(got)}
    del q, pk, pv, pools, got, want
    torch.cuda.empty_cache()

# ------------------------------------------------------- the fused tick
for layers, names in ((2, tuple(TICKS)),
                      (32, tuple(k for k in TICKS if k != "fp8_w8"))):
    if not names:
        continue
    model = LlamaForCausalLM(llama_7b(num_hidden_layers=layers,
                                      dtype="bfloat16"), device=dev, seed=6)
    dense, tied = llama_decode_params(model)
    qparams = quantize_decode_params(dense, tied)
    del model
    g = torch.Generator(device=dev).manual_seed(1)
    base = cs.tick_inputs(torch.bfloat16, dev, g, layers)
    for name in names:
        kv, w8 = TICKS[name]
        p = qparams if w8 else dense
        t = dict(base)
        if kv is not None:
            # a layer at a time: the float32 copy of a 32-layer pool would
            # not fit beside the weights
            per = [cs.quantize_pool(base["pool_k"][i], base["pool_v"][i],
                                    kv, g) for i in range(layers)]
            kd, vd, ks, vs = (torch.stack([x[j] for x in per])
                              for j in range(4))
            del per
            t.update(pool_k=(kd, ks), pool_v=(vd, vs))
        row = {"ms": ev(lambda: cs._tick(fdt.fused_decode_tick, p, tied,
                                         dict(t)), 20 if layers == 2 else 10),
               "blocks": fdt.LAST_GRID["blocks"]}
        if layers == 2 and not args.patch:
            run_t = dict(t, pool_k=cs._clone_pool(t["pool_k"]),
                         pool_v=cs._clone_pool(t["pool_v"]))
            got = cs._tick(fdt.fused_decode_tick, p, tied, run_t,
                           return_logits=True)[4]
            plain_t = dict(t, pool_k=cs._clone_pool(t["pool_k"]),
                           pool_v=cs._clone_pool(t["pool_v"]))
            want = cs._tick(fdt.fused_decode_tick_reference, p, tied,
                            plain_t, return_logits=True)[4]
            row["logits_err_of_max_ref"] = (
                (got - want).abs().max() / want.abs().max()).item()
            del run_t, plain_t, got, want
        out[f"tick{layers}_{name}"] = row
        del t
        torch.cuda.empty_cache()
    del dense, qparams, base
    torch.cuda.empty_cache()
print(json.dumps(out), flush=True)
