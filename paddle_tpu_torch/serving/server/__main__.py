"""CLI entry point: ``python -m paddle_tpu_torch.serving.server``.

Stands up a LLaMA-family model (seeded random weights) behind the async
gateway and serves OpenAI-style completions over HTTP until
SIGINT/SIGTERM, then drains gracefully (in-flight requests finish; new
ones get 503). The flags, presets and banner line are the JAX package's
(``python -m paddle_tpu.serving.server``); every flag value off the
ported path raises ``NotImplementedError`` naming its ROADMAP step.

``--device`` (default ``cuda``) is the port's one addition, the
counterpart of ``JAX_PLATFORMS``: with ``cuda`` and no GPU the command
exits nonzero, it does not fall back to the CPU. The ``tiny`` preset is
the CPU-runnable smoke config (head dim 16, which the kernels take at
their padded width: ``--decode-attention pallas`` serves it on the card
too); ``350m`` is the bench-sized model for the card. ``--decode-attention``
keeps the reference's default ``jnp`` (the plain versions); ``pallas``
selects the hand-written kernels. Prompts are token-id arrays — see
README "Serving over HTTP" for curl examples.

``--tp N`` serves through N head shards, all on the ``--device`` (where
the JAX CLI on a CPU needs
``XLA_FLAGS=--xla_force_host_platform_device_count``). The banner reports
the effective ``tp``, ``mesh_shape``, ``collective_dtype``,
``collective_overlap`` and the shards' devices (``tp_devices``).
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def _with_devices(banner, engine):
    """The banner, and under tensor parallelism where the shards run
    (``tp_devices``: all on ``--device``). A tp=1 banner is the JAX CLI's,
    key for key."""
    if engine.tp > 1:
        banner["tp_devices"] = [str(d) for d in engine.tp_devices]
    return banner


def build_model(preset, decode_attention, seed, device="cuda"):
    from ...core import random as prng
    from ...models.llama import LlamaConfig, LlamaForCausalLM, llama_tiny
    prng.seed(seed)
    if preset == "tiny":
        return LlamaForCausalLM(llama_tiny(decode_attention=decode_attention),
                                device=device, seed=seed)
    if preset == "350m":
        return LlamaForCausalLM(LlamaConfig(
            vocab_size=32000, hidden_size=1024, intermediate_size=2816,
            num_hidden_layers=24, num_attention_heads=16,
            num_key_value_heads=16, max_position_embeddings=2048,
            dtype="bfloat16", decode_attention=decode_attention),
            device=device, seed=seed)
    raise ValueError(f"unknown preset {preset!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.server",
        description="Streaming HTTP serving gateway over the "
                    "continuous-batching engine.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 = ephemeral (printed at startup)")
    ap.add_argument("--preset", choices=("tiny", "350m"), default="tiny")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model and the engine run; cuda "
                         "without a GPU exits nonzero")
    ap.add_argument("--decode-attention", choices=("pallas", "jnp"),
                    default="jnp",
                    help="the hand-written CUDA kernels (pallas) or "
                         "their plain PyTorch versions (jnp)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine fleet size (README 'Engine fleet'): "
                         ">1 fronts N shared-nothing engine replicas "
                         "behind one routed gateway — per-replica "
                         "paged pool/prefix trie/supervisor, compiled "
                         "programs shared per pool geometry, "
                         "replica-labeled /metrics, /debug/fleet, "
                         "POST /fleet/drain|rebalance, and failover-"
                         "to-sibling on replica death")
    ap.add_argument("--router",
                    choices=("round-robin", "least-loaded", "affinity",
                             "class-headroom"),
                    default="affinity",
                    help="fleet routing policy (--replicas > 1): "
                         "round-robin, least-loaded (live KV blocks + "
                         "queue depth), affinity (longest cached-"
                         "prefix match within a load band; the "
                         "default), or class-headroom (lowest "
                         "non-displaceable class pressure for the "
                         "request's priority class — pair with "
                         "--classes)")
    ap.add_argument("--affinity-band", type=int, default=16,
                    help="affinity router's load band (KV blocks + "
                         "queued requests): replicas loaded more than "
                         "this past the minimum are skipped no matter "
                         "how warm their trie is")
    ap.add_argument("--num-slots", default="8",
                    help="KV slots per engine; with --replicas > 1 a "
                         "comma list gives each replica its own value "
                         "(e.g. 8,4 — differing pool geometries keep "
                         "isolated jit caches)")
    ap.add_argument("--max-seq-len", type=int, default=None)
    ap.add_argument("--decode-chunk", type=int, default=1,
                    help=">1 fuses decode ticks (adds streaming latency)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="waiting-room bound before 429s")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="automatic prefix caching: reuse KV blocks of "
                         "shared prompt prefixes across requests")
    ap.add_argument("--prefix-blocks", type=int, default=None,
                    help="prefix-cache pool size in blocks (default: "
                         "num_slots * max_seq_len / block_size)")
    ap.add_argument("--prefix-block-size", type=int, default=32,
                    help="tokens per cached KV block")
    ap.add_argument("--host-tier-bytes", type=int, default=0,
                    help="host-RAM spill tier behind the prefix trie, in "
                         "bytes (0 disables; needs --prefix-cache): "
                         "evicted chains spill d2h and readmit on a hit; "
                         "with --replicas the per-replica tiers form the "
                         "fleet cache plane (/fleet/cacheplane)")
    ap.add_argument("--paged-attn", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="block-table paged attention (DEFAULT: the block "
                         "pool IS the KV cache, prefix hits install "
                         "zero-copy and concurrent holders share physical "
                         "blocks); --no-paged-attn selects the legacy "
                         "dense per-slot cache")
    ap.add_argument("--prefill-chunk", type=int, default=512,
                    help="chunked prefill: max prompt tokens prefilled "
                         "per engine step (paged engine only; bounds TTFT "
                         "under mixed traffic; 0 disables)")
    ap.add_argument("--ragged-step", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="unified ragged step (DEFAULT, paged only): "
                         "decode rows + prefill chunks ride ONE device "
                         "program per step; --no-ragged-step keeps the "
                         "two-program chunk+decode interleave")
    ap.add_argument("--headroom-mult", type=float, default=2.0,
                    help="adaptive chunk budget: grant ~this many "
                         "decode-steps' worth of measured throughput to "
                         "prefill chunks per step (unified step only; "
                         "0 pins the fixed prefill-chunk cap)")
    ap.add_argument("--decode-ticks", type=int, default=1,
                    help="multi-tick decode (unified ragged engine "
                         "only): fuse up to this many on-device decode "
                         "ticks behind ONE host sync when every "
                         "running slot is in pure decode — EOS/budget "
                         "cuts are masked on device, streams stay "
                         "byte-identical, and the host round-trip "
                         "amortizes n-fold (tokens stream in bursts "
                         "of up to n). Mixed traffic clamps back to "
                         "single-tick. 1 = off (the baseline)")
    ap.add_argument("--kv-dtype", choices=("pool", "int8", "fp8"),
                    default="pool",
                    help="KV cache storage dtype (README 'Quantized "
                         "serving'): 'pool' stores at the model dtype "
                         "(the default — every banked baseline), "
                         "'int8' serves from the block-quantized pool "
                         "(unified ragged paged engine only; appends "
                         "quantize on write, the attention kernels "
                         "upcast in-register after the table-indirect "
                         "DMA, ~4x pool HBM cut vs fp32 = ~4x "
                         "concurrent slots at a fixed budget), 'fp8' "
                         "stores float8_e4m3fn with per-BLOCK scale "
                         "planes — fewer scale bytes per cached token "
                         "than int8's per-row planes and no quantize "
                         "arithmetic on the append path")
    ap.add_argument("--quantize-weights",
                    action=argparse.BooleanOptionalAction, default=False,
                    help="int8 weight-only decode matmuls: convert the "
                         "decode-path projection weights once at engine "
                         "build (per-channel absmax scales, dequant "
                         "fused into the matmul) — weight HBM traffic "
                         "drops ~4x vs fp32 at a measured-not-assumed "
                         "quality cost")
    ap.add_argument("--quantize-activations",
                    action=argparse.BooleanOptionalAction, default=False,
                    help="int8xint8 decode projections (requires "
                         "--quantize-weights; unified ragged paged "
                         "engine only): quantize each projection input "
                         "per-row at runtime and contract int8 against "
                         "the int8 weights with int32 accumulate — the "
                         "per-layer weight dequant disappears from the "
                         "decode step entirely (greedy divergence "
                         "measured in DENSITY_BENCH.json, not assumed)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (README 'Tensor-"
                         "parallel serving'): shard every serving "
                         "program over this many devices on a heads-"
                         "sharded mesh with the paged KV pool "
                         "partitioned per shard (unified ragged paged "
                         "engine only; must divide the model's head "
                         "counts). Every shard sits on --device. "
                         "1 = single-chip (the baseline)")
    ap.add_argument("--collective-dtype", choices=("fp", "int8"),
                    default="fp",
                    help="wire dtype of the per-layer tensor-parallel "
                         "all-reduce: 'fp' is a plain psum, 'int8' "
                         "runs it EQuARX-style block-quantized (~3.5x "
                         "fewer cross-chip bytes; greedy divergence "
                         "measured in TP_BENCH.json, not assumed). "
                         "Ignored (no collectives) at --tp 1")
    ap.add_argument("--fused-tick", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="one-kernel decode (unified ragged paged "
                         "engine only): every tail tick of a fused "
                         "decode step is ONE launch of the fused-tick "
                         "kernel instead of the per-layer stack; "
                         "streams stay equal and the launch census on "
                         "GET /debug/profile shows the count. Needs "
                         "--decode-chunk > 1 to have tail ticks")
    ap.add_argument("--collective-overlap",
                    action=argparse.BooleanOptionalAction, default=False,
                    help="TP compute/collective overlap (requires "
                         "--tp > 1): the per-layer all-reduce pair "
                         "runs a chunked reduce-scatter/all-gather "
                         "schedule interleaved with the next "
                         "projection's compute — wire format (incl. "
                         "EQuARX int8) and the collective-bytes "
                         "ledger stay exact, streams byte-identical")
    ap.add_argument("--spec-decode", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="speculative multi-token decode (paged only): "
                         "a prompt-lookup n-gram drafter proposes up to "
                         "--spec-k tokens per slot, one ragged-span "
                         "verify scores them, rejected KV rolls back by "
                         "block-tail truncation; streams byte-identical "
                         "to speculation off")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens per verify span")
    ap.add_argument("--trace", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="record request-lifecycle/step-phase tracing "
                         "from startup into the ring buffer (read it "
                         "back with GET /debug/trace?steps=0); off = "
                         "zero-cost until /debug/trace?steps=N opens a "
                         "capture window")
    ap.add_argument("--trace-buffer", type=int, default=65536,
                    help="trace ring-buffer capacity in events (oldest "
                         "dropped past it)")
    ap.add_argument("--cost", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="device-boundary cost observatory (exact "
                         "dispatch/transfer/compile accounting behind "
                         "GET /debug/profile and the "
                         "serving_dispatches_total metrics); --no-cost "
                         "reduces every cost site to one attribute "
                         "check")
    ap.add_argument("--watchdog-deadline", type=float, default=30.0,
                    help="supervised driver: a step slower than this "
                         "(seconds) is classified hung and the engine is "
                         "rebuilt with in-flight requests recovered by "
                         "recompute (0 disables the watchdog)")
    ap.add_argument("--max-restarts", type=int, default=8,
                    help="engine rebuild budget after fatal/hung step "
                         "faults before the gateway gives up (0 disables "
                         "crash recovery)")
    ap.add_argument("--classes", default=None,
                    help="multi-tenant SLO priority classes (README "
                         "'Multi-tenant SLO serving'): comma list of "
                         "name[*][:reserved_slots], highest priority "
                         "first — e.g. 'latency:1,standard,batch*'. "
                         "'*' marks the default class for unlabeled "
                         "requests (else the last listed). Requests "
                         "pick a tier via the priority_class body "
                         "field or X-Priority-Class header; unknown "
                         "names 400. Default: one neutral class "
                         "(policy off, FIFO baseline)")
    ap.add_argument("--slo-ttft-ms", default=None,
                    help="per-class TTFT SLO targets in ms, aligned "
                         "with --classes (comma list; 0 or a missing "
                         "tail entry = no target). An urgent waiter "
                         "past half its target preempts strictly-"
                         "lower-class running work by recompute")
    ap.add_argument("--slo-tpot-ms", default=None,
                    help="per-class TPOT SLO targets in ms, aligned "
                         "with --classes (comma list; 0 = no target). "
                         "Observed per finished request into "
                         "serving_slo_misses_total{class,slo='tpot'}")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-request access logs")
    args = ap.parse_args(argv)

    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("--device cuda: no CUDA device (pass --device cpu to "
                  "serve on the CPU)", file=sys.stderr)
            return 2
    from .httpd import serve, serve_fleet
    try:
        slots = [int(s) for s in str(args.num_slots).split(",")
                 if s.strip()]
    except ValueError:
        ap.error(f"--num-slots must be an int or a comma list of ints, "
                 f"got {args.num_slots!r}")
    if not slots:
        ap.error(f"--num-slots must name at least one value, "
                 f"got {args.num_slots!r}")
    if len(slots) > 1 and args.replicas <= 1:
        ap.error("--num-slots with a comma list needs --replicas > 1 "
                 "(one value per replica)")
    if len(slots) > 1 and len(slots) != args.replicas:
        ap.error(f"--num-slots names {len(slots)} values for "
                 f"--replicas {args.replicas}")
    model = build_model(args.preset, args.decode_attention, args.seed,
                        args.device)
    kv_dtype = None if args.kv_dtype == "pool" else args.kv_dtype
    if args.replicas > 1:
        num_slots = slots if len(slots) > 1 else slots[0]
        server = serve_fleet(
            model, replicas=args.replicas, router=args.router,
            affinity_band=args.affinity_band,
            host=args.host, port=args.port, num_slots=num_slots,
            max_seq_len=args.max_seq_len, decode_chunk=args.decode_chunk,
            max_queue=args.max_queue, model_name=f"llama-{args.preset}",
            prefix_cache=args.prefix_cache,
            prefix_blocks=args.prefix_blocks,
            prefix_block_size=args.prefix_block_size,
            host_tier_bytes=args.host_tier_bytes,
            paged_attn=args.paged_attn, prefill_chunk=args.prefill_chunk,
            ragged_step=args.ragged_step,
            headroom_mult=args.headroom_mult or None,
            spec_decode=args.spec_decode, spec_k=args.spec_k,
            decode_ticks=args.decode_ticks, kv_dtype=kv_dtype,
            quantize_weights=args.quantize_weights,
            quantize_activations=args.quantize_activations,
            tp=args.tp, collective_dtype=args.collective_dtype,
            fused_tick=args.fused_tick,
            collective_overlap=args.collective_overlap,
            classes=args.classes, slo_ttft_ms=args.slo_ttft_ms,
            slo_tpot_ms=args.slo_tpot_ms,
            trace=args.trace, trace_buffer=args.trace_buffer,
            cost=args.cost,
            watchdog_deadline_s=args.watchdog_deadline or None,
            max_restarts=args.max_restarts,
            log_fn=None if args.quiet else
            (lambda m: print(m, file=sys.stderr)))
        fleet = server.fleet
        print(json.dumps(_with_devices({
            "listening": server.url, "preset": args.preset,
            "replicas": len(fleet.replicas),
            "router": fleet.router.name,
            "num_slots": [r.gateway.engine.num_slots
                          for r in fleet.replicas],
            "prefix_cache": bool(args.prefix_cache),
            "paged_attn": bool(args.paged_attn),
            "prefill_chunk": [r.gateway.engine.prefill_chunk
                              for r in fleet.replicas],
            "spec_decode": fleet.replicas[0].gateway.engine.spec_decode,
            "decode_ticks":
                fleet.replicas[0].gateway.engine.decode_ticks,
            # effective-value idiom: the engines' actual storage dtype
            # and weight mode, not the flag spelling
            "kv_dtype": fleet.replicas[0].gateway.engine.kv_dtype,
            "quantize_weights":
                fleet.replicas[0].gateway.engine.quantize_weights,
            "quantize_activations":
                fleet.replicas[0].gateway.engine.quantize_activations,
            # effective-value idiom: the engines' ACTUAL mesh shape
            # (devices per replica on the "tp" axis) and the wire
            # dtype their per-layer all-reduce really runs
            "tp": fleet.replicas[0].gateway.engine.tp,
            "mesh_shape":
                {"tp": fleet.replicas[0].gateway.engine.tp},
            "collective_dtype":
                fleet.replicas[0].gateway.engine.collective_dtype,
            # effective-value idiom: whether the engines' decode tick
            # really runs the one-kernel program / overlap schedule
            "fused_tick": fleet.replicas[0].gateway.engine.fused_tick,
            "collective_overlap":
                fleet.replicas[0].gateway.engine.collective_overlap,
            # effective-value idiom: the parsed class table the fleet's
            # engines actually schedule with (ranks, ms targets,
            # reserved headroom, the default marker) — not the flag
            # spelling
            "classes": fleet.classes.doc(),
            "trace": fleet.tracer.enabled,
            "cost": fleet.replicas[0].gateway.cost is not None,
            "endpoints": ["/v1/completions", "/healthz", "/metrics",
                          "/debug/trace", "/debug/requests",
                          "/debug/profile", "/debug/fleet",
                          "/fleet/drain", "/fleet/rebalance",
                          "/fleet/cacheplane"]},
            fleet.replicas[0].gateway.engine)), flush=True)
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
        stop.wait()
        print("# draining fleet...", file=sys.stderr)
        server.shutdown(drain=True, timeout=60)
        print("# stopped", file=sys.stderr)
        return 0
    server = serve(
        model, host=args.host, port=args.port, num_slots=slots[0],
        max_seq_len=args.max_seq_len, decode_chunk=args.decode_chunk,
        max_queue=args.max_queue, model_name=f"llama-{args.preset}",
        prefix_cache=args.prefix_cache, prefix_blocks=args.prefix_blocks,
        prefix_block_size=args.prefix_block_size,
        host_tier_bytes=args.host_tier_bytes,
        paged_attn=args.paged_attn, prefill_chunk=args.prefill_chunk,
        ragged_step=args.ragged_step,
        headroom_mult=args.headroom_mult or None,
        spec_decode=args.spec_decode, spec_k=args.spec_k,
        decode_ticks=args.decode_ticks, kv_dtype=kv_dtype,
        quantize_weights=args.quantize_weights,
        quantize_activations=args.quantize_activations,
        tp=args.tp, collective_dtype=args.collective_dtype,
        fused_tick=args.fused_tick,
        collective_overlap=args.collective_overlap,
        classes=args.classes, slo_ttft_ms=args.slo_ttft_ms,
        slo_tpot_ms=args.slo_tpot_ms,
        trace=args.trace, trace_buffer=args.trace_buffer,
        cost=args.cost,
        watchdog_deadline_s=args.watchdog_deadline or None,
        max_restarts=args.max_restarts,
        log_fn=None if args.quiet else
        (lambda m: print(m, file=sys.stderr)))
    print(json.dumps(_with_devices({"listening": server.url,
                                    "preset": args.preset,
                      "num_slots": slots[0],
                      "prefix_cache": bool(args.prefix_cache),
                      "paged_attn": bool(args.paged_attn),
                      # report what actually runs: the engine's
                      # block-rounded chunk, 0 when chunking is off or
                      # the dense engine ignores it
                      "prefill_chunk":
                      server.gateway.engine.prefill_chunk,
                      # report what actually runs: the dense engine
                      # ignores --ragged-step
                      "ragged_step": server.gateway.engine.ragged_step,
                      "spec_decode": server.gateway.engine.spec_decode,
                      "spec_k": server.gateway.engine.spec_k,
                      # report what actually runs: the engine's
                      # effective multi-tick fuse depth (1 = off)
                      "decode_ticks": server.gateway.engine.decode_ticks,
                      # effective-value idiom: the engine's actual KV
                      # storage dtype ("int8" or the pool array dtype)
                      # and whether decode weights really run int8
                      "kv_dtype": server.gateway.engine.kv_dtype,
                      "quantize_weights":
                      server.gateway.engine.quantize_weights,
                      "quantize_activations":
                      server.gateway.engine.quantize_activations,
                      # effective-value idiom: the EFFECTIVE mesh
                      # shape (the "tp" axis the programs actually
                      # shard over; 1 = no mesh) and the wire dtype
                      # of the per-layer all-reduce
                      "tp": server.gateway.engine.tp,
                      "mesh_shape": {"tp": server.gateway.engine.tp},
                      "collective_dtype":
                      server.gateway.engine.collective_dtype,
                      # effective-value idiom: whether the decode tick
                      # really runs the one-kernel program / overlap
                      # schedule (README "One-kernel decode")
                      "fused_tick": server.gateway.engine.fused_tick,
                      "collective_overlap":
                      server.gateway.engine.collective_overlap,
                      # effective-value idiom: the EFFECTIVE class
                      # table the engine schedules with (parsed ranks,
                      # ms targets, reserved headroom, default marker)
                      "classes": server.gateway.engine.classes.doc(),
                      # report what actually runs: whether the tracer
                      # is RECORDING now (the persistent --trace mode)
                      # and the effective ring capacity
                      "trace": server.gateway.tracer.enabled,
                      "trace_buffer": server.gateway.tracer.capacity,
                      # effective-value idiom: whether the cost
                      # observatory is actually accounting
                      "cost": server.gateway.cost is not None,
                      "watchdog_deadline_s":
                      server.gateway.watchdog_deadline_s,
                      "max_restarts": server.gateway.max_restarts,
                      "endpoints": ["/v1/completions", "/healthz",
                                    "/metrics", "/debug/trace",
                                    "/debug/requests",
                                    "/debug/profile"]},
                                   server.gateway.engine)), flush=True)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    print("# draining...", file=sys.stderr)
    server.shutdown(drain=True, timeout=60)
    print("# stopped", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
