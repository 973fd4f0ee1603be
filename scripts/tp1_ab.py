"""Streams and kernel launches of the port's serving engine without tensor
parallelism (``tp=1``), leg by leg, for holding two checkouts against each
other on one GPU.

Each leg is one engine run to completion through the hand-written kernels,
the launch counts set to 0 just before it and read just after; it prints
one JSON line: the leg, a SHA-256 digest of its token streams and finish
reasons, the tokens and the kernels' launches. The legs: float32 at
LLaMA-7B widths, 2 layers, the smoke's engine requests (prompts of 37, 130,
300 and 700 tokens, 16 new tokens each) on every decode program and
quantized mode; bfloat16 at the same widths on the default, fused-tick and
multi-tick engines; and bfloat16 llama_7b at 32 layers on the smoke's
serve requests (8 prompts of 100 to 1600 tokens, 64 new tokens each, one
seeded top-k). Weights are random from seed 1 (2 layers) and 0 (32).

Usage, from the root of a checkout (``--root`` picks the checkout whose
``paddle_tpu_torch`` runs)::

    python3 scripts/tp1_ab.py [--root DIR] > a.jsonl
    python3 scripts/tp1_ab.py --compare a.jsonl b.jsonl

``--compare`` prints one JSON line per leg (digests and launches equal
or not) and exits nonzero unless every leg agrees.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

#: (leg, knobs) at float32, 2 layers
F32_LEGS = (
    ("default", {}), ("fused_tick", {"fused_tick": True}),
    ("dense", {"paged_attn": False}), ("two_program", {"ragged_step": False}),
    ("ticks8", {"decode_ticks": 8}),
    ("ticks8_fused", {"decode_ticks": 8, "fused_tick": True}),
    ("spec", {"spec_decode": True, "spec_k": 4}),
    ("prefix", {"prefix_cache": True}),
    ("int8_pool", {"kv_dtype": "int8"}), ("fp8_pool", {"kv_dtype": "fp8"}),
    ("w8", {"quantize_weights": True}),
    ("a8", {"quantize_weights": True, "quantize_activations": True}))
#: (leg, knobs) at bfloat16, 2 layers
BF16_LEGS = (("default", {}), ("fused_tick", {"fused_tick": True}),
             ("ticks8", {"decode_ticks": 8}))
#: (leg, knobs) at bfloat16, 32 layers
SERVE_LEGS = (("default", {}), ("fused_tick", {"fused_tick": True}))


def _requests(GenerationRequest, lens, new, vocab, seed, sampled=None):
    import numpy as np
    r = np.random.RandomState(seed)
    reqs = [GenerationRequest(prompt=r.randint(0, vocab, n).astype(np.int32),
                              max_new_tokens=new) for n in lens]
    if sampled is not None:
        r = np.random.RandomState(seed + 1)
        reqs.insert(sampled, GenerationRequest(
            prompt=r.randint(0, vocab, 500).astype(np.int32),
            max_new_tokens=new, temperature=0.8, top_k=40, seed=1234))
    return reqs


def _run(model, reqs, knob, waves=1):
    import torch
    from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, headroom_mult=None, **knob)
    reset_launches()
    outs = []
    for _ in range(waves):
        outs += eng.generate(reqs)
    torch.cuda.synchronize()
    launches = {k: v for k, v in dict(LAUNCHES).items() if v}
    eng.release()
    streams = [[int(t) for t in o.tolist()] for o in outs]
    reasons = [o.finish_reason for o in outs]
    digest = hashlib.sha256(json.dumps([streams, reasons]).encode())
    return {"digest": digest.hexdigest(), "tokens": sum(map(len, streams)),
            "launches": launches}


def run(root):
    sys.path.insert(0, str(Path(root).resolve()))
    import gc

    import torch
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.serving import GenerationRequest
    _build.build_all()
    for dtype, legs in (("float32", F32_LEGS), ("bfloat16", BF16_LEGS)):
        model = LlamaForCausalLM(llama_7b(num_hidden_layers=2, dtype=dtype),
                                 device="cuda", seed=1)
        reqs = _requests(GenerationRequest, (37, 130, 300, 700), 16,
                         model.config.vocab_size, seed=3)
        for leg, knob in legs:
            out = _run(model, reqs, knob, waves=2 if leg == "prefix" else 1)
            print(json.dumps({"leg": f"{dtype}_2l_{leg}", **out}),
                  flush=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    model = LlamaForCausalLM(llama_7b(dtype="bfloat16"), device="cuda",
                             seed=0)
    reqs = _requests(GenerationRequest, (100, 180, 250, 333, 410, 470, 1600),
                     64, model.config.vocab_size, seed=7, sampled=3)
    for leg, knob in SERVE_LEGS:
        print(json.dumps({"leg": f"bfloat16_32l_{leg}",
                          **_run(model, reqs, knob)}), flush=True)


def compare(a, b):
    def legs(path):
        return {d["leg"]: d for d in map(json.loads,
                                         Path(path).read_text().splitlines())
                if "leg" in d}
    la, lb = legs(a), legs(b)
    ok = bool(la) and set(la) == set(lb)
    for leg in la:
        x, y = la[leg], lb.get(leg, {})
        same = {k: x.get(k) == y.get(k) for k in ("digest", "launches")}
        ok = ok and all(same.values())
        print(json.dumps({"leg": leg, **same}))
    print(json.dumps({"legs": len(la), "all_equal": ok}))
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="the checkout to run")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two runs' outputs instead of running")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    run(args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
