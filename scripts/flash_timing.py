"""Time the flash kernels of one checkout (argv[1], a directory holding
``paddle_tpu_torch``) on a CUDA card: the forward at B=4, S=512 and
S=2048, dK/dV and dQ at S=2048 (bf16, 32 heads of 128, [B, S, H, D]), by
CUDA events over 50 calls (20 for the backward) and by the profiler's
device time; prints one JSON line. To compare two trees on one card, run
it in turns from one command, for example parent, change, change, parent:

    for r in parent . . parent; do python3 scripts/flash_timing.py $r; done
"""
import json, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
from torch.profiler import ProfilerActivity, profile
from paddle_tpu_torch.kernels import flash
dev = "cuda"
g = torch.Generator(device=dev).manual_seed(0)

def ev(fn, n=50):
    for _ in range(5): fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n): fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / n

def dev_ms(fn, n=20):
    fn(); torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(n): fn()
        torch.cuda.synchronize()
    tot = sum(e.self_device_time_total for e in p.key_averages() if "kernel" in e.key.lower() or "flash" in e.key.lower())
    return tot / 1e3 / n

out = {"root": root}
for S in (512, 2048):
    q, k, v, do = (torch.randn(4, S, 32, 128, generator=g, device=dev).bfloat16() for _ in range(4))
    out[f"fwd_autograd_{S}"] = ev(lambda: flash.flash_attention(q, k, v, causal=True))
    out[f"fwd_{S}"] = ev(lambda: flash.flash_attention_fwd(q, k, v, True))
    out[f"fwd_device_{S}"] = dev_ms(lambda: flash.flash_attention_fwd(q, k, v, True))
    if S == 2048:
        o, lse = flash.flash_attention_fwd(q, k, v, True)
        delta = flash.attention_delta(o, do)
        out["dkv_2048"] = ev(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, True), 20)
        out["dq_2048"] = ev(lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, True), 20)
        out["dkv_device_2048"] = dev_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, True))
        out["dq_device_2048"] = dev_ms(lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, True))
print(json.dumps(out), flush=True)
