"""Time the flash kernels of one checkout (argv[1], a directory holding
``paddle_tpu_torch``) on a CUDA card: the forward at B=4, S=512 and
S=2048, dK/dV and dQ at S=2048 (bf16, 32 heads of 128, [B, S, H, D]), by
CUDA events over 50 calls (20 for the backward) and by the profiler's
device time; then the fused-RoPE backward (``rope=``) at B=4, S=2048,
32 heads of 128 in the head-major layout: both standalone entries, the
whole ``flash_attention_bwd`` and, where the checkout has the ``rope_qk``
pre-pass, the pre-pass and the two bodies apart; the same kernels on
inputs rotated beforehand; the library pair (torch rotation, SDPA
forward+backward less forward); and a SHA-256 of the bytes of dQ, dK and
dV from seeded inputs (bf16 at that shape, float32 at B=1, S=512, 8
heads of 128), so two checkouts can be held to the same bits. The
fused-RoPE forward at the same shape: ``flash_attention_fwd(..., rope)``
(whatever rotation the checkout does, counted in), the same entry on
inputs rotated beforehand, and a SHA-256 of its O and LSE (bf16 at that
shape, float32 at the small one). ``--train`` adds one 15-layer
``bhsd + fuse_rope`` run of ``chip_smoke.py``'s train phase (LLaMA-7B
widths, B=4, S=2048, bf16: its JSON line holds the step times and the
peak memory). Prints one JSON line. To compare two trees on one card,
run it in turns from one command, for example parent, change, change,
parent:

    for r in parent . . parent; do python3 scripts/flash_timing.py $r; done
"""
import hashlib, json, sys
root = sys.argv[1]
train = "--train" in sys.argv[2:]
sys.path.insert(0, root)
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
from paddle_tpu_torch.kernels import _build, flash
from paddle_tpu_torch.models.llama import _apply_rope_bhsd, _rope_tables
dev = "cuda"
g = torch.Generator(device=dev).manual_seed(0)
# build the libraries this script launches at once, one nvcc each
_build.build_all([n for n in ("flash", "flash_bwd_dkv", "flash_bwd_dq",
                              "rope_qk") if n in _build.SIGNATURES])

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

def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()

out = {"root": root, "card": torch.cuda.get_device_name(0)}
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
del q, k, v, do, o, lse, delta

# the rope= backward, head-major [B, H, S, D] memory seen as [B, S, H, D]
def rope_inputs(B, S, H, dtype, seed):
    gh = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, S, 128, generator=gh, device=dev).to(dtype).transpose(1, 2) for _ in range(4))
    rope = _rope_tables(S, 128, 10000.0, device=dev)
    o, lse = flash.flash_attention_fwd(q, k, v, True, rope)
    return q, k, v, do, o, lse, rope

q, k, v, do, o, lse, rope = rope_inputs(4, 2048, 32, torch.bfloat16, 1)
delta = flash.attention_delta(o, do)
qr, kr = flash._rotated(q, k, rope)
# the forward with its rotation, and on inputs rotated beforehand
fwd_runs = {"rope_fwd": lambda: flash.flash_attention_fwd(q, k, v, True, rope),
            "rope_fwd_prerotated": lambda: flash.flash_attention_fwd(qr, kr, v, True)}
for name, fn in fwd_runs.items():
    out[f"{name}_2048"] = ev(fn, 20)
    out[f"{name}_device_2048"] = dev_ms(fn)
out["rope_fwd_sha256_bf16"] = digest(flash.flash_attention_fwd(q, k, v, True, rope))
runs = {
    "rope_dkv": lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, True, rope),
    "rope_dq": lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, True, rope),
    "rope_bwd": lambda: flash.flash_attention_bwd(q, k, v, o, lse, do, True, rope),
    "rotated_dkv": lambda: flash.flash_bwd_dkv(qr, kr, v, do, lse, delta, True),
    "rotated_dq": lambda: flash.flash_bwd_dq(qr, kr, v, do, lse, delta, True),
}
if hasattr(flash, "rope_qk"):
    ops = flash._bwd_operands("rope bwd", q, k, v, do, lse, delta, rope)
    runs["rope_qk"] = lambda: flash.rope_qk(q, k, *rope)
    runs["rope_dkv_body"] = lambda: flash._launch_dkv(*ops, lse, delta, True)
    runs["rope_dq_body"] = lambda: flash._launch_dq(*ops, lse, delta, True)
for name, fn in runs.items():
    out[f"{name}_2048"] = ev(fn, 20)
    out[f"{name}_device_2048"] = dev_ms(fn)
qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
dot = do.transpose(1, 2).contiguous()
sin, cos = rope
lib_fwd = lambda: F.scaled_dot_product_attention(_apply_rope_bhsd(qt, sin, cos), _apply_rope_bhsd(kt, sin, cos), vt, is_causal=True)
with torch.no_grad():
    lib_f = ev(lib_fwd, 20)
out["library_pair_2048"] = ev(lambda: torch.autograd.grad(lib_fwd(), (qt, kt, vt), dot), 20) - lib_f
out["rope_bwd_sha256_bf16"] = digest(flash.flash_attention_bwd(q, k, v, o, lse, do, True, rope))
out["rope_entries_sha256_bf16"] = digest((flash.flash_bwd_dq(q, k, v, do, lse, delta, True, rope),) + flash.flash_bwd_dkv(q, k, v, do, lse, delta, True, rope))
del q, k, v, do, o, lse, delta, qr, kr, qt, kt, vt, dot, runs
q, k, v, do, o, lse, rope = rope_inputs(1, 512, 8, torch.float32, 2)
out["rope_bwd_sha256_fp32"] = digest(flash.flash_attention_bwd(q, k, v, o, lse, do, True, rope))
out["rope_fwd_sha256_fp32"] = digest(flash.flash_attention_fwd(q, k, v, True, rope))
del q, k, v, do, o, lse
torch.cuda.empty_cache()
if train:
    import chip_smoke
    chip_smoke._train_run("bhsd_fuse_rope", 15, {"attention_layout": "bhsd", "fuse_rope": True})
print(json.dumps(out), flush=True)
