"""Probe whether ``torch.profiler`` keeps every kernel record of a short
profiled window as the process ages, on one CUDA card: three calls (a
1024-square and a 4096-square bf16 matmul, and paged decode at
LLaMA-13B's 40 x 128 heads over the smoke's 8 decode rows) profiled 20
times each, at the start; after 200 short profiles; after one profile of
20 000 launches; beside a thread launching on another stream; and after
60 and 180 s more, without and with host sleeps inside the window. Each
line: the kernel records kept (``n``; 20 a call for the small matmul and
paged decode) and their summed time a call, and with the CPU activity
the launch records and the first kernel's start less the first launch's.

Run from the repository root: ``python3 scripts/profiler_drop_probe.py``
(builds the paged decode library first).
"""
import json
import sys
import threading
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
T0 = time.perf_counter()


def emit(**kw):
    kw["age_s"] = round(time.perf_counter() - T0, 1)
    print(json.dumps(kw), flush=True)


dev = "cuda"
g = torch.Generator(device=dev).manual_seed(0)
a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16, generator=g)
b = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16, generator=g)
s1 = torch.randn(1024, 1024, device=dev, dtype=torch.bfloat16, generator=g)


def small():
    return s1 @ s1


def big():
    return a @ b


from paddle_tpu_torch.kernels import _build, paged_decode
import chip_smoke as cs
_build.build_all(["paged_decode"])
gen = torch.Generator(device=dev).manual_seed(0)
q, pk, pv, tab, ln = cs.paged_inputs(torch.bfloat16, dev, gen,
                                     heads=cs.Heads(40, 40, 128))


def paged():
    return paged_decode.paged_decode_attention(q, pk, pv, tab, ln)


FNS = {"small": small, "big": big, "paged": paged}


def probe(tag, pad=0.0, cpu=False, iters=20):
    out = {}
    for name, fn in FNS.items():
        fn()
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu
                                          else [])
        with profile(activities=acts) as prof:
            if pad:
                time.sleep(pad)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            if pad:
                time.sleep(pad)
        evs = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
        n = len(evs)
        dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.self_device_time_total > 0) / 1e3 / iters
        row = {"n": n, "dev_ms": round(dev_ms, 5)}
        if cpu:
            launches = sorted(e.time_range.start for e in prof.events()
                              if "LaunchKernel" in e.name)
            ks = sorted(e.time_range.start for e in evs)
            row["n_launch"] = len(launches)
            if launches and ks:
                row["first_k_minus_first_launch_us"] = ks[0] - launches[0]
        out[name] = row
    emit(tag=tag, pad=pad, cpu=cpu, **out)


emit(torch=torch.__version__, cuda=torch.version.cuda,
     gpu=torch.cuda.get_device_name(0))
probe("start")
probe("start", cpu=True)
probe("start", pad=0.05)

# many short profiles
for _ in range(200):
    with profile(activities=[ProfilerActivity.CUDA]):
        small()
        torch.cuda.synchronize()
probe("after_200_profiles")
probe("after_200_profiles", cpu=True)

# one profile with many launches
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
    x = s1
    for _ in range(20000):
        x = x * 1.0
    torch.cuda.synchronize()
probe("after_big_profile")
probe("after_big_profile", cpu=True)
probe("after_big_profile", pad=0.05)

# a thread that launches work while the main thread profiles
stop = threading.Event()


def spin():
    with torch.cuda.stream(torch.cuda.Stream()):
        while not stop.is_set():
            small()
            time.sleep(0.001)


t = threading.Thread(target=spin)
t.start()
probe("beside_thread")
stop.set()
t.join()

for wait in (60, 120):
    time.sleep(wait)
    probe(f"aged_{wait}")
    probe(f"aged_{wait}", cpu=True)
    probe(f"aged_{wait}", pad=0.05)
    probe(f"aged_{wait}", pad=0.3)
