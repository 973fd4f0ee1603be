"""Time kernel rows of one checkout (argv[1], a directory holding
``chip_smoke.py`` and ``paddle_tpu_torch``) on a CUDA card: that
checkout's ``chip_smoke.kernel_case`` for each kernel named after it
(default ``ragged_attention``, ``paged_decode``, ``decode``, ``flash``)
in bf16 at the smoke's LLaMA-7B serving heads (32 of 128), its inputs
from the smoke's seed. Prints one JSON line: the card, and for each
kernel its error against the plain version, milliseconds by CUDA events
and by the profiler, the bound, and the flash forward's time at the
training shape. To compare two trees on one card, run it in turns from
one command, for example parent, change, change, parent:

    for r in build/parent . . build/parent; do python3 scripts/kernel_rows.py $r; done
"""
import json
import sys

root = sys.argv[1]
names = sys.argv[2:] or ["ragged_attention", "paged_decode", "decode",
                         "flash"]
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
_build.build_all(names)
out = {"root": root, "card": torch.cuda.get_device_name(0)}
for name in names:
    row = chip_smoke.kernel_case(name, "bfloat16", dev, gen,
                                 heads=chip_smoke.HEADS)
    out[name] = {k: row.get(k) for k in ("max_abs_err", "ms", "device_ms",
                                         "bound_ms", "ms_train_shape")}
    torch.cuda.empty_cache()
print(json.dumps(out))
