"""Kernels of the serving and training paths — the attention kernels and
the fused decode tick — each a hand-written CUDA kernel for Hopper
(``paddle_tpu_torch/csrc``) beside its plain PyTorch version.

A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises. Every launch adds one to the
kernel's entry in :data:`LAUNCHES`, so a run can show which kernels its
path went through. A CUDA graph launches its kernels at each replay, not
at capture: :func:`capture_counts` takes a capture's counts back and
records them with the graph, and :func:`count_replay` adds them at every
replay, so :data:`LAUNCHES` stays equal to what the device ran.
"""
from __future__ import annotations

import contextlib

#: launches per kernel since the last :func:`reset_launches`
#: (the flash kernels' fused-RoPE mode counts apart, as ``name[rope]``;
#: ``rope_qk`` is that mode's rotation pre-pass of the backward)
LAUNCHES = {"flash": 0, "paged_decode": 0, "ragged_attention": 0,
            "flash_bwd_dkv": 0, "flash_bwd_dq": 0, "decode": 0,
            "fused_decode_tick": 0, "flash[rope]": 0,
            "flash_bwd_dkv[rope]": 0, "flash_bwd_dq[rope]": 0,
            "rope_qk": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name):
    LAUNCHES[name] += 1


@contextlib.contextmanager
def capture_counts(record):
    """Around a CUDA-graph capture: the launches counted inside are taken
    back out of :data:`LAUNCHES` (nothing ran) and stored in ``record``,
    the graph's launches a replay."""
    before = dict(LAUNCHES)
    try:
        yield record
    finally:
        for name in LAUNCHES:
            record[name] = LAUNCHES[name] - before[name]
            LAUNCHES[name] = before[name]


def count_replay(record):
    """One replay of a captured graph: add its launches."""
    for name, n in record.items():
        LAUNCHES[name] += n
