"""Kernels of the serving and training paths — the attention kernels and
the fused decode tick — each a hand-written CUDA kernel for Hopper
(``paddle_tpu_torch/csrc``) beside its plain PyTorch version.

A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises. Every launch adds one to the
kernel's entry in :data:`LAUNCHES`, so a run can show which kernels its
path went through.
"""
from __future__ import annotations

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES = {"flash": 0, "paged_decode": 0, "ragged_attention": 0,
            "flash_bwd_dkv": 0, "flash_bwd_dq": 0, "decode": 0,
            "fused_decode_tick": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name):
    LAUNCHES[name] += 1
