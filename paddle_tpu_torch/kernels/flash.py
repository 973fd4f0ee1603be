"""Flash attention forward: causal attention over ``[B, S, H, D]`` with a
tiled online softmax, emitting the log-sum-exp per query row.

Replaces the forward of ``paddle_tpu/kernels/pallas_flash.py``
(``_fwd_kernel`` via ``_flash_fwd``, entry ``flash_attention_pallas``);
the CUDA kernel is ``paddle_tpu_torch/csrc/flash.cu``. What bounds it on
the H100: operations (the causal product). Its design: one block per
(batch*head, 64-row query tile), K/V streamed in 32-key tiles past the
resident queries, causal tiles past the diagonal never visited, the tail
past S masked, GQA by indexing the KV head (K/V never repeated). The
backward (``_dkv_kernel``/``_dq_kernel``) and the fused-RoPE prologue
are not ported yet.
"""
from __future__ import annotations

import torch

from ._launch import check_cuda, launch
from .flash_attention import _ref_attention, _ref_lse


def flash_attention_fwd(q, k, v, causal=True):
    """``(out [B, S, H, D], lse [B, H, S] float32)``: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. k/v are
    ``[B, S, Hk, D]`` with ``H % Hk == 0``."""
    if q.device.type == "cpu":
        return _ref_attention(q, k, v, causal), _ref_lse(q, k, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, got "
                         f"{q.device}")
    B, S, H, D = q.shape
    Hk = k.shape[2]
    if k.shape != (B, S, Hk, D) or v.shape != k.shape or H % Hk:
        raise ValueError(f"flash: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if D not in (64, 128):
        raise NotImplementedError(f"flash kernel: head_dim {D} not in "
                                  f"(64, 128)")
    code = check_cuda("flash", (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    launch("flash", q, k, v, out, lse, B, S, H, Hk, D, int(bool(causal)),
           code)
    return out, lse


def flash_attention(q, k, v, causal=True):
    """Flash forward output only (see :func:`flash_attention_fwd`)."""
    return flash_attention_fwd(q, k, v, causal)[0]
