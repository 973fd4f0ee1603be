"""Symmetric int8 quantization rules of the serving path.

The port of two functions of ``paddle_tpu/quantization/__init__.py``:
:func:`quantize_weight_int8` (per-output-channel weight quantization, the
engine's ``quantize_weights=True``) and :func:`quantize_collective_int8`
(per-row quantization of an activation, the engine's
``quantize_activations=True``). Both give the JAX functions' bits on the
same float32 input: the absmax scale, IEEE division by ``max(scale,
1e-30)`` (never a multiply by a reciprocal) and round half to even, as
``jnp.round`` does. The rest of that module (QAT, PTQ, the converted
layers) is not ported (ROADMAP Queue A step 14).
"""
from __future__ import annotations

import torch

__all__ = ["quantize_weight_int8", "quantize_collective_int8"]


def _round_clip(x, scale, qmax):
    return torch.clamp(torch.round(x / torch.clamp(scale, min=1e-30)),
                       -qmax, qmax).to(torch.int8)


def quantize_weight_int8(w, reduce_axis, bits=8):
    """Symmetric per-channel int8 quantization of a weight: ``reduce_axis``
    is the contraction axis of the product the weight feeds, so each
    output channel gets its own absmax scale. Returns ``(q int8, scale
    float32)``, ``scale`` keeping the reduced axis as size 1; an all-zero
    channel has scale 0 and dequantizes to exact zeros. ``bits < 8``
    narrows the grid inside the int8 storage."""
    if not 2 <= int(bits) <= 8:
        raise ValueError(
            f"int8 storage holds 2..8-bit symmetric grids, got "
            f"bits={bits}")
    qmax = float(2 ** (int(bits) - 1) - 1)
    wf = torch.as_tensor(w).float()
    scale = torch.amax(wf.abs(), dim=reduce_axis, keepdim=True) / qmax
    return _round_clip(wf, scale, qmax), scale


def quantize_collective_int8(x):
    """Symmetric per-row int8 quantization (absmax over the last axis):
    ``(q int8, scale float32 [..., 1])``; an all-zero row has scale 0 and
    dequantizes to exact zeros."""
    xf = x.float()
    scale = torch.amax(xf.abs(), dim=-1, keepdim=True) / 127.0
    return _round_clip(xf, scale, 127.0), scale
