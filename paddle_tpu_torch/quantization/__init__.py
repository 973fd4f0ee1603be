"""Symmetric int8 quantization rules of the serving path.

The port of four functions of ``paddle_tpu/quantization/__init__.py``:
:func:`quantize_weight_int8` (per-output-channel weight quantization, the
engine's ``quantize_weights=True``), :func:`quantize_collective_int8`
(per-row quantization of an activation, the engine's
``quantize_activations=True`` and the wire format of the int8
all-reduce), :func:`quantized_psum_int8` (the tensor-parallel engine's
``collective_dtype="int8"`` all-reduce) and :func:`collective_wire_bytes`
(its byte model). The quantizers give the JAX functions' bits on the
same float32 input: the absmax scale, IEEE division by ``max(scale,
1e-30)`` (never a multiply by a reciprocal) and round half to even, as
``jnp.round`` does. The rest of that module (QAT, PTQ, the converted
layers) is not ported (ROADMAP Queue A step 14).
"""
from __future__ import annotations

import torch

__all__ = ["quantize_weight_int8", "quantize_collective_int8",
           "quantized_psum_int8", "collective_wire_bytes"]


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


# ------------------------------------------- quantized all-reduce (EQuARX)
def quantized_psum_int8(parts, devices=None):
    """EQuARX-style block-quantized all-reduce of the per-shard partial
    sums ``parts`` (one ``[..., hidden]`` tensor a shard, ``tp`` of them):
    both phases move int8 payloads plus per-row float32 scales instead of
    full-precision activations. Returns every shard's reduced copy, shard
    ``s``'s on ``devices[s]`` (default: its part's device).

    Phase 1 (reduce-scatter): each shard splits its partial into ``tp``
    chunks along the last axis and quantizes each chunk per row
    (:func:`quantize_collective_int8`); shard ``i`` receives every
    shard's chunk ``i`` (the reference's ``all_to_all``: here list
    indexing and ``.to``), dequantizes them and sums them in float32 in
    the fixed order ``s = 0 .. tp - 1``. Phase 2 (all-gather): each
    reduced chunk requantizes; every shard gathers all of them,
    dequantizes and reassembles. Every shard therefore holds the same
    values. Needs the last axis divisible by ``tp`` (the engine checks
    ``hidden_size % tp == 0``); shape and dtype are kept."""
    tp = len(parts)
    devices = devices or [p.device for p in parts]
    shp = parts[0].shape
    chunk = shp[-1] // tp
    wire = [quantize_collective_int8(p.reshape(*shp[:-1], tp, chunk)
                                     .movedim(-2, 0)) for p in parts]
    gathered = []
    for i in range(tp):                     # shard i reduces chunk i
        dev = devices[i]
        red = None
        for q, sc in wire:
            term = q[i].to(dev).float() * sc[i].to(dev)
            red = term if red is None else red + term
        gathered.append(quantize_collective_int8(red))
    out = []
    for s in range(tp):
        dev = devices[s]
        full = torch.stack([q.to(dev).float() * sc.to(dev)
                            for q, sc in gathered]).movedim(0, -2)
        out.append(full.reshape(shp).to(parts[s].dtype))
    return out


def collective_wire_bytes(rows, hidden, tp, collective_dtype,
                          fp_itemsize=4):
    """Exact per-device wire bytes of ONE per-layer all-reduce of a
    ``[rows, hidden]`` activation over ``tp`` shards — the model behind
    ``serving_collective_bytes_total{dtype}``. Both dtypes are priced on
    the same ring reduce-scatter + all-gather schedule (each phase moves
    ``(tp - 1) / tp`` of the payload a device), so the fp-to-int8 ratio
    isolates the wire format: ``"fp"`` moves ``rows * hidden *
    fp_itemsize`` bytes, ``"int8"`` ``rows * hidden`` int8 bytes plus one
    float32 scale per (row, chunk), ``rows * tp`` scales a phase. Returns
    0 for ``tp <= 1``."""
    if tp <= 1:
        return 0
    if collective_dtype == "int8":
        payload = rows * hidden + rows * tp * 4
    else:
        payload = rows * hidden * fp_itemsize
    return int(2 * payload * (tp - 1) // tp)
