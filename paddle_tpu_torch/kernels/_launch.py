"""Argument checks and the ctypes call shared by the kernel wrappers."""
from __future__ import annotations

import torch

from . import _build, count_launch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t):
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA attention kernels take float32 or "
                        f"bfloat16, got {t.dtype}")
    return _DTYPE_CODE[t.dtype]


#: the narrow storage types of a quantized KV pool
POOL_QUANT = (torch.int8, torch.float8_e4m3fn)


def check_cuda(name, data, index=(), pools=()):
    """Validate what a kernel reads: ``data`` tensors on one CUDA device,
    one float dtype, contiguous and 16-byte aligned (the kernels load 16
    bytes at a time); ``index`` tensors int32 and contiguous; ``pools``
    (K/V pools) like ``data``, or all int8 / all float8_e4m3fn (a
    quantized pool, its planes checked by the caller). Raises on anything
    the kernel does not take; returns the dtype code of ``data``."""
    pools = tuple(pools)
    if pools and pools[0].dtype in POOL_QUANT:
        for t in pools:
            if t.dtype != pools[0].dtype:
                raise TypeError(f"{name}: mixed pool dtypes "
                                f"{pools[0].dtype} and {t.dtype}")
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: pool not 16-byte aligned")
        data, index = tuple(data), tuple(index) + pools
        # the narrow pools skip the float checks, not the device and
        # layout ones (index holds them past the int32 check below)
        n_index = len(index) - len(pools)
    else:
        data, index = tuple(data) + pools, tuple(index)
        n_index = len(index)
    dev = data[0].device
    for t in data + index:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    for t in data:
        if t.dtype != data[0].dtype:
            raise TypeError(f"{name}: mixed dtypes {data[0].dtype} and "
                            f"{t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor not 16-byte aligned")
    for t in index[:n_index]:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index tensors must be int32, got "
                            f"{t.dtype}")
    return dtype_code(data[0])


#: the head dims every kernel takes: multiples of HEAD_DIM_STEP from
#: HEAD_DIM_STEP to HEAD_DIM_MAX (each runs at :func:`padded_dim`)
HEAD_DIM_STEP = 8
HEAD_DIM_MAX = 256


def head_dim_ok(D):
    return HEAD_DIM_STEP <= D <= HEAD_DIM_MAX and D % HEAD_DIM_STEP == 0


def padded_dim(D):
    """The width head dim ``D`` runs at inside the kernels: 64, 128 or
    256, the next one up (``csrc/attention_common.cuh``: the columns past
    ``D`` are zeros, and only ``D`` are written)."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


def check_head_dim(name, D):
    """Raise unless the kernels take head dim ``D``: a multiple of 8 from
    8 to 256. The dims they refuse (not a multiple of 8, or past 256) are
    the rest of ROADMAP Queue C 7."""
    if not head_dim_ok(D):
        raise NotImplementedError(
            f"{name} kernel: head_dim {D} is not a multiple of "
            f"{HEAD_DIM_STEP} from {HEAD_DIM_STEP} to {HEAD_DIM_MAX} "
            f"(ROADMAP.md Queue C 7)")


def launch(name, *args, count_as=None):
    """Call kernel ``name``'s C entry with ``args`` (tensors become device
    pointers, None a null pointer) on the current stream, raise on a CUDA
    error, and count the launch (under ``count_as`` where one kernel has
    several entries)."""
    fn = _build.load(name)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    rc = fn(*conv, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(name, rc)
    count_launch(count_as or name)


def as_index(x, device):
    """An int32 tensor of ``x`` (numpy, list or tensor) on ``device``."""
    return torch.as_tensor(x, dtype=torch.int32).to(device).contiguous()
