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


def check_cuda(name, data, index=()):
    """Validate what a kernel reads: ``data`` tensors on one CUDA device,
    one float dtype, contiguous and 16-byte aligned (the kernels load 16
    bytes at a time); ``index`` tensors int32 and contiguous. Raises on
    anything the kernel does not take."""
    dev = data[0].device
    for t in tuple(data) + tuple(index):
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
    for t in index:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index tensors must be int32, got "
                            f"{t.dtype}")
    return dtype_code(data[0])


def check_head_dim(name, D, dims):
    """Raise unless head dim ``D`` is one of the kernel's ``dims``."""
    if D not in dims:
        raise NotImplementedError(f"{name} kernel: head_dim {D} not in "
                                  f"{tuple(dims)}")


def launch(name, *args):
    """Call kernel ``name``'s C entry with ``args`` (tensors become device
    pointers, None a null pointer) on the current stream, raise on a CUDA
    error, and count the launch."""
    fn = _build.load(name)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    rc = fn(*conv, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(name, rc)
    count_launch(name)


def as_index(x, device):
    """An int32 tensor of ``x`` (numpy, list or tensor) on ``device``."""
    return torch.as_tensor(x, dtype=torch.int32).to(device).contiguous()
