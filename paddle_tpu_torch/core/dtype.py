"""Dtypes — the counterpart of ``paddle_tpu/core/dtype.py``: Paddle's
dtype names (``paddle.float32``, ``"bf16"``, ``"half"`` …) mapped onto
torch dtypes, the default float dtype, and type promotion.

One departure: the JAX package runs with 64-bit types off, so its
``int64``/``float64`` requests become 32-bit types; torch keeps them, so
here ``"int64"`` is ``torch.int64`` (Paddle's own index type).
"""
from __future__ import annotations

import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR_ALIASES = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "fp16": float16,
    "half": float16, "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "complex64": complex64, "complex128": complex128,
}

_DEFAULT_DTYPE = [torch.float32]


def to_torch_dtype(dtype):
    """A dtype name, a numpy dtype or a torch dtype as a torch dtype
    (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key not in _STR_ALIASES:
            raise ValueError(f"Unknown dtype alias: {dtype!r}")
        return _STR_ALIASES[key]
    import numpy as np
    name = np.dtype(dtype).name
    if name not in _STR_ALIASES:
        raise ValueError(f"Unknown dtype: {dtype!r}")
    return _STR_ALIASES[name]


def long_dtype():
    """The index dtype (``int64``)."""
    return int64


def dtype_name(dtype) -> str:
    """Paddle's string name of a dtype (``"float32"``, ``"bool"`` …)."""
    return str(to_torch_dtype(dtype)).split(".")[-1]


def get_default_dtype():
    return _DEFAULT_DTYPE[0]


def set_default_dtype(dtype):
    d = to_torch_dtype(dtype)
    if not d.is_floating_point:
        raise TypeError("default dtype must be floating point")
    _DEFAULT_DTYPE[0] = d


def is_floating_point(dtype) -> bool:
    return to_torch_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = to_torch_dtype(dtype)
    return not d.is_floating_point and not d.is_complex


def promote_types(a, b):
    return torch.promote_types(to_torch_dtype(a), to_torch_dtype(b))


def finfo(dtype):
    """Float type info (``paddle.finfo``)."""
    return torch.finfo(to_torch_dtype(dtype))


def iinfo(dtype):
    """Integer type info (``paddle.iinfo``)."""
    return torch.iinfo(to_torch_dtype(dtype))


__all__ = [
    "bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
    "bfloat16", "float32", "float64", "complex64", "complex128",
    "to_torch_dtype", "dtype_name", "get_default_dtype", "set_default_dtype",
    "is_floating_point", "is_integer", "promote_types", "finfo", "iinfo",
]
