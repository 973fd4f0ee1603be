"""``to_tensor`` and ``Parameter`` — the counterpart of
``paddle_tpu/core/tensor.py``.

The port's Tensor IS ``torch.Tensor`` (``paddle_tpu_torch.Tensor``): no
wrapper class, no patched methods. Paddle's ``stop_gradient`` is
``not requires_grad``; the Paddle-only tensor methods (``cast``,
``astype`` …) are functions of the op surface (``paddle_tpu_torch.ops``).

:class:`Parameter` subclasses ``torch.nn.Parameter`` (so ``nn.Module``
registers it) and carries Paddle's parameter attributes: ``name``,
``trainable`` / ``stop_gradient``, ``optimize_attr`` (the per-parameter
learning-rate scale) and ``regularizer`` (``nn/layer.py:105-117`` of the
JAX package sets them from a ``ParamAttr``).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from . import device as device_mod
from . import dtype as dtype_mod

Tensor = torch.Tensor


def _rebuild_parameter(data, requires_grad, state):
    p = Parameter(data, trainable=requires_grad)
    p.__dict__.update(state)
    return p


class Parameter(torch.nn.Parameter):
    """A trainable tensor (``create_parameter``'s result)."""

    def __new__(cls, data=None, trainable=True, name=None):
        p = super().__new__(cls, data, requires_grad=bool(trainable))
        p.name = name
        p.persistable = True
        return p

    # torch.Tensor has a read-only ``name``; a Parameter has Paddle's
    @property
    def name(self):
        return self.__dict__.get("_param_name")

    @name.setter
    def name(self, value):
        self.__dict__["_param_name"] = value

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        new = Parameter(self.data.clone(memory_format=torch.preserve_format),
                        trainable=self.requires_grad)
        new.__dict__.update(copy.deepcopy(self.__dict__, memo))
        memo[id(self)] = new
        return new

    def __reduce_ex__(self, proto):
        return (_rebuild_parameter,
                (self.data, self.requires_grad, dict(self.__dict__)))

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def from_numpy(arr):
    """A CPU tensor of numpy ``arr`` (bfloat16 arrays, which numpy has
    only through ``ml_dtypes``, by their bits); a 0-d array stays 0-d."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _default_cast(arr):
    """numpy data as ``paddle.to_tensor`` types it: float64 becomes the
    default float dtype (a Python float list is float32), the rest keeps
    its type."""
    if arr.dtype == np.float64:
        return torch.from_numpy(arr).to(dtype_mod.get_default_dtype())
    return from_numpy(arr)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: a new tensor on ``place`` (default: the
    current device, :func:`core.device.get_device`) holding ``data``;
    ``stop_gradient=False`` makes it require gradients."""
    dev = device_mod.resolve(place)
    dt = dtype_mod.to_torch_dtype(dtype)
    if isinstance(data, torch.Tensor):
        out = data.detach().to(device=dev, dtype=dt or data.dtype,
                               copy=True)
    else:
        if hasattr(data, "__array__") and not isinstance(data, np.ndarray):
            data = np.asarray(data)
        arr = np.asarray(data)
        out = _default_cast(arr) if dt is None \
            else from_numpy(arr).to(dt)
        # a new tensor: never a view of the caller's numpy buffer
        out = out.to(dev, copy=True)
    if not stop_gradient:
        out.requires_grad_(True)
    return out


__all__ = ["Tensor", "Parameter", "to_tensor"]
