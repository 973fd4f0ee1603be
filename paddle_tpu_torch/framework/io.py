"""``paddle.save`` / ``paddle.load`` — the counterpart of
``paddle_tpu/framework/io.py``: a nested object (a state dict of a model,
an optimizer with its scheduler, a scaler, an RNG key …) written with
every tensor as a plain CPU tensor (a ``Parameter`` saves its values),
read back with the tensors on the CPU, or as numpy arrays under
``return_numpy`` (bfloat16 as float32: numpy has no bfloat16). Loading a
tensor into a model or an optimizer copies it to their device."""
from __future__ import annotations

import os

import torch


def _to_cpu_tree(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        t = t.clone() if t.device.type == "cpu" else t.to("cpu")
        return t.as_subclass(torch.Tensor)
    if isinstance(obj, dict):
        return {k: _to_cpu_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu_tree(v) for v in obj)
    return obj


def _to_numpy_tree(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.float() if obj.dtype == torch.bfloat16 else obj
        return t.numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy_tree(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **kwargs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    torch.save(_to_cpu_tree(obj), path, pickle_protocol=protocol)


def load(path, return_numpy=False, **kwargs):
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return _to_numpy_tree(obj) if return_numpy else obj


__all__ = ["save", "load"]
