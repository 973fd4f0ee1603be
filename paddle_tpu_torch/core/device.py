"""Devices — the counterpart of ``paddle_tpu/core/device.py``.

``set_device("gpu" | "gpu:N" | "cpu")`` picks the device on which the
creation functions, ``to_tensor`` and ``Layer.create_parameter`` place
new tensors; ``get_device()`` returns it as a :class:`Place`. The default
is ``"gpu:0"``. There is no fallback: with no CUDA device, creating a
tensor on the default device raises (call ``set_device("cpu")`` to work
on the CPU). Importing this module touches no CUDA.
"""
from __future__ import annotations

import torch

_CURRENT = {"device": "gpu:0"}


class Place:
    """A device: ``Place("gpu:0")``; ``.torch_device`` is the torch device
    it names (``cuda:0``)."""

    def __init__(self, device):
        self._name = _normalize(device)

    @property
    def torch_device(self):
        name, idx = self._name.split(":") if ":" in self._name \
            else (self._name, "0")
        return torch.device("cpu") if name == "cpu" \
            else torch.device("cuda", int(idx))

    def is_gpu_place(self):
        return self._name.startswith("gpu")

    def is_cpu_place(self):
        return self._name == "cpu"

    def __repr__(self):
        return f"Place({self._name})"

    def __str__(self):
        return self._name

    def __eq__(self, other):
        return isinstance(other, Place) and self._name == other._name

    def __hash__(self):
        return hash(self._name)


def _normalize(device):
    if isinstance(device, Place):
        return device._name
    if isinstance(device, torch.device):
        return "cpu" if device.type == "cpu" \
            else f"gpu:{device.index or 0}"
    name = str(device).lower()
    idx = "0"
    if ":" in name:
        name, idx = name.split(":")
    if name in ("gpu", "cuda"):
        return f"gpu:{int(idx)}"
    if name == "cpu":
        return "cpu"
    raise ValueError(f"unknown device {device!r} (gpu, gpu:N or cpu)")


def set_device(device):
    """Select the default device of new tensors; returns its Place."""
    _CURRENT["device"] = _normalize(device)
    return Place(_CURRENT["device"])


def get_device():
    return Place(_CURRENT["device"])


def current_torch_device():
    """The torch device of new tensors. Raises when it is a GPU and this
    process has no CUDA device: the port never falls back to the CPU."""
    dev = get_device().torch_device
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the default device is {get_device()} but there is no CUDA "
            f"device; call paddle_tpu_torch.set_device('cpu') to work on "
            f"the CPU")
    return dev


def resolve(place=None):
    """``place`` (a Place, a name, a torch device or None: the default
    device) as a torch device, checked as :func:`current_torch_device`
    checks it."""
    if place is None:
        return current_torch_device()
    dev = Place(place).torch_device
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {place}")
    return dev


def get_all_devices():
    return [f"gpu:{i}" for i in range(device_count())] + ["cpu"]


def device_count():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def local_device_count():
    return device_count()


def is_compiled_with_cuda():
    """True when this torch build has CUDA (``torch.version.cuda``)."""
    return torch.version.cuda is not None


def is_compiled_with_xpu():
    return False


def is_compiled_with_tpu():
    return False


def synchronize():
    """Wait for the current device's work (``paddle.device.synchronize``)."""
    if get_device().is_gpu_place() and torch.cuda.is_available():
        torch.cuda.synchronize()
