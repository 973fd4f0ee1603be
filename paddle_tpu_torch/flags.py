"""Runtime flags of the port, Paddle-style (``FLAGS_*`` names, read from
the environment at import — "1"/"true"/"yes" is on — and changed with
:func:`set_flags`): the counterpart of ``paddle_tpu/utils/flags.py`` for
the flags the port reads:

- ``FLAGS_use_cuda_kernels`` (default on): the one switch between the
  hand-written CUDA kernels and their plain PyTorch versions, read at
  every call that reaches a kernel (the model's flash attention and its
  backward, the serving prefill, paged decode and ragged attention). On,
  the kernel wrappers run (the kernels on CUDA tensors); off, the plain
  versions run on any device. The counterpart of
  ``FLAGS_use_pallas_kernels``, and the A/B lever of the on-card parity
  checks; ``chip_smoke.py`` fails when its main paths launch no kernel,
  so an environment that turns it off cannot pass there unseen.
- ``FLAGS_check_nan_inf`` (default off): ``jit.TrainStep`` counts the
  non-finite values of the loss and the gradients of every step and
  raises when there are any.
"""
from __future__ import annotations

import os


def _env_bool(name, default):
    env = os.environ.get(name)
    return default if env is None else env.lower() in ("1", "true", "yes")


_REGISTRY = {name: _env_bool(name, default) for name, default in (
    ("FLAGS_use_cuda_kernels", True), ("FLAGS_check_nan_inf", False))}


def _full(name):
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


def get_flag(name):
    return _REGISTRY[_full(name)]


def set_flags(flags):
    for name, value in flags.items():
        name = _full(name)
        if name not in _REGISTRY:
            raise KeyError(f"unknown flag {name}")
        _REGISTRY[name] = value
