"""Weight initializers — the counterpart of ``paddle_tpu/nn/initializer.py``.

An initializer is a callable ``(shape, dtype, device=None) -> tensor``
(default device: the current one). Each random initializer draws ONE key
(``core.random.next_key``), as the JAX package's do, and hashes on the
target device: with the same seed and the same order of draws,
``Uniform``, ``XavierUniform`` and ``KaimingUniform`` weights are the JAX
package's bit for bit; the normal-based ones go through ``torch.erfinv``
(last-place differences).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import device as device_mod
from ..core import dtype as dtype_mod
from ..core import random as random_mod


def _dev(device):
    return device_mod.resolve(device)


def _key():
    return random_mod.next_key()


class Initializer:
    def __call__(self, shape, dtype, device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device=None):
        return torch.full(tuple(shape), self.value,
                          dtype=dtype_mod.to_torch_dtype(dtype),
                          device=_dev(device))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device=None):
        dev = _dev(device)
        out = random_mod.normal(_key(), tuple(shape), dev) * self.std \
            + self.mean
        return out.to(dtype_mod.to_torch_dtype(dtype))


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype, device=None):
        dev = _dev(device)
        out = random_mod.truncated_normal(_key(), self.a, self.b,
                                          tuple(shape), dev)
        return (out * self.std + self.mean).to(
            dtype_mod.to_torch_dtype(dtype))


def _uniform(shape, dtype, device, lo, hi):
    dev = _dev(device)
    return random_mod.uniform_shaped(_key(), tuple(shape), lo, hi, dev).to(
        dtype_mod.to_torch_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device=None):
        return _uniform(shape, dtype, device, self.low, self.high)


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # Paddle's linear weights are [in, out]
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    # conv weights are [out_c, in_c/groups, kh, kw]
    return shape[1] * receptive, shape[0] * receptive


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, dtype, device, -limit, limit)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (random_mod.normal(_key(), tuple(shape), _dev(device))
                * std).to(dtype_mod.to_torch_dtype(dtype))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device=None):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = _gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, device, -limit, limit)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device=None):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        std = _gain(self.nonlinearity, self.negative_slope) / math.sqrt(fi)
        return (random_mod.normal(_key(), tuple(shape), _dev(device))
                * std).to(dtype_mod.to_torch_dtype(dtype))


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype, device=None):
        from ..core.tensor import to_tensor
        v = self.value if isinstance(self.value, torch.Tensor) \
            else to_tensor(np.asarray(self.value), place=_dev(device))
        if tuple(v.shape) != tuple(shape):
            v = v.reshape(tuple(shape))
        return v.detach().to(device=_dev(device),
                             dtype=dtype_mod.to_torch_dtype(dtype))


class Orthogonal(Initializer):
    """``jax.nn.initializers.orthogonal``: Q of the QR of a normal draw
    (rows or columns, whichever are fewer), signs fixed by R's
    diagonal."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype, device=None):
        shape = tuple(shape)
        n_rows = int(np.prod(shape)) // shape[-1]
        n_cols = shape[-1]
        mshape = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
        a = random_mod.normal(_key(), mshape, _dev(device))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return (self.gain * q.reshape(shape)).to(
            dtype_mod.to_torch_dtype(dtype))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype, device=None):
        out = np.zeros(tuple(shape), np.float32)
        oc, ic = shape[0], shape[1]
        mid = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + mid] = 1.0
        return torch.from_numpy(out).to(device=_dev(device),
                                        dtype=dtype_mod.to_torch_dtype(dtype))


def _gain(nonlinearity, negative_slope=0.0):
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


def calculate_gain(nonlinearity, param=None):
    return _gain(nonlinearity, param or 0.0)


constant = Constant
normal = Normal
uniform = Uniform


class Bilinear(Initializer):
    """The bilinear-upsampling kernel for transposed convolutions: every
    (out, in) slice gets the same 2-D interpolation filter."""

    def __call__(self, shape, dtype, device=None):
        if len(shape) != 4:
            raise ValueError(
                f"Bilinear initializer expects a 4-D conv weight, got "
                f"shape {shape}")
        kh, kw = int(shape[2]), int(shape[3])

        def filt_1d(k):
            f = (k + 1) // 2
            c = (2 * f - 1 - f % 2) / (2.0 * f)
            return 1.0 - np.abs(np.arange(k) / f - c)

        filt = np.outer(filt_1d(kh), filt_1d(kw)).astype(np.float32)
        out = np.tile(filt, (int(shape[0]), int(shape[1]), 1, 1))
        return torch.from_numpy(out).to(device=_dev(device),
                                        dtype=dtype_mod.to_torch_dtype(dtype))


# the framework-wide defaults Layer.create_parameter consults when no
# initializer is given (set_global_initializer)
_global_init = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    _global_init["weight"] = weight_init
    _global_init["bias"] = bias_init
