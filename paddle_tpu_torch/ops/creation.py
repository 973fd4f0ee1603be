"""Tensor creation ops — the counterpart of ``paddle_tpu/ops/creation.py``.

New tensors go on the current device (``core/device.py``); the ``*_like``
ops follow their input. The random ops draw from the port's threefry key
walk (``core/random.py``): one ``next_key()`` a call, as the JAX package
draws one, and the hash runs on the tensor's device. ``rand``,
``uniform``, ``bernoulli``, ``randint`` and ``randperm`` are the JAX
package's bits; ``randn``/``normal`` its uniforms through ``torch.erfinv``
(last-place differences); ``multinomial`` its Gumbel draws.
``standard_gamma`` and ``binomial`` run torch's samplers on a generator
seeded from the key: the same distribution, not the same draws (the
reference's rejection loops are not reproduced).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import device as device_mod
from ..core import dtype as dtype_mod
from ..core import random as random_mod
from ._op import op


def _dt(dtype, default=None):
    d = dtype_mod.to_torch_dtype(dtype)
    if d is None:
        d = default if default is not None else dtype_mod.get_default_dtype()
    return d


def _dev():
    return device_mod.current_torch_device()


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def _key():
    """A fresh key on the host (the draws hash on their device)."""
    return random_mod.next_key()


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    from ..core.tensor import to_tensor as _tt
    return _tt(data, dtype=dtype, place=place, stop_gradient=stop_gradient)


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=_dev())


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=_dev())


def _fill_dtype(v):
    if isinstance(v, torch.Tensor):
        return v.dtype
    if isinstance(v, bool):
        return torch.bool
    if isinstance(v, (int, np.integer)):
        return torch.int64
    return dtype_mod.get_default_dtype()


def full(shape, fill_value, dtype=None, name=None):
    return torch.full(_shape(shape), _scalar(fill_value),
                      dtype=_dt(dtype, _fill_dtype(fill_value)),
                      device=_dev())


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


@op
def _zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=dtype_mod.to_torch_dtype(dtype))


@op
def _ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=dtype_mod.to_torch_dtype(dtype))


@op
def _full_like(x, fill_value, dtype=None):
    return torch.full_like(x, _scalar(fill_value),
                           dtype=dtype_mod.to_torch_dtype(dtype))


def zeros_like(x, dtype=None, name=None):
    return _zeros_like(x, dtype=dtype)


def ones_like(x, dtype=None, name=None):
    return _ones_like(x, dtype=dtype)


def full_like(x, fill_value, dtype=None, name=None):
    return _full_like(x, fill_value, dtype=dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        ints = all(isinstance(v, (int, np.integer)) for v in
                   (start, end, step))
        dtype = torch.int64 if ints else dtype_mod.get_default_dtype()
    return torch.arange(start, end, step, dtype=_dt(dtype), device=_dev())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=_dt(dtype), device=_dev())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          base=base, dtype=_dt(dtype), device=_dev())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=_dt(dtype), device=_dev())


def diag(x, offset=0, padding_value=0, name=None):
    base = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        base = torch.where(mask, base, torch.full_like(base, padding_value))
    return base


def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


@op
def _tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@op
def _triu(x, diagonal=0):
    return torch.triu(x, diagonal)


def tril(x, diagonal=0, name=None):
    return _tril(x, diagonal=diagonal)


def triu(x, diagonal=0, name=None):
    return _triu(x, diagonal=diagonal)


def meshgrid(*args, **kwargs):
    arrays = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return list(torch.meshgrid(*arrays, indexing="ij"))


@op
def _assign(x):
    return x.clone()


def assign(x, output=None):
    result = _assign(x if isinstance(x, torch.Tensor) else to_tensor(x))
    if output is not None:
        with torch.no_grad():
            output.copy_(result)
        return output
    return result


def clone(x, name=None):
    return _assign(x)


# ----------------------------------------------------------------- random ops
def rand(shape, dtype=None, name=None):
    dev = _dev()
    return random_mod.uniform_shaped(_key(), _shape(shape), device=dev) \
        .to(_dt(dtype))


def randn(shape, dtype=None, name=None):
    dev = _dev()
    return random_mod.normal(_key(), _shape(shape), dev).to(_dt(dtype))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    dev = _dev()
    out = random_mod.normal(_key(), _shape([] if shape is None else shape),
                            dev)
    return (out * std + mean).to(dtype_mod.get_default_dtype())


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = _dev()
    key = random_mod.PRNGKey(seed) if seed else _key()
    return random_mod.uniform_shaped(key, _shape(shape), min, max, dev) \
        .to(_dt(dtype))


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = _dev()
    out = random_mod.randint(_key().to(dev), _shape(shape), low, high)
    return out.to(dtype_mod.to_torch_dtype(dtype) or dtype_mod.long_dtype())


def randperm(n, dtype=None, name=None):
    out = random_mod.permutation(_key().to(_dev()), int(n))
    return out.to(dtype_mod.to_torch_dtype(dtype) or dtype_mod.long_dtype())


def multinomial(x, num_samples=1, replacement=False, name=None):
    logits = torch.log(torch.clamp(x, min=1e-30))
    key = _key()
    tiny = float(np.finfo(np.float32).tiny)
    if replacement:
        # jax.random.categorical(key, logits, shape=x.shape[:-1] +
        # (num_samples,)): Gumbel noise over the samples, then argmax
        batch = tuple(logits.shape[:-1])
        shape = batch + (num_samples,)
        prefix = shape[:len(shape) - len(batch)]
        u = random_mod.uniform_shaped(key, prefix + batch
                                      + (logits.shape[-1],), tiny, 1.0,
                                      x.device)
        g = -torch.log(-torch.log(u))
        out = torch.argmax(g + logits, dim=-1)
    else:
        u = random_mod.uniform_shaped(key, tuple(x.shape), tiny, 1.0,
                                      x.device)
        g = -torch.log(-torch.log(u))
        out = torch.flip(torch.argsort(logits + g, dim=-1, stable=True),
                         dims=(-1,))[..., :num_samples]
    return out.to(dtype_mod.long_dtype())


def bernoulli(x, name=None):
    u = random_mod.uniform_shaped(_key(), tuple(x.shape), device=x.device)
    return (u < x).to(x.dtype)


def _generator(dev):
    key = random_mod.next_key()
    g = torch.Generator(device=dev)
    g.manual_seed(int(key[0]) << 32 | int(key[1]))
    return g


def standard_gamma(x, name=None):
    """Gamma(alpha=x, scale=1) samples, one per element."""
    return torch._standard_gamma(x.float(), generator=_generator(x.device)) \
        .to(x.dtype)


def binomial(count, prob, name=None):
    """Binomial(n, p) samples with elementwise-broadcast n and p (int64)."""
    n, p = torch.broadcast_tensors(torch.as_tensor(count).float(),
                                   torch.as_tensor(prob).float())
    return torch.binomial(n, p, generator=_generator(n.device)) \
        .to(dtype_mod.long_dtype())


def _register_creation_ops():
    from ._op import OP_REGISTRY
    for name in ("to_tensor", "zeros", "ones", "full", "empty",
                 "zeros_like", "ones_like", "full_like", "empty_like",
                 "arange", "linspace", "logspace", "eye", "diag",
                 "diagflat", "tril", "triu", "meshgrid", "assign", "clone",
                 "rand", "randn", "standard_normal", "normal", "uniform",
                 "randint", "randperm", "multinomial", "bernoulli",
                 "standard_gamma", "binomial"):
        OP_REGISTRY.setdefault(name, globals()[name])


_register_creation_ops()

__all__ = ["to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
           "ones_like", "full_like", "empty_like", "arange", "linspace",
           "logspace", "eye", "diag", "diagflat", "tril", "triu", "meshgrid",
           "assign", "clone", "rand", "randn", "standard_normal", "normal",
           "uniform", "randint", "randperm", "multinomial", "bernoulli",
           "standard_gamma", "binomial"]
