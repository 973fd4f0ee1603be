"""In-place op variants — the counterpart of ``paddle_tpu/ops/inplace.py``:
the ``*_`` functions (``paddle.add_(x, y)``, ``paddle.scatter_(x, …)``,
``paddle.uniform_(x)`` …), each registered under its name. As in the
rest of the op surface nothing is patched onto ``torch.Tensor``: a
tensor's ``x.add_(y)`` is torch's own method.

The JAX package rebinds the receiver to the functional op's result
(``_rebind``: new value, new graph node). Here the functional op runs on
a copy of the receiver, when autograd records it (so what the op saves
for its backward is the copy), and its result is written into the
receiver: ``x.copy_(out)``, after ``as_strided_`` to the new shape for
the shape ops (``reshape_``, ``squeeze_``, ``transpose_`` …). A result of
another type (a comparison's bool, a division of integers) rebinds the
receiver's data where autograd holds no history for it. The values and
gradients are the JAX package's with two exceptions, both torch's
autograd refusing what the rebinding takes (ROADMAP.md Queue C):

- an in-place op on a leaf that requires grad raises torch's
  ``RuntimeError`` (the JAX package turns the leaf into a graph node);
- an in-place op on a tensor an earlier op saved for its backward makes
  that backward raise torch's ``RuntimeError`` (a version counter
  mismatch), where the JAX package keeps the saved value.

The random refills (``uniform_``, ``normal_``, ``exponential_``,
``bernoulli_``, ``cauchy_``, ``geometric_``, ``log_normal_``) and
``fill_``/``zero_`` write under ``no_grad`` and cut the receiver's
history, as ``_random_refill`` does; they draw from the key walk
(``core/random.py``) on the receiver's device, the JAX package's uniform
bits bit for bit.
"""
from __future__ import annotations

import functools
import math as _pymath
import sys

import torch

from ..core import random as random_mod
from ._op import OP_REGISTRY

__all__ = []


def _contiguous_strides(shape):
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= max(int(s), 1)
    return tuple(reversed(strides))


def _rebind(x, out):
    """Write ``out`` into ``x`` (the receiver keeps its identity)."""
    if out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
        out = out.clone()   # a view of x (t, reshape …): copied first
    if out.shape == x.shape and out.dtype == x.dtype:
        return x.copy_(out)
    if out.dtype == x.dtype and out.numel() == x.numel() \
            and x.is_contiguous():
        # a shape op: the receiver takes the new geometry, then the values
        x.as_strided_(tuple(out.shape), _contiguous_strides(out.shape),
                      x.storage_offset())
        return x.copy_(out)
    if x.requires_grad or out.requires_grad:
        raise RuntimeError(
            f"an in-place op that changes a tensor's type ({x.dtype} to "
            f"{out.dtype}) or the shape of a non-contiguous tensor cannot "
            "keep its autograd history")
    x.data = out
    return x


def _records(x, args, kwargs):
    """Whether autograd records the op (then it runs on a copy of x)."""
    if not torch.is_grad_enabled():
        return False
    vals = [x, *args, *kwargs.values()]
    return any(isinstance(v, torch.Tensor) and v.requires_grad
               for v in vals)


def _inplace_of(fn, name):
    @functools.wraps(fn)
    def inplace(x, *args, **kwargs):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} mutates a Tensor, got "
                            f"{type(x).__name__}")
        src = x.clone() if _records(x, args, kwargs) else x
        return _rebind(x, fn(src, *args, **kwargs))

    inplace.__name__ = inplace.__qualname__ = name
    inplace.__doc__ = (f"In-place ``{fn.__name__}``: writes the result "
                       f"into ``x`` and returns it.")
    return inplace


def _publish(name, fn):
    setattr(sys.modules[__name__], name, fn)
    __all__.append(name)
    OP_REGISTRY.setdefault(name, fn)


def _install():
    from . import creation, extra, manipulation, math, tail  # noqa: F401
    sources = {
        "add_": math.add, "subtract_": math.subtract,
        "multiply_": math.multiply, "divide_": math.divide,
        "remainder_": math.remainder, "mod_": math.mod,
        "floor_divide_": math.floor_divide, "pow_": math.pow,
        "clip_": math.clip, "scale_": math.scale, "exp_": math.exp,
        "sqrt_": math.sqrt, "rsqrt_": math.rsqrt,
        "reciprocal_": math.reciprocal, "round_": math.round,
        "floor_": math.floor, "ceil_": math.ceil, "abs_": math.abs,
        "neg_": math.neg, "trunc_": math.trunc, "frac_": math.frac,
        "erfinv_": math.erfinv, "lerp_": math.lerp, "logit_": math.logit,
        "tanh_": math.tanh, "sigmoid_": math.sigmoid,
        "nan_to_num_": math.nan_to_num,
        "squeeze_": manipulation.squeeze,
        "unsqueeze_": manipulation.unsqueeze,
        "reshape_": manipulation.reshape,
        "flatten_": manipulation.flatten,
        "transpose_": manipulation.transpose,
        "t_": manipulation.t,
        "scatter_": manipulation.scatter,
        "masked_fill_": manipulation.masked_fill,
        "index_add_": manipulation.index_add,
        "index_put_": manipulation.index_put,
        "index_fill_": extra.index_fill,
        "masked_scatter_": extra.masked_scatter,
        "put_along_axis_": manipulation.put_along_axis,
        "renorm_": extra.renorm,
    }
    for base in ("sin", "cos", "tan", "asin", "acos", "atan", "sinh",
                 "cosh", "asinh", "acosh", "atanh", "expm1", "log", "log2",
                 "log10", "log1p", "digamma", "lgamma", "i0", "gammaln",
                 "gammainc", "gammaincc", "hypot", "ldexp", "copysign",
                 "gcd", "lcm", "cumsum", "cumprod",
                 "logical_and", "logical_or", "logical_xor", "logical_not",
                 "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
                 "less_than", "less_equal", "greater_than", "greater_equal",
                 "not_equal", "equal"):
        sources[base + "_"] = OP_REGISTRY[base]
    sources["tril_"] = creation.tril
    sources["triu_"] = creation.triu
    sources["fill_diagonal_"] = tail.fill_diagonal
    sources["fill_diagonal_tensor_"] = tail.fill_diagonal_tensor
    for name, fn in sources.items():
        _publish(name, _inplace_of(fn, name))


_install()


def where_(condition, x, y, name=None):
    """In-place where: writes into ``x``, the SECOND argument (Paddle's
    ``Tensor.where_``)."""
    from .manipulation import where as _where
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"where_ mutates a Tensor, got {type(x).__name__}")
    src = x.clone() if _records(x, (condition, y), {}) else x
    return _rebind(x, _where(condition, src, y))


_publish("where_", where_)


# ------------------------------------------------------- the refills
def _random_refill(name, sample):
    def refill(x, *args, **kwargs):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} mutates a Tensor, got "
                            f"{type(x).__name__}")
        with torch.no_grad():
            out = sample(x, *args, **kwargs)
            x.copy_(out)
        if x.grad_fn is not None:
            # a refill's values depend on nothing: the history is cut
            trainable = x.requires_grad
            x.detach_()
            x.requires_grad_(trainable)
        return x

    refill.__name__ = refill.__qualname__ = name
    _publish(name, refill)
    return refill


def _uniform(x, shape, lo, hi):
    return random_mod.uniform_shaped(random_mod.next_key(), shape, lo, hi,
                                     x.device)


def _uniform_sample(x, min=-1.0, max=1.0, seed=0, name=None):
    return _uniform(x, x.shape, min, max)


def _normal_sample(x, mean=0.0, std=1.0, name=None):
    return random_mod.normal(random_mod.next_key(), x.shape, x.device) \
        * std + mean


def _exponential_sample(x, lam=1.0, name=None):
    return -torch.log(_uniform(x, x.shape, 1e-7, 1.0)) / lam


def _bernoulli_sample(x, p=0.5, name=None):
    return (_uniform(x, x.shape, 0.0, 1.0) < p).to(x.dtype)


def _cauchy_sample(x, loc=0, scale=1, name=None):
    u = _uniform(x, x.shape, 1e-7, 1.0 - 1e-7)
    return loc + scale * torch.tan(_pymath.pi * (u - 0.5))


def _geometric_sample(x, probs, name=None):
    # the number of Bernoulli(p) trials to the first success (from 1)
    u = _uniform(x, x.shape, 1e-7, 1.0)
    p = torch.as_tensor(probs, dtype=u.dtype, device=x.device)
    return torch.ceil(torch.log(u) / torch.log1p(-p))


def _log_normal_sample(x, mean=1.0, std=2.0, name=None):
    z = random_mod.normal(random_mod.next_key(), x.shape, x.device)
    return torch.exp(mean + std * z)


def _fill_value(x, value, name=None):
    return torch.full_like(x, value)


def _zero_value(x, name=None):
    return torch.zeros_like(x)


uniform_ = _random_refill("uniform_", _uniform_sample)
normal_ = _random_refill("normal_", _normal_sample)
exponential_ = _random_refill("exponential_", _exponential_sample)
bernoulli_ = _random_refill("bernoulli_", _bernoulli_sample)
cauchy_ = _random_refill("cauchy_", _cauchy_sample)
geometric_ = _random_refill("geometric_", _geometric_sample)
log_normal_ = _random_refill("log_normal_", _log_normal_sample)
fill_ = _random_refill("fill_", _fill_value)
zero_ = _random_refill("zero_", _zero_value)
