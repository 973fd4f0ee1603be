"""Math, reduction, search and comparison ops — the counterpart of
``paddle_tpu/ops/math.py``: Paddle's signatures (``axis``, ``keepdim``,
``transpose_x/y`` …) over torch bodies, registered under the JAX
package's op names. Index outputs are int64 (the JAX package's are
int32: it runs with 64-bit types off); the values are the same.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ._op import op


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """``axis`` as torch's ``dim`` (None: every dimension)."""
    a = _axis(axis)
    return tuple(range(x.dim())) if a is None else a


def _keep_all(out, x, keepdim):
    """A full reduction's result reshaped to ``(1,) * x.dim()`` under
    ``keepdim`` (jnp's ``keepdims`` over axis None)."""
    return out.reshape((1,) * x.dim()) if keepdim else out


def _float_of(x):
    return x if x.is_floating_point() or x.is_complex() \
        else x.to(dtype_mod.get_default_dtype())


# ----------------------------------------------------------------- elementwise
@op
def add(x, y):
    return torch.add(x, y)


@op
def subtract(x, y):
    return torch.subtract(x, y)


@op
def multiply(x, y):
    return torch.multiply(x, y)


@op
def divide(x, y):
    return torch.true_divide(x, y)


@op
def floor_divide(x, y):
    return torch.floor_divide(x, y)


@op
def remainder(x, y):
    return torch.remainder(x, y)


mod = remainder
floor_mod = remainder


@op
def pow(x, y):
    return torch.pow(x, y)


@op
def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@op
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


@op
def maximum(x, y):
    return torch.maximum(x, y)


@op
def minimum(x, y):
    return torch.minimum(x, y)


@op
def fmax(x, y):
    return torch.fmax(x, y)


@op
def fmin(x, y):
    return torch.fmin(x, y)


def _unary(name, fn):
    @op(name=name)
    def f(x):
        return fn(x)
    f.__name__ = name
    f.__qualname__ = name
    return f


sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
abs = _unary("abs", torch.abs)
neg = _unary("neg", torch.neg)
sign = _unary("sign", torch.sign)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)
trunc = _unary("trunc", torch.trunc)
square = _unary("square", torch.square)
reciprocal = _unary("reciprocal", torch.reciprocal)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
lgamma = _unary("lgamma", torch.lgamma)
digamma = _unary("digamma", torch.digamma)
sigmoid = _unary("sigmoid", torch.sigmoid)
frac = _unary("frac", lambda x: x - torch.trunc(x))


@op
def atan2(x, y):
    return torch.atan2(x, y)


@op
def clip(x, min=None, max=None):
    if min is None and max is None:
        return x
    return torch.clamp(x, min, max)


@op
def lerp(x, y, weight):
    return x + weight * (y - x)


@op
def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.matmul(x, y)


@op
def baddbmm(input, x, y, beta=1.0, alpha=1.0):
    """Batched addmm: ``beta * input + alpha * (x @ y)``."""
    return beta * input + alpha * torch.matmul(x, y)


@op
def reduce_as(x, target, name=None):
    """Sum-reduce ``x`` to ``target``'s shape (the broadcast adjoint)."""
    tshape = tuple(target.shape)
    lead = x.dim() - len(tshape)
    axes = tuple(range(lead)) + tuple(
        lead + i for i, t in enumerate(tshape)
        if t == 1 and x.shape[lead + i] != 1)
    out = torch.sum(x, dim=axes) if axes else x
    return out.reshape(tshape)


@op
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@op
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@op
def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@op
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


# ----------------------------------------------------------------- reductions
@op
def sum(x, axis=None, dtype=None, keepdim=False):
    d = dtype_mod.to_torch_dtype(dtype)
    if d is None and x.dtype == torch.bool:
        d = dtype_mod.long_dtype()
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdim, dtype=d)


@op
def mean(x, axis=None, keepdim=False):
    return torch.mean(_float_of(x), dim=_dims(x, axis), keepdim=keepdim)


@op
def prod(x, axis=None, keepdim=False, dtype=None):
    d = dtype_mod.to_torch_dtype(dtype)
    a = _axis(axis)
    if a is None:
        return _keep_all(torch.prod(x, dtype=d), x, keepdim)
    out = x if d is None else x.to(d)
    for ax in sorted([a] if isinstance(a, int) else list(a),
                     key=lambda v: v % x.dim(), reverse=True):
        out = torch.prod(out, dim=ax, keepdim=keepdim)
    return out


@op
def max(x, axis=None, keepdim=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


@op
def min(x, axis=None, keepdim=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


@op
def amax(x, axis=None, keepdim=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


@op
def amin(x, axis=None, keepdim=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


@op
def std(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@op
def var(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@op
def median(x, axis=None, keepdim=False):
    """The middle value, or the mean of the two middle values for an even
    count (numpy's median)."""
    a = _axis(axis)
    xf = _float_of(x)
    if a is None:
        out = median.raw_fn(xf.reshape(-1), 0)
        return _keep_all(out, x, keepdim)
    s = torch.sort(xf, dim=a).values
    n = x.shape[a]
    hi = s.narrow(a, n // 2, 1)
    out = hi if n % 2 else (s.narrow(a, n // 2 - 1, 1) + hi) / 2
    return out if keepdim else out.squeeze(a)


@op
def logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdim)


@op
def cumsum(x, axis=None, dtype=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=int(axis),
                        dtype=dtype_mod.to_torch_dtype(dtype))


@op
def cumprod(x, dim=None, dtype=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim=int(dim),
                         dtype=dtype_mod.to_torch_dtype(dtype))


@op
def count_nonzero(x, axis=None, keepdim=False):
    out = torch.sum(x != 0, dim=_dims(x, axis), keepdim=keepdim)
    return out.to(dtype_mod.long_dtype())


# ----------------------------------------------------------------- search/sort
def _arg(fn, x, axis, keepdim, dtype):
    if axis is None:
        out = fn(x.reshape(-1))
        if keepdim:
            out = out.reshape((1,) * x.dim())
    else:
        out = fn(x, dim=int(axis), keepdim=keepdim)
    return out.to(dtype_mod.to_torch_dtype(dtype))


@op
def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


@op
def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


@op
def argsort(x, axis=-1, descending=False, stable=True):
    return torch.argsort(x, dim=axis, descending=descending, stable=True)


@op
def sort(x, axis=-1, descending=False, stable=True):
    return torch.sort(x, dim=axis, descending=descending, stable=True).values


@op
def topk(x, k, axis=-1, largest=True, sorted=True):
    k = int(k.item() if isinstance(k, torch.Tensor) else k)
    out = torch.topk(x, k, dim=-1 if axis is None else int(axis),
                     largest=largest, sorted=True)
    return out.values, out.indices


@op
def kthvalue(x, k, axis=-1, keepdim=False):
    idx = torch.argsort(x, dim=axis, stable=True)
    take_i = idx.narrow(axis, k - 1, 1)
    take = torch.take_along_dim(x, take_i, dim=axis)
    if not keepdim:
        take, take_i = take.squeeze(axis), take_i.squeeze(axis)
    return take, take_i


@op
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    if sorted_sequence.dim() > 1:
        out = torch.searchsorted(
            sorted_sequence.reshape(-1, sorted_sequence.shape[-1]),
            values.reshape(-1, values.shape[-1]), right=right)
        out = out.reshape(values.shape)
    else:
        out = torch.searchsorted(sorted_sequence, values, right=right)
    return out.to(torch.int32 if out_int32 else dtype_mod.long_dtype())


@op
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    # a data-dependent shape: computed on the host, like the reference
    res = np.unique(x.detach().cpu().numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if isinstance(res, tuple):
        return tuple(torch.as_tensor(r, device=x.device) for r in res)
    return torch.as_tensor(res, device=x.device)


@op
def nonzero(x, as_tuple=False):
    idx = torch.nonzero(x)
    if as_tuple:
        return tuple(idx[:, i:i + 1] for i in range(idx.shape[1]))
    return idx


@op
def bincount(x, weights=None, minlength=0):
    return torch.bincount(x, weights=weights, minlength=minlength)


# ----------------------------------------------------------------- comparison
def _cmp(name, fn):
    @op(name=name)
    def f(x, y):
        return fn(x, y)
    f.__name__ = name
    f.__qualname__ = name
    return f


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)


@op
def equal_all(x, y):
    return torch.tensor(x.shape == y.shape and bool(torch.equal(x, y)),
                        device=x.device)


@op
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.tensor(torch.allclose(x, y, rtol=rtol, atol=atol,
                                       equal_nan=equal_nan), device=x.device)


@op
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


isnan = _unary("isnan", torch.isnan)
isinf = _unary("isinf", torch.isinf)
isfinite = _unary("isfinite", torch.isfinite)

logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)


@op
def logical_not(x):
    return torch.logical_not(x)


bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)


@op
def bitwise_not(x):
    return torch.bitwise_not(x)


def _bool_reduce(fn, x, axis, keepdim):
    a = _axis(axis)
    if a is None:
        return _keep_all(fn(x), x, keepdim)
    return fn(x, dim=a, keepdim=keepdim)


@op
def all(x, axis=None, keepdim=False):
    return _bool_reduce(torch.all, x, axis, keepdim)


@op
def any(x, axis=None, keepdim=False):
    return _bool_reduce(torch.any, x, axis, keepdim)


# ----------------------------------------------------------------- linalg-lite
@op
def dot(x, y):
    return torch.sum(x * y, dim=-1)


@op
def bmm(x, y):
    return torch.matmul(x, y)


@op
def mm(x, y):
    return torch.matmul(x, y)


@op
def outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@op
def inner(x, y):
    return torch.inner(x, y)


@op
def kron(x, y):
    return torch.kron(x, y)


@op
def cross(x, y, axis=9):
    ax = axis if axis != 9 else next(
        i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=ax)


@op
def diff(x, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


__all__ = [n for n in dir() if not n.startswith("_")
           and n not in ("annotations", "np", "torch", "dtype_mod", "op")]
