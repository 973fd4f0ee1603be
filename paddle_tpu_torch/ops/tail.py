"""More of the long tail — the counterpart of ``paddle_tpu/ops/tail.py``:
stacking and splitting, diagonal and window writes, cumulative extremes,
the scalar special functions (``torch.special``), histograms and the
misc base ops, registered under the JAX package's names.

Where torch would hand back a view, these ops return a copy, as the JAX
package's arrays are new values: writing through the result of
``as_strided``, ``unfold`` or ``view`` leaves the source as it was.
``histogramdd`` and ``histogram_bin_edges`` bin on the tensor's device
(``searchsorted`` and ``bincount``: torch's ``histogramdd`` has no CUDA
implementation).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ._op import OP_REGISTRY, op

__all__ = [
    "hstack", "vstack", "dstack", "row_stack", "column_stack",
    "atleast_1d", "atleast_2d", "atleast_3d", "block_diag",
    "diagonal_scatter", "slice_scatter", "as_strided",
    "unfold", "view", "fill_diagonal", "fill_diagonal_tensor",
    "cummax", "cummin",
    "bitwise_left_shift", "bitwise_right_shift", "gammaln", "gammainc",
    "gammaincc", "multigammaln", "isreal", "positive", "negative",
    "logaddexp2", "erfc", "xlogy",
    "cumulative_trapezoid", "histogramdd", "histogram_bin_edges",
    "increment", "clip_by_norm", "crop",
]


# ------------------------------------------------- stacking / splitting
@op
def hstack(x, name=None):
    return torch.hstack(list(x))


@op
def vstack(x, name=None):
    return torch.vstack(list(x))


@op
def dstack(x, name=None):
    return torch.dstack(list(x))


@op
def row_stack(x, name=None):
    return torch.vstack(list(x))


@op
def column_stack(x, name=None):
    return torch.column_stack(list(x))


def _atleast(fn, xs):
    out = fn(*xs)
    return list(out) if isinstance(out, tuple) else out


@op
def atleast_1d(*xs, name=None):
    return _atleast(torch.atleast_1d, xs)


@op
def atleast_2d(*xs, name=None):
    return _atleast(torch.atleast_2d, xs)


@op
def atleast_3d(*xs, name=None):
    return _atleast(torch.atleast_3d, xs)


@op
def block_diag(inputs, name=None):
    return torch.block_diag(*inputs)


# ------------------------------------------------- diagonal / windows
def _diag_mask(x, offset, wrap):
    if x.dim() < 2:
        raise ValueError("fill_diagonal needs >= 2 dims")
    if x.dim() == 2:
        nr, nc = x.shape
        n = nr * nc
        step = nc + 1
        start = offset if offset >= 0 else (-offset) * nc
        d = max(min(nr - max(-offset, 0), nc - max(offset, 0)), 0)
        stop = n if wrap else min(n, start + d * step)
        flat = torch.zeros(n, dtype=torch.bool, device=x.device)
        flat[start:stop:step] = True
        return flat.reshape(nr, nc)
    if len(set(x.shape)) != 1:
        raise ValueError("fill_diagonal on >2-D needs equal dims")
    idx = torch.arange(x.shape[0], device=x.device)
    mask = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    mask[(idx,) * x.dim()] = True
    return mask


@op
def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    """Paddle's fill_diagonal: a 2-D tensor's (wrapped) diagonal, or the
    positions with all indices equal of an N-D one with equal dims, set to
    ``value``; the gradient flows to the other entries."""
    v = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return torch.where(_diag_mask(x, offset, wrap), v, x)


@op
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    ym = y if y.dim() == x.dim() - 1 else torch.movedim(y, 0, -1)
    return torch.diagonal_scatter(x, ym.to(x.dtype), offset, axis1, axis2)


@op
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """``y`` written onto the (dim1, dim2) diagonal of ``x``."""
    ym = y if y.dim() == x.dim() - 1 else torch.movedim(y, 0, -1)
    return torch.diagonal_scatter(x, ym.to(x.dtype), offset, dim1, dim2)


@op
def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    idx = [slice(None)] * x.dim()
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[ax] = slice(st, en, sd)
    out = x.clone()
    out[tuple(idx)] = value.to(x.dtype)
    return out


@op
def as_strided(x, shape, stride, offset=0, name=None):
    # a gather from the flattened x: a copy, never a view of x
    flat = x.reshape(-1)
    lin = torch.full((), int(offset), dtype=torch.long, device=x.device)
    for i, (s, st) in enumerate(zip(shape, stride)):
        ar = torch.arange(int(s), device=x.device) * int(st)
        lin = lin + ar.reshape([-1 if j == i else 1
                                for j in range(len(shape))])
    return flat[lin.reshape(tuple(int(s) for s in shape))]


@op
def unfold(x, axis, size, step, name=None):
    # windows along axis, the window's elements the trailing dim (a copy)
    return x.unfold(axis, size, step).clone()


def view(x, shape_or_dtype, name=None):
    """A new tensor: ``x`` reshaped (a list or tuple) or cast (a dtype),
    as the JAX package's ``view`` returns a new array."""
    from .manipulation import cast, reshape
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype).clone()
    return cast(x, shape_or_dtype).clone()


# ------------------------------------------------- cumulative extremes
def _cum_extreme(x, axis, fn, dtype):
    xi = x.reshape(-1) if axis is None else x
    ax = 0 if axis is None else axis % xi.dim()
    values = fn(xi, dim=ax).values
    n = xi.shape[ax]
    ar = torch.arange(n, device=x.device).reshape(
        [-1 if i == ax else 1 for i in range(xi.dim())])
    # the index of the last element equal to the running extreme
    hit = torch.where(xi == values, ar, -1)
    indices = torch.cummax(hit, dim=ax).values
    return values, indices.to(dtype_mod.to_torch_dtype(dtype))


@op
def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, torch.cummax, dtype)


@op
def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, torch.cummin, dtype)


# ------------------------------------------------- scalar math tail
@op
def bitwise_left_shift(x, y, is_arithmetic=True, name=None):
    return torch.bitwise_left_shift(x, y)


@op
def bitwise_right_shift(x, y, is_arithmetic=True, name=None):
    if is_arithmetic or not x.is_signed() or x.dtype == torch.bool:
        return torch.bitwise_right_shift(x, y)
    # logical shift of a signed type: the arithmetic shift with the bits
    # the sign filled in masked off
    bits = x.element_size() * 8
    y = torch.as_tensor(y, device=x.device).to(torch.int64)
    wide = x.to(torch.int64)
    if bits < 64:
        out = torch.bitwise_right_shift(wide & ((1 << bits) - 1), y)
        return out.to(x.dtype)
    keep = torch.where(y > 0,
                       torch.bitwise_left_shift(torch.ones_like(y),
                                                64 - y.clamp(1, 63)) - 1,
                       torch.full_like(y, -1))
    return torch.bitwise_right_shift(wide, y) & keep


@op
def gammaln(x, name=None):
    return torch.special.gammaln(x)


@op
def gammainc(x, y, name=None):
    return torch.special.gammainc(x, y)


@op
def gammaincc(x, y, name=None):
    return torch.special.gammaincc(x, y)


@op
def multigammaln(x, p, name=None):
    return torch.mvlgamma(x, int(p))


@op
def isreal(x, name=None):
    return torch.isreal(x)


@op
def positive(x, name=None):
    return torch.positive(x).clone()


@op
def negative(x, name=None):
    return torch.negative(x)


@op
def logaddexp2(x, y, name=None):
    return torch.logaddexp2(x, y)


@op
def erfc(x, name=None):
    return torch.special.erfc(x)


@op
def xlogy(x, y, name=None):
    return torch.special.xlogy(x, y)


@op
def cumulative_trapezoid(y, x=None, dx=1.0, axis=-1, name=None):
    ym = torch.movedim(y, axis, -1)
    mids = (ym[..., 1:] + ym[..., :-1]) / 2.0
    if x is not None:
        xs = torch.movedim(x, axis, -1) if x.dim() == y.dim() else x
        d = torch.diff(xs, dim=-1)
    else:
        d = dx
    return torch.movedim(torch.cumsum(mids * d, dim=-1), -1, axis)


def _bin_edges(a, bins, rng):
    """``jnp.histogram_bin_edges``: ``bins + 1`` even edges over ``rng``
    (default: the data's min and max), widened by 0.5 each way when the
    range is empty."""
    dt = a.dtype if a.is_floating_point() else dtype_mod.get_default_dtype()
    if rng is None:
        lo, hi = a.min().to(dt), a.max().to(dt)
    else:
        lo = torch.as_tensor(rng[0], dtype=dt, device=a.device)
        hi = torch.as_tensor(rng[1], dtype=dt, device=a.device)
    empty = hi == lo
    lo = torch.where(empty, lo - 0.5, lo)
    hi = torch.where(empty, hi + 0.5, hi)
    # jnp.linspace: start + i * step, the last point exactly stop
    n = int(bins) + 1
    i = torch.arange(n, dtype=dt, device=a.device)
    step = (hi - lo) / (n - 1)
    edges = lo + i * step
    return torch.where(i == n - 1, hi, edges)


@op
def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    N, D = x.shape
    per_dim = list(bins) if isinstance(bins, (list, tuple)) else [bins] * D
    idx_by_dim, edges_by_dim = [], []
    for i in range(D):
        col = x[:, i]
        b = per_dim[i]
        if isinstance(b, torch.Tensor) and b.dim() == 1:
            edges = b.to(x.dtype)
        else:
            rng = None if ranges is None else (
                ranges[2 * i:2 * i + 2] if not isinstance(
                    ranges[0], (list, tuple)) else ranges[i])
            edges = _bin_edges(col, b, rng)
        idx = torch.searchsorted(edges, col.contiguous(), right=True)
        idx = torch.where(col == edges[-1], idx - 1, idx)
        idx_by_dim.append(idx)
        edges_by_dim.append(edges)
    nbins = [e.shape[0] + 1 for e in edges_by_dim]
    flat = torch.zeros(N, dtype=torch.long, device=x.device)
    for idx, nb in zip(idx_by_dim, nbins):
        flat = flat * nb + idx.clamp(0, nb - 1)
    total = int(np.prod(nbins))
    hist = torch.bincount(flat, weights=weights, minlength=total)
    hist = hist.reshape(nbins)[(slice(1, -1),) * D]
    if density:
        hist = hist.to(x.dtype)
        hist = hist / hist.sum()
        for d, e in enumerate(edges_by_dim):
            shape = [1] * D
            shape[d] = -1
            hist = hist / torch.diff(e).reshape(shape)
    return (hist,) + tuple(edges_by_dim)


@op
def histogram_bin_edges(x, bins=100, min=0, max=0, name=None):
    rng = None if (min == 0 and max == 0) else (min, max)
    return _bin_edges(x.reshape(-1), bins, rng)


# ------------------------------------------------- misc paddle base ops
@op
def increment(x, value=1.0, name=None):
    return x + torch.as_tensor(value, dtype=x.dtype, device=x.device)


@op
def clip_by_norm(x, max_norm, name=None):
    n = torch.linalg.vector_norm(x.reshape(-1))
    return torch.where(n > max_norm,
                       x * (max_norm / torch.clamp(n, min=1e-12)), x)


@op
def crop(x, shape=None, offsets=None, name=None):
    shape = list(shape if shape is not None else x.shape)
    offsets = list(offsets if offsets is not None else [0] * x.dim())
    shape = [x.shape[i] if s == -1 else s for i, s in enumerate(shape)]
    idx = tuple(slice(o, o + s) for o, s in zip(offsets, shape))
    return x[idx].clone()


@op
def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return torch.isin(x, test_x, invert=invert)


@op
def vecdot(x, y, axis=-1, name=None):
    return torch.sum(x * y, dim=axis)


@op
def matrix_exp(x, name=None):
    return torch.linalg.matrix_exp(x)


def floor_mod(x, y, name=None):
    from .math import remainder
    return remainder(x, y)


__all__ += ["isin", "vecdot", "matrix_exp", "floor_mod"]


# ------------------------------------------------- paddle-base leftovers
@op
def exp2(x, name=None):
    return torch.exp2(x)


@op
def cartesian_prod(x, name=None):
    if len(x) == 1:  # a single input comes back 1-D unchanged
        return x[0]
    return torch.cartesian_prod(*x)


def _nan_extreme(x, axis, keepdim, fn, fill):
    filled = torch.where(torch.isnan(x), torch.full((), fill, dtype=x.dtype,
                                                    device=x.device), x)
    dims = tuple(range(x.dim())) if axis is None else axis
    out = fn(filled, dim=dims, keepdim=keepdim)
    allnan = torch.all(torch.isnan(x), dim=dims, keepdim=keepdim)
    return torch.where(allnan, torch.full((), float("nan"), dtype=x.dtype,
                                          device=x.device), out)


@op
def nanmin(x, axis=None, keepdim=False, name=None):
    return _nan_extreme(x, axis, keepdim, torch.amin, float("inf"))


@op
def nanmax(x, axis=None, keepdim=False, name=None):
    return _nan_extreme(x, axis, keepdim, torch.amax, float("-inf"))


@op
def logdet(x, name=None):
    # a singular matrix gives -inf; only a negative determinant is nan
    sign, ld = torch.linalg.slogdet(x)
    inf = torch.full((), float("-inf"), dtype=ld.dtype, device=x.device)
    nan = torch.full((), float("nan"), dtype=ld.dtype, device=x.device)
    return torch.where(sign > 0, ld, torch.where(sign == 0, inf, nan))


@op
def vdot(x, y, name=None):
    return torch.vdot(x.reshape(-1), y.reshape(-1))


@op
def ravel(x, name=None):
    return x.reshape(-1).clone()


def one_hot(x, num_classes, name=None):
    from ..nn.functional import one_hot as f_one_hot
    return f_one_hot(x, num_classes)


@op
def chain_matmul(matrices, name=None):
    if len(matrices) == 1:
        return matrices[0]
    return torch.linalg.multi_dot(list(matrices))


@op
def unique_with_counts(x, name=None):
    vals, inv, counts = torch.unique(x.reshape(-1), sorted=True,
                                     return_inverse=True, return_counts=True)
    return vals, inv.to(torch.int32), counts.to(torch.int32)


from .math import bitwise_not as bitwise_invert  # noqa: E402

OP_REGISTRY.setdefault("bitwise_invert", bitwise_invert)
OP_REGISTRY.setdefault("one_hot", one_hot)

__all__ += ["exp2", "cartesian_prod", "nanmin", "nanmax", "logdet",
            "vdot", "bitwise_invert", "ravel", "one_hot", "chain_matmul",
            "unique_with_counts"]
