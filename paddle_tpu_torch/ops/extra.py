"""The long tail of tensor ops — the counterpart of
``paddle_tpu/ops/extra.py``: Paddle's signatures over torch bodies,
registered under the JAX package's op names. Every op computes on its
tensor's device; ``eigvals`` runs on the host, as the JAX package's
``jnp.linalg.eigvals`` does (and as the port's ``eig``), and so do the
ops whose output shape depends on the data where the JAX package reads
the host (``unique_consecutive`` stays on the device here: torch has it).
``poisson`` is torch's sampler on a generator seeded from the key walk:
the same distribution, not the JAX package's draws.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import random as random_mod
from ._op import op
from .linalg import inverse as inv  # noqa: F401  (both names, one op)

__all__ = [
    "inv", "bucketize", "mode", "logaddexp", "copysign", "heaviside",
    "hypot", "angle", "sinc", "logcumsumexp", "renorm", "diagonal",
    "nanmean", "nansum", "quantile", "nanquantile", "polar", "deg2rad",
    "rad2deg", "gcd", "lcm", "vander", "trapezoid", "cdist", "pdist",
    "cholesky_solve", "multi_dot", "lu", "eigvals", "householder_product",
    "ldexp", "frexp", "nextafter", "isneginf", "isposinf",
    "signbit", "combinations", "diag_embed", "lu_unpack",
]


def _axes(axis):
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return axis


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    from .math import searchsorted
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


@op
def mode(x, axis=-1, keepdim=False, name=None):
    # the most frequent value along axis (ties: the smallest), and the
    # index of its last occurrence (Paddle's)
    n = x.shape[axis]
    sx = torch.movedim(torch.sort(x, dim=axis).values, axis, -1)
    flat = sx.reshape(-1, n).contiguous()
    counts = (torch.searchsorted(flat, flat, right=True)
              - torch.searchsorted(flat, flat)).reshape(sx.shape)
    best = torch.argmax(counts, dim=-1)
    values = torch.gather(sx, -1, best[..., None])[..., 0]
    eq = torch.movedim(x, axis, -1) == values[..., None]
    ar = torch.arange(n, device=x.device)
    indices = torch.amax(torch.where(eq, ar, -1), dim=-1)
    if keepdim:
        values, indices = values.unsqueeze(axis), indices.unsqueeze(axis)
    return values, indices


@op
def logaddexp(x, y, name=None):
    return torch.logaddexp(x, y)


@op
def copysign(x, y, name=None):
    return torch.copysign(x, y)


@op
def heaviside(x, y, name=None):
    return torch.heaviside(x, y)


@op
def hypot(x, y, name=None):
    return torch.hypot(x, y)


@op
def angle(x, name=None):
    return torch.angle(x)


@op
def sinc(x, name=None):
    return torch.sinc(x)


@op
def logcumsumexp(x, axis=None, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtype_mod.to_torch_dtype(dtype))
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, dim=int(axis))


@op
def renorm(x, p, axis, max_norm, name=None):
    # each slice along ``axis`` scaled to p-norm at most max_norm
    dims = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = torch.sum(torch.abs(x) ** p, dim=dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones((), dtype=norms.dtype, device=x.device))
    return x * factor


@op
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2)


@op
def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(x, offset=offset, dim1=dim1, dim2=dim2)


@op
def nanmean(x, axis=None, keepdim=False, name=None):
    if axis is None:
        out = torch.nanmean(x)
        return out.reshape((1,) * x.dim()) if keepdim else out
    return torch.nanmean(x, dim=_axes(axis), keepdim=keepdim)


@op
def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    if axis is None:
        out = torch.nansum(x)
        out = out.reshape((1,) * x.dim()) if keepdim else out
    else:
        out = torch.nansum(x, dim=_axes(axis), keepdim=keepdim)
    if dtype is not None:
        out = out.to(dtype_mod.to_torch_dtype(dtype))
    return out


def _quantile(fn, x, q, axis, keepdim, interpolation):
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = fn(x.reshape(-1), qt, dim=0, interpolation=interpolation)
        if keepdim:
            out = out.reshape(out.shape[:qt.dim()] + (1,) * x.dim())
        return out
    if isinstance(axis, (list, tuple)):
        # several axes: moved last and flattened into one
        axes = [a % x.dim() for a in axis]
        rest = [i for i in range(x.dim()) if i not in axes]
        xm = x.permute(rest + axes).reshape(
            [x.shape[i] for i in rest] + [-1])
        out = fn(xm, qt, dim=-1, interpolation=interpolation)
        if keepdim:
            shape = list(out.shape[:qt.dim()]) + [
                1 if i in axes else x.shape[i] for i in range(x.dim())]
            out = out.reshape(shape)
        return out
    return fn(x, qt, dim=int(axis), keepdim=keepdim,
              interpolation=interpolation)


@op
def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation)


@op
def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim, interpolation)


@op
def polar(abs_, angle_, name=None):
    return torch.polar(abs_, angle_)


@op
def deg2rad(x, name=None):
    return torch.deg2rad(x)


@op
def rad2deg(x, name=None):
    return torch.rad2deg(x)


@op
def gcd(x, y, name=None):
    return torch.gcd(x, y)


@op
def lcm(x, y, name=None):
    return torch.lcm(x, y)


@op
def vander(x, n=None, increasing=False, name=None):
    return torch.vander(x, N=n, increasing=increasing)


@op
def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def _p_dist(diff, p):
    if p == 2.0:
        return torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-30)
    return torch.sum(torch.abs(diff) ** p, dim=-1) ** (1.0 / p)


@op
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    return _p_dist(x[..., :, None, :] - y[..., None, :, :], p)


@op
def pdist(x, p=2.0, name=None):
    i, j = torch.triu_indices(x.shape[0], x.shape[0], 1, device=x.device)
    return _p_dist(x[i] - x[j], p)


@op
def cholesky_solve(x, y, upper=False, name=None):
    # solve A z = x given y = chol(A)
    return torch.cholesky_solve(x, y, upper=upper)


@op
def multi_dot(xs, name=None):
    out = xs[0]
    for m in xs[1:]:
        out = out @ m
    return out


@op
def lu(x, pivot=True, get_infos=False, name=None):
    # LAPACK getrf: 1-based int32 pivots
    lu_mat, piv = torch.linalg.lu_factor(x)
    piv = piv.to(torch.int32)
    if get_infos:
        return lu_mat, piv, torch.zeros(x.shape[:-2], dtype=torch.int32,
                                        device=x.device)
    return lu_mat, piv


@op
def eigvals(x, name=None):
    # on the host, as the JAX package's jnp.linalg.eigvals runs
    w = np.linalg.eigvals(x.detach().cpu().numpy())
    return torch.as_tensor(w, device=x.device)


@op
def householder_product(x, tau, name=None):
    """Q from LAPACK-style elementary reflectors (geqrf's output):
    H_k = I - tau_k v_k v_k^H, Q = H_0 … H_{n-1}, its first n columns."""
    m, n = x.shape[-2], x.shape[-1]
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    q = eye.expand(x.shape[:-2] + (m, m))
    rows = torch.arange(m, device=x.device)
    for k in range(n):
        v = torch.where(rows == k, torch.ones((), dtype=x.dtype,
                                              device=x.device),
                        torch.where(rows > k, x[..., :, k],
                                    torch.zeros((), dtype=x.dtype,
                                                device=x.device)))
        outer = v[..., :, None] * torch.conj(v)[..., None, :]
        q = q @ (eye - tau[..., k, None, None] * outer)
    return q[..., :, :n] if m > n else q


@op
def ldexp(x, y, name=None):
    return x * torch.pow(torch.full((), 2.0, dtype=x.dtype,
                                    device=x.device), y.to(x.dtype))


@op
def frexp(x, name=None):
    return tuple(torch.frexp(x))


@op
def nextafter(x, y, name=None):
    return torch.nextafter(x, y)


@op
def isneginf(x, name=None):
    return torch.isneginf(x)


@op
def isposinf(x, name=None):
    return torch.isposinf(x)


@op
def signbit(x, name=None):
    return torch.signbit(x)


@op
def combinations(x, r=2, with_replacement=False, name=None):
    n = x.shape[0]
    gen = (itertools.combinations_with_replacement(range(n), r)
           if with_replacement else itertools.combinations(range(n), r))
    idx = torch.as_tensor(np.asarray(list(gen), np.int64).reshape(-1, r),
                          device=x.device)
    return x[idx]


@op(name="lu_unpack_lu")
def _lu_unpack_lu(lu_data):
    m, n = lu_data.shape[-2], lu_data.shape[-1]
    k = min(m, n)
    eye = torch.eye(m, k, dtype=lu_data.dtype, device=lu_data.device)
    L = torch.tril(lu_data[..., :, :k], -1) + eye
    U = torch.triu(lu_data[..., :k, :])
    return L, U


@op(name="lu_unpack_p")
def _lu_unpack_p(lu_data, lu_pivots):
    m = lu_data.shape[-2]
    npiv = lu_pivots.shape[-1]
    flat = lu_pivots.reshape(-1, npiv).long() - 1
    P = torch.eye(m, dtype=lu_data.dtype, device=lu_data.device) \
        .repeat(flat.shape[0], 1, 1)
    b = torch.arange(flat.shape[0], device=lu_data.device)
    # getrf's swaps applied to I innermost-first: A = S_0 … S_{k-1} L U
    for i in range(npiv - 1, -1, -1):
        j = flat[:, i]
        ri, rj = P[:, i].clone(), P[b, j].clone()
        P[:, i] = rj
        P[b, j] = ri
    return P.reshape(lu_pivots.shape[:-1] + (m, m))


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True,
              name=None):
    """``lu()``'s output as ``(P, L, U)`` with ``A = P L U``; 1-based
    pivots; an output whose flag is False is None."""
    L = U = P = None
    if unpack_ludata:
        L, U = _lu_unpack_lu(lu_data)
    if unpack_pivots:
        P = _lu_unpack_p(lu_data, lu_pivots)
    return P, L, U


# ------------------------------------------------------------------ r3 batch
__all__ += [
    "broadcast_shape", "complex", "dsplit", "hsplit", "vsplit",
    "tensor_split", "i0", "i0e", "i1", "i1e", "index_fill", "index_sample",
    "is_complex", "is_empty", "is_floating_point", "is_integer", "is_tensor",
    "masked_scatter", "multiplex", "mv", "nanmedian", "poisson", "polygamma",
    "randint_like", "rank", "select_scatter", "sgn", "shard_index",
    "strided_slice", "take", "tolist", "tril_indices", "triu_indices",
    "unflatten", "unique_consecutive", "view_as", "set_printoptions",
]


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@op
def complex(real, imag, name=None):
    return torch.complex(real, imag)


@op
def mv(x, vec, name=None):
    return torch.matmul(x, vec)


@op
def sgn(x, name=None):
    return torch.sgn(x)


@op
def i0(x, name=None):
    return torch.special.i0(x)


@op
def i0e(x, name=None):
    return torch.special.i0e(x)


@op
def i1(x, name=None):
    return torch.special.i1(x)


@op
def i1e(x, name=None):
    return torch.special.i1e(x)


@op
def polygamma(x, n, name=None):
    return torch.special.polygamma(int(n), x)


@op
def nanmedian(x, axis=None, keepdim=False, name=None):
    # the mean of the two middle values (jnp.nanmedian), not torch's lower
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim, "linear")


@op
def unflatten(x, axis, shape, name=None):
    axis = axis % x.dim()
    shape = tuple(int(s) for s in shape)
    return torch.reshape(x, x.shape[:axis] + shape + x.shape[axis + 1:])


@op
def view_as(x, other, name=None):
    return torch.reshape(x, other.shape)


@op
def take(x, index, mode="raise", name=None):
    # the flattened x gathered; 'raise' cannot raise on the device, so it
    # clamps after Python-style negatives, as the JAX package does
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = index.long()
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = torch.clamp(idx, 0, n - 1)
    else:
        idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)
    return flat[idx]


@op
def index_sample(x, index):
    return torch.gather(x, 1, index.long())


@op
def index_fill(x, index, axis, value, name=None):
    return torch.index_fill(x, axis, index.reshape(-1).long(),
                            value if isinstance(value, torch.Tensor)
                            else float(value) if x.is_floating_point()
                            else int(value))


@op
def select_scatter(x, values, axis, index, name=None):
    return torch.select_scatter(x, values.to(x.dtype), axis, index)


@op
def masked_scatter(x, mask, value, name=None):
    # where mask is True, the next element of value (row-major)
    mask_b = torch.broadcast_to(mask.bool(), x.shape)
    vflat = value.reshape(-1)
    needed = int(mask_b.sum())
    if needed > vflat.shape[0]:
        raise ValueError(
            f"masked_scatter: value supplies {vflat.shape[0]} elements "
            f"but mask selects {needed}")
    pos = torch.cumsum(mask_b.reshape(-1).long(), 0) - 1
    picked = vflat[torch.clamp(pos, 0, vflat.shape[0] - 1)]
    return torch.where(mask_b, picked.reshape(x.shape).to(x.dtype), x)


@op
def multiplex(inputs, index, name=None):
    stacked = torch.stack(list(inputs), dim=0)
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


@op
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    if not 0 <= shard_id < nshards:
        raise ValueError(
            f"shard_id ({shard_id}) must be in [0, {nshards})")
    shard_size = (index_num + nshards - 1) // nshards
    owned = torch.div(input, shard_size, rounding_mode="floor") == shard_id
    return torch.where(owned, torch.remainder(input, shard_size),
                       torch.full((), ignore_value, dtype=input.dtype,
                                  device=input.device))


@op
def strided_slice(x, axes, starts, ends, strides, name=None):
    # a copy, as the JAX package's slice is a new array
    slices = [slice(None)] * x.dim()
    for ax, s, e, st in zip(axes, starts, ends, strides):
        st = int(st)
        if st < 0:
            # torch slices take no negative step: the forward range flipped
            idx = np.arange(x.shape[ax])[slice(int(s), int(e), st)].copy()
            x = torch.index_select(x, ax, torch.as_tensor(idx,
                                                          device=x.device))
            continue
        slices[ax] = slice(int(s), int(e), st)
    return x[tuple(slices)].clone()


def _split_impl(x, num_or_indices, axis):
    if isinstance(num_or_indices, int):
        return list(torch.tensor_split(x, num_or_indices, dim=axis))
    return list(torch.tensor_split(x, [int(i) for i in num_or_indices],
                                   dim=axis))


def tensor_split(x, num_or_indices, axis=0, name=None):
    return _split_impl(x, num_or_indices, axis)


def hsplit(x, num_or_indices, name=None):
    return _split_impl(x, num_or_indices, 1 if x.dim() > 1 else 0)


def vsplit(x, num_or_indices, name=None):
    return _split_impl(x, num_or_indices, 0)


def dsplit(x, num_or_indices, name=None):
    return _split_impl(x, num_or_indices, 2)


@op
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, name=None):
    out = torch.unique_consecutive(x, return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    if not isinstance(out, tuple):
        return out
    out = list(out)
    if return_inverse and axis is None:
        out[1] = out[1].reshape(-1)
    return tuple(out)


def tolist(x):
    return x.tolist()


def rank(x):
    return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def is_complex(x):
    return bool(x.is_complex())


def is_floating_point(x):
    return bool(x.is_floating_point())


def is_integer(x):
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


def _tri_indices(fn, row, col, offset, dtype):
    from ..core.device import resolve
    col = row if col is None else col
    idx = np.stack(fn(row, k=offset, m=col))
    return torch.as_tensor(idx, device=resolve()).to(
        dtype_mod.to_torch_dtype(dtype))


def tril_indices(row, col=None, offset=0, dtype="int64"):
    return _tri_indices(np.tril_indices, row, col, offset, dtype)


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return _tri_indices(np.triu_indices, row, col, offset, dtype)


def _generator(device):
    key = random_mod.next_key()
    g = torch.Generator(device=device)
    g.manual_seed(int(key[0]) << 32 | int(key[1]))
    return g


def poisson(x, name=None):
    """Poisson(rate=x) samples: torch's sampler on a generator seeded from
    the key walk (the same distribution as the reference's draws)."""
    return torch.poisson(x.float(), generator=_generator(x.device)) \
        .to(x.dtype)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dt = dtype_mod.to_torch_dtype(dtype) if dtype is not None else x.dtype
    out = random_mod.randint(random_mod.next_key().to(x.device),
                             tuple(x.shape), int(low), int(high))
    return out.to(dt)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """How tensors print: the port's Tensor is ``torch.Tensor``, so these
    are torch's print options (numpy's stay untouched, as in the
    reference)."""
    kw = {k: v for k, v in (("precision", precision),
                            ("threshold", threshold),
                            ("edgeitems", edgeitems),
                            ("linewidth", linewidth),
                            ("sci_mode", sci_mode)) if v is not None}
    torch.set_printoptions(**kw)
