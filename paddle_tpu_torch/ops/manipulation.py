"""Shape and indexing ops — the counterpart of
``paddle_tpu/ops/manipulation.py``, registered under the JAX package's
op names (``_reshape``, ``_tile``, ``_cast`` … for the bodies of the
public wrappers)."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ._op import op


def _norm_shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item() if isinstance(s, torch.Tensor) else s)
                 for s in shape)


def _int(v):
    return int(v.item() if isinstance(v, torch.Tensor) else v)


@op
def _reshape(x, shape):
    return torch.reshape(x, shape)


def reshape(x, shape, name=None):
    return _reshape(x, _norm_shape(shape))


view = reshape


@op
def transpose(x, perm):
    return x.permute(*[int(p) for p in perm])


@op
def t(x):
    if x.dim() < 2:
        return x
    return x.transpose(-1, -2)


@op
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@op
def swapaxes(x, axis0, axis1):
    return torch.swapaxes(x, axis0, axis1)


@op
def concat(x, axis=0):
    return torch.cat(list(x), dim=_int(axis))


@op
def stack(x, axis=0):
    return torch.stack(list(x), dim=axis)


@op
def _split_sections(x, sections, axis):
    total = x.shape[axis]
    if isinstance(sections, int):
        if total % sections:
            raise ValueError(f"array split does not result in an equal "
                             f"division: {total} into {sections}")
        return tuple(torch.split(x, total // sections, dim=axis))
    sizes = [_int(s) for s in sections]
    if -1 in sizes:
        known = int(np.sum([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = total - known
    return tuple(torch.split(x, sizes, dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    return list(_split_sections(x, num_or_sections, _int(axis)))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unstack(x, axis=0, num=None):
    n = num if num is not None else x.shape[axis]
    return [squeeze(p, axis=axis) for p in split(x, n, axis)]


def unbind(x, axis=0):
    return unstack(x, axis)


@op
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, (list, tuple)):
        axis = tuple(a for a in axis if x.shape[a] == 1)
        return torch.squeeze(x, dim=axis) if axis else x
    return torch.squeeze(x, dim=axis)


@op
def unsqueeze(x, axis):
    if isinstance(axis, (list, tuple)):
        out = x
        for a in sorted(_int(v) for v in axis):
            out = torch.unsqueeze(out, a)
        return out
    return torch.unsqueeze(x, _int(axis))


@op
def flatten(x, start_axis=0, stop_axis=-1):
    nd = x.dim()
    if nd == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % nd, stop_axis % nd)


@op
def flip(x, axis):
    return torch.flip(x, dims=(axis,) if isinstance(axis, int)
                      else tuple(axis))


@op
def roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, dims=axis)


@op
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, dims=tuple(axes))


@op
def _tile(x, repeat_times):
    return torch.tile(x, repeat_times)


def tile(x, repeat_times, name=None):
    return _tile(x, _norm_shape(repeat_times))


@op
def _broadcast_to(x, shape):
    return torch.broadcast_to(x, shape)


def broadcast_to(x, shape, name=None):
    return _broadcast_to(x, _norm_shape(shape))


def expand(x, shape, name=None):
    shape = _norm_shape(shape)
    # -1 keeps a dimension
    xshape = (1,) * (len(shape) - x.dim()) + tuple(x.shape)
    shape = tuple(xs if s == -1 else s for s, xs in zip(shape, xshape))
    return _broadcast_to(x, shape)


def expand_as(x, y, name=None):
    return _broadcast_to(x, tuple(y.shape))


def broadcast_tensors(inputs, name=None):
    out_shape = torch.broadcast_shapes(*[tuple(t.shape) for t in inputs])
    return [_broadcast_to(t, tuple(out_shape)) for t in inputs]


@op
def repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@op
def gather(x, index, axis=0):
    return torch.index_select(x, _int(axis), index.reshape(-1))


index_select = gather


@op
def gather_nd(x, index):
    return x[tuple(torch.movedim(index, -1, 0))]


@op
def take_along_axis(arr, indices, axis, broadcast=True):
    if broadcast:
        shape = list(arr.shape)
        shape[axis] = indices.shape[axis]
        indices = torch.broadcast_to(indices, shape)
    return torch.take_along_dim(arr, indices, dim=axis)


@op
def put_along_axis(arr, indices, values, axis, reduce="assign",
                   broadcast=True):
    if not isinstance(values, torch.Tensor) or values.dim() == 0:
        values = torch.full(indices.shape, float(values) if not isinstance(
            values, torch.Tensor) else values.item(), dtype=arr.dtype,
            device=arr.device)
    values = torch.broadcast_to(values, indices.shape).to(arr.dtype)
    if reduce == "assign":
        return torch.scatter(arr, axis, indices, values)
    if reduce in ("add", "sum"):
        return torch.scatter_add(arr, axis, indices, values)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(arr, axis, indices, values, "prod")
    raise ValueError(f"unknown reduce {reduce}")


@op
def scatter(x, index, updates, overwrite=True):
    return x.index_put((index.reshape(-1),), updates,
                       accumulate=not overwrite)


@op
def scatter_nd_add(x, index, updates):
    return x.index_put(tuple(torch.movedim(index, -1, 0)), updates,
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    zeros = torch.zeros(_norm_shape(shape), dtype=updates.dtype,
                        device=updates.device)
    return scatter_nd_add(zeros, index, updates)


@op
def index_add(x, index, axis, value):
    return torch.index_add(x, axis, index.reshape(-1), value)


@op
def index_put(x, indices, value, accumulate=False):
    return x.index_put(tuple(indices), value, accumulate=accumulate)


@op
def masked_select(x, mask):
    return x[mask]


@op
def masked_fill(x, mask, value):
    v = value if isinstance(value, torch.Tensor) \
        else torch.tensor(value, device=x.device)
    return torch.where(mask, v.to(x.dtype), x)


@op
def where(condition, x=None, y=None):
    if x is None and y is None:
        return torch.where(condition)
    return torch.where(condition, x, y)


@op
def _getitem(x, idx):
    return x[idx]


def getitem(x, idx):
    return _getitem(x, idx)


@op
def _setitem(x, idx, value):
    out = x.clone()
    out[idx] = value
    return out


@op
def slice(input, axes, starts, ends):
    out = input
    for ax, s, e in zip(axes, starts, ends):
        s, e = _int(s), _int(e)
        size = input.shape[ax]
        s = max(s + size, 0) if s < 0 else min(s, size)
        e = max(e + size, 0) if e < 0 else min(e, size)
        out = out.narrow(ax, s, max(e - s, 0))
    return out


def _pad_dim(x, d, lo, hi, mode):
    if not lo and not hi:
        return x
    n = x.shape[d]
    if mode == "reflect":
        left = x.narrow(d, 1, lo).flip(d)
        right = x.narrow(d, n - 1 - hi, hi).flip(d)
    elif mode == "replicate":
        left = x.narrow(d, 0, 1).repeat_interleave(lo, dim=d)
        right = x.narrow(d, n - 1, 1).repeat_interleave(hi, dim=d)
    else:   # circular
        left = x.narrow(d, n - lo, lo)
        right = x.narrow(d, 0, hi)
    return torch.cat([left, x, right], dim=d)


@op
def _pad_nd(x, pad_width, mode, value):
    if mode == "constant":
        flat = [p for lo_hi in reversed(pad_width) for p in lo_hi]
        return torch.nn.functional.pad(x, flat, "constant", value)
    if mode not in ("reflect", "replicate", "circular"):
        raise KeyError(mode)
    for d, (lo, hi) in enumerate(pad_width):
        x = _pad_dim(x, d, lo, hi, mode)
    return x


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``paddle.nn.functional.pad``: ``pad`` is 2 * ndim long (every
    dimension, first to last) or pairs for the spatial dimensions, the
    last spatial dimension first."""
    nd = x.dim()
    if isinstance(pad, int):
        pad = [pad] * (2 * (nd - 2))
    pad = [_int(p) for p in pad]
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
        return _pad_nd(x, width, mode, value)
    n_spatial = len(pad) // 2
    width = [(0, 0)] * nd
    if data_format.startswith("NC"):
        spatial_axes = list(range(2, 2 + n_spatial))
    else:
        spatial_axes = list(range(1, 1 + n_spatial))
    for i, ax in enumerate(reversed(spatial_axes)):
        width[ax] = (pad[2 * i], pad[2 * i + 1])
    return _pad_nd(x, width, mode, value)


@op
def _cast(x, dtype):
    return x.to(dtype)


def cast(x, dtype):
    return _cast(x, dtype_mod.to_torch_dtype(dtype))


astype = cast


def numel(x):
    return torch.tensor(x.numel(), dtype=dtype_mod.long_dtype(),
                        device=x.device)


def shape(x):
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


@op
def tensordot(x, y, axes=2):
    return torch.tensordot(x, y, dims=axes)


@op
def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


@op
def as_real(x):
    return torch.stack([x.real, x.imag], dim=-1)


@op
def real(x):
    return x.real.clone() if x.is_complex() else x


@op
def imag(x):
    return x.imag.clone() if x.is_complex() else torch.zeros_like(x)


@op
def conj(x):
    return torch.conj(x).resolve_conj()


__all__ = ["reshape", "view", "transpose", "t", "moveaxis", "swapaxes",
           "concat", "stack", "split", "chunk", "unstack", "unbind",
           "squeeze", "unsqueeze", "flatten", "flip", "roll", "rot90",
           "tile", "broadcast_to", "expand", "expand_as",
           "broadcast_tensors", "repeat_interleave", "gather",
           "index_select", "gather_nd", "take_along_axis", "put_along_axis",
           "scatter", "scatter_nd_add", "scatter_nd", "index_add",
           "index_put", "masked_select", "masked_fill", "where", "getitem",
           "slice", "pad", "cast", "astype", "numel", "shape", "tensordot",
           "as_complex", "as_real", "real", "imag", "conj"]
