"""Functional autograd — the counterpart of
``paddle_tpu/autograd/functional.py``: ``jacobian``, ``hessian``, ``jvp``,
``vjp`` and the lazy ``Jacobian``/``Hessian`` matrices.

Where the JAX package transforms a functionalized callable with
``jax.jacrev``/``jacfwd``/``jvp``/``vjp``/``vmap``, the port transforms the
callable with their ``torch.func`` counterparts: ``jacobian`` is reverse
mode, ``hessian`` forward over reverse, ``batch_axis=0`` maps over dim 0.
The inputs are detached first and the results carry no history, as the
JAX package's; ``create_graph=True`` raises, as there.
"""
from __future__ import annotations

import torch
import torch.func as tf

__all__ = ["jacobian", "hessian", "jvp", "vjp", "Jacobian", "Hessian"]


def _norm_inputs(xs):
    single = not isinstance(xs, (tuple, list))
    vals = (xs,) if single else tuple(xs)
    return single, tuple(v.detach() for v in vals)


def _check_create_graph(create_graph):
    if create_graph:
        raise NotImplementedError(
            "create_graph=True (results connected to the tape) is not "
            "supported, as in the reference package: these transforms "
            "return detached values. For higher-order derivatives compose "
            "them, e.g. jacobian(lambda x: jacobian(f, x)[...], xs) or "
            "hessian(f, xs).")


def _check_batch_axis(batch_axis):
    if batch_axis not in (None, 0):
        raise ValueError("batch_axis must be None or 0")


def jacobian(func, xs, create_graph=False, batch_axis=None):
    """``d func(xs) / d xs``: a single input and output give a tensor
    ``[*out_shape, *in_shape]``, several inputs a tuple; ``batch_axis=0``
    takes dim 0 as a batch (per-sample Jacobians)."""
    _check_create_graph(create_graph)
    _check_batch_axis(batch_axis)
    single, vals = _norm_inputs(xs)
    jac = tf.jacrev(func, argnums=tuple(range(len(vals))))
    if batch_axis == 0:
        jac = tf.vmap(jac)
    out = jac(*vals)
    return out[0] if single else out


def hessian(func, xs, create_graph=False, batch_axis=None):
    """``d^2 func / d xs^2`` of a scalar ``func``, forward over reverse."""
    _check_create_graph(create_graph)
    _check_batch_axis(batch_axis)
    single, vals = _norm_inputs(xs)
    argnums = tuple(range(len(vals)))

    def scalar(*v):
        out = func(*v)
        leaves = out if isinstance(out, (tuple, list)) else [out]
        if len(leaves) != 1 or leaves[0].dim() != 0:
            raise ValueError("hessian expects a scalar-output func")
        return leaves[0]

    h = tf.jacfwd(tf.jacrev(scalar, argnums=argnums), argnums=argnums)
    hes = tf.vmap(h)(*vals) if batch_axis == 0 else h(*vals)
    return hes[0][0] if single else hes


def jvp(func, xs, v=None):
    """Forward mode: ``(func(xs), J @ v)``; ``v`` defaults to ones."""
    _, vals = _norm_inputs(xs)
    if v is None:
        tangents = tuple(torch.ones_like(x) for x in vals)
    else:
        _, tangents = _norm_inputs(v)
    return tf.jvp(func, vals, tangents)


def vjp(func, xs, v=None):
    """Reverse mode: ``(func(xs), v^T @ J)``; ``v`` defaults to ones."""
    single, vals = _norm_inputs(xs)
    out, pullback = tf.vjp(func, *vals)
    if v is None:
        cot = tuple(torch.ones_like(o) for o in out) \
            if isinstance(out, (tuple, list)) else torch.ones_like(out)
    else:
        cot = v
    grads = pullback(cot)
    return out, (grads[0] if single else grads)


class Jacobian:
    """The Jacobian as a 2-D ``[out_size, in_size]`` matrix (inputs'
    blocks side by side), rows and columns indexable; ``is_batched=True``
    keeps dim 0 as the batch."""

    def __init__(self, func, xs, is_batched=False):
        single = not isinstance(xs, (tuple, list))
        mats = jacobian(func, xs, batch_axis=0 if is_batched else None)
        blocks = (mats,) if single else tuple(mats)
        ins = (xs,) if single else tuple(xs)
        cols = []
        for blk, xin in zip(blocks, ins):
            n = xin.numel()
            if is_batched:
                b = blk.shape[0]
                cols.append(blk.reshape(b, -1, n // b))
            else:
                cols.append(blk.reshape(-1, n))
        self._flat = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)

    @property
    def shape(self):
        return list(self._flat.shape)

    def __getitem__(self, idx):
        return self._flat[idx]


class Hessian:
    """The whole symmetric Hessian of a scalar ``func`` as a 2-D
    ``[in_size, in_size]`` matrix, the cross-input blocks included."""

    def __init__(self, func, xs, is_batched=False):
        single = not isinstance(xs, (tuple, list))
        h = hessian(func, xs, batch_axis=0 if is_batched else None)
        ins = (xs,) if single else tuple(xs)
        sizes = [x.numel() for x in ins]
        b = ins[0].shape[0] if is_batched else None
        if is_batched:
            sizes = [s // b for s in sizes]
        rows = [[h]] if single else [[h[i][j] for j in range(len(ins))]
                                     for i in range(len(ins))]

        def blk(t, ni, nj):
            return t.reshape(b, ni, nj) if is_batched else t.reshape(ni, nj)

        mat_rows = [torch.cat([blk(rows[i][j], sizes[i], sizes[j])
                               for j in range(len(ins))], dim=-1)
                    for i in range(len(ins))]
        self._flat = mat_rows[0] if len(mat_rows) == 1 \
            else torch.cat(mat_rows, dim=-2)

    @property
    def shape(self):
        return list(self._flat.shape)

    def __getitem__(self, idx):
        return self._flat[idx]
