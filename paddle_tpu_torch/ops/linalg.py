"""Linear-algebra ops — the counterpart of ``paddle_tpu/ops/linalg.py``.
Decompositions are torch's (LAPACK on the CPU, cuSOLVER on a card):
singular and eigen vectors are unique only up to sign, so they are held
to the reference through what they reconstruct. Where torch's CPU
solver takes no 16-bit type (``triangular_solve``,
``cholesky_inverse``, ``eig`` on the host), a 16-bit input is solved in
float32 and the result rounded to its type."""
from __future__ import annotations

import numpy as np
import torch

from ._op import op, register_op


@op
def norm(x, p="fro", axis=None, keepdim=False):
    if axis is None and p == "fro":
        return torch.sqrt(torch.sum(torch.square(x)))
    if p == "nuc":
        if axis is None:
            ax = (-2, -1)
        elif isinstance(axis, (list, tuple)) and len(axis) == 2:
            ax = tuple(axis)
        else:
            raise ValueError(
                f"norm(p='nuc') is a matrix norm: axis must be None or a "
                f"2-element list/tuple, got {axis!r}")
        return torch.linalg.matrix_norm(x, ord="nuc", dim=ax,
                                        keepdim=keepdim)
    if isinstance(axis, (list, tuple)) and len(axis) == 2:
        return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis),
                                        keepdim=keepdim)
    if p == "fro":
        p = 2
    if axis is None:
        x, axis = x.reshape(-1), 0
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=axis, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=axis, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=axis, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                               keepdim=keepdim), 1.0 / p)


@op
def dist(x, y, p=2):
    d = torch.abs(x - y)
    if p == float("inf"):
        return torch.amax(d)
    if p == 0:
        return torch.sum((d != 0).to(x.dtype))
    return torch.pow(torch.sum(torch.pow(d, p)), 1.0 / p)


@op
def einsum(equation, *operands):
    return torch.einsum(equation, *operands)


@op
def cholesky(x, upper=False):
    L = torch.linalg.cholesky(x)
    return L.transpose(-1, -2) if upper else L


@op
def inverse(x):
    return torch.linalg.inv(x)


inv = inverse


@op
def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@op
def matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


@op
def qr(x, mode="reduced"):
    if mode == "r":
        return torch.linalg.qr(x, mode="r").R
    return tuple(torch.linalg.qr(x, mode=mode))


@op
def svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


def _wide(*xs):
    """16-bit inputs as float32 (for the solvers without 16-bit kernels)."""
    return [x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
            for x in xs]


@op
def eig(x):
    # on the host, as the reference routes it
    w, v = np.linalg.eig(_wide(x)[0].detach().cpu().numpy())
    return torch.as_tensor(w, device=x.device), \
        torch.as_tensor(v, device=x.device)


@op
def eigh(x, UPLO="L"):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


@op
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@op
def det(x):
    return torch.linalg.det(x)


@op
def slogdet(x):
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs])


@op
def solve(x, y):
    return torch.linalg.solve(x, y)


@op
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    out_dtype = torch.promote_types(x.dtype, y.dtype)
    x, y = _wide(x, y)
    a, up = (x.transpose(-1, -2), not upper) if transpose else (x, upper)
    return torch.linalg.solve_triangular(
        a, y, upper=up, left=True, unitriangular=unitriangular).to(out_dtype)


@op
def lstsq(x, y, rcond=None):
    """``(solution, residuals, rank, singular values)`` by the SVD, as
    ``jnp.linalg.lstsq`` computes them (residuals always returned)."""
    b = y[..., None] if y.dim() == 1 else y
    m, n = x.shape[-2], x.shape[-1]
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(x.dtype).eps * max(n, m)
    mask = s >= rcond * s[..., :1]
    rank = mask.sum(-1)
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))[..., :, None]
    sol = vt.transpose(-1, -2).conj() @ (s_inv * (u.transpose(-1, -2).conj()
                                                  @ b))
    resid = torch.sum(torch.abs(b - x @ sol) ** 2, dim=-2)
    if y.dim() == 1:
        sol, resid = sol[..., 0], resid[..., 0].reshape(1)
    return sol, resid, rank, s


@op
def matrix_rank(x, tol=None, hermitian=False):
    return torch.linalg.matrix_rank(x, rtol=tol)


@op
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else x.transpose(-1, -2),
                     correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)


@op
def corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar else x.transpose(-1, -2))


@op
def histogram(x, bins=100, min=0, max=0):
    """Counts of ``bins`` equal-width bins over ``[min, max]`` (the data's
    range when both are 0), in ``x``'s type, as ``jnp.histogram`` counts:
    a value on the last edge falls into the last bin, others outside are
    dropped."""
    a = x.reshape(-1)
    if min == 0 and max == 0:
        lo, hi = a.min(), a.max()
    else:
        lo = torch.tensor(min, dtype=a.dtype, device=a.device)
        hi = torch.tensor(max, dtype=a.dtype, device=a.device)
    steps = torch.arange(bins + 1, device=a.device, dtype=a.dtype) / bins
    edges = lo + (hi - lo) * steps
    idx = torch.searchsorted(edges, a, right=True)
    idx = torch.where(a == edges[-1], bins, idx)
    counts = torch.zeros(bins + 2, dtype=a.dtype, device=a.device)
    counts.index_add_(0, idx, torch.ones_like(a))
    return counts[1:bins + 1]


@op
def vector_norm(x, p=2, axis=None, keepdim=False):
    if axis is None:
        out = torch.linalg.vector_norm(x.reshape(-1), ord=p)
        return out.reshape((1,) * x.dim()) if keepdim else out
    return torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=keepdim)


@op
def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False):
    return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis),
                                    keepdim=keepdim)


@op
def cond(x, p=None):
    return torch.linalg.cond(x, p=p)


def svd_lowrank(x, q=6, niter=2, M=None):
    """Rank-q truncated SVD, computed exactly and truncated (as the
    reference does; ``niter`` is accepted and unused)."""
    v = x if M is None else x - M
    u, s, vt = torch.linalg.svd(v, full_matrices=False)
    k = min(int(q), s.shape[-1])
    return u[..., :k], s[..., :k], vt.transpose(-2, -1)[..., :k]


@op
def cholesky_inverse(x, upper=False):
    """The inverse of A from its Cholesky factor ``x``."""
    return torch.cholesky_inverse(_wide(x)[0], upper=upper).to(x.dtype)


@op
def ormqr(x, tau, y, left=True, transpose=False):
    """``y`` multiplied by the Q of the Householder reflectors ``(x,
    tau)``, one rank-1 update a reflector (Q never built)."""
    k = tau.shape[-1]
    m = x.shape[-2]
    idx = torch.arange(m, device=x.device)

    def apply_h(i, v_y, right_side):
        col = x[..., :, i]
        v = torch.where(idx < i, torch.zeros_like(col),
                        torch.where(idx == i, torch.ones_like(col), col))
        t = tau[..., i]
        if right_side:
            yv = torch.einsum("...nk,...k->...n", v_y, v)
            return v_y - t[..., None, None] * yv[..., :, None] \
                * v[..., None, :]
        vy = torch.einsum("...m,...mk->...k", v, v_y)
        return v_y - t[..., None, None] * v[..., :, None] * vy[..., None, :]

    out = y
    if left:
        order = range(k) if transpose else range(k - 1, -1, -1)
        for i in order:
            out = apply_h(i, out, right_side=False)
        return out
    order = range(k - 1, -1, -1) if transpose else range(k)
    for i in order:
        out = apply_h(i, out, right_side=True)
    return out


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Rank-q PCA: optional centering, then :func:`svd_lowrank`."""
    v = x - torch.mean(x, dim=-2, keepdim=True) if center else x
    k = min(6, v.shape[-2], v.shape[-1]) if q is None else int(q)
    return svd_lowrank(v, q=k, niter=niter)


register_op(svd_lowrank)
register_op(pca_lowrank)

__all__ = ["norm", "dist", "einsum", "cholesky", "inverse", "pinv",
           "matrix_power", "qr", "svd", "eig", "eigh", "eigvalsh", "det",
           "slogdet", "solve", "triangular_solve", "lstsq", "matrix_rank",
           "cov", "corrcoef", "histogram", "vector_norm", "matrix_norm",
           "cond", "svd_lowrank", "cholesky_inverse", "ormqr",
           "pca_lowrank", "inv"]
