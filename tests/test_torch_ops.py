"""The port's op surface (``paddle_tpu_torch.ops``: creation, math,
manipulation, linalg) against the JAX package's, on the CPU: one
parametrised test per module over every public function the JAX module
defines, named as the JAX module names it. The same numpy inputs (from a
seed) go through both; float outputs must agree to 1e-6 of the
reference's largest magnitude and carry its float type; integer and
bool outputs must be equal (the port's integers are int64 where the JAX
package, with 64-bit types off, has int32: the values are compared).
Random ops are called after the same ``seed`` on both sides. Singular
and eigen vectors are unique only up to sign, so ``svd``, ``eigh``,
``svd_lowrank`` and ``pca_lowrank`` are held through what they
reconstruct; ``standard_gamma`` and ``binomial`` are torch samplers (not
the reference's rejection loops) and are held to the reference's
distribution: sample means within 5 % over 20000 draws.
"""
import importlib
import inspect

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as paddle
from paddle_tpu.core.tensor import Tensor as JTensor
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


def _public(modname):
    mod = importlib.import_module(f"paddle_tpu.ops.{modname}")
    out = []
    for n, f in vars(mod).items():
        if n.startswith("_") or not callable(f) or inspect.isclass(f) \
                or inspect.ismodule(f):
            continue
        if getattr(getattr(f, "raw_fn", f), "__module__", None) == \
                mod.__name__:
            out.append(n)
    return out


# ---------------------------------------------------------------- plumbing
def to_j(x):
    if isinstance(x, np.ndarray):
        return P.to_tensor(x)
    if isinstance(x, (list, tuple)):
        return type(x)(to_j(v) for v in x)
    return x


def to_t(x):
    if isinstance(x, np.ndarray):
        return paddle.to_tensor(x)
    if isinstance(x, (list, tuple)):
        return type(x)(to_t(v) for v in x)
    return x


def leaves(x):
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in leaves(e)]
    return [x]


def as_np(x):
    if isinstance(x, JTensor):
        x = x.value
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def close(got, want, rtol=RTOL):
    """Float: max |err| <= rtol * max |ref| (and the same float type);
    integers and bools: equal."""
    g, w = as_np(got), as_np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if np.issubdtype(w.dtype, np.inexact):
        assert g.dtype.name == w.dtype.name, (g.dtype, w.dtype)
        scale = max(float(np.max(np.abs(w), initial=0.0)), 1e-30)
        err = float(np.max(np.abs(g.astype(np.complex128)
                                  - w.astype(np.complex128)), initial=0.0))
        assert err <= rtol * scale, (err, scale)
    else:
        assert (w.dtype == np.bool_) == (g.dtype == np.bool_)
        np.testing.assert_array_equal(g, w)


def compare(got, want, rtol=RTOL):
    gl, wl = leaves(got), leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        close(g, w, rtol)


def jax_call(fn, args, kwargs):
    """``fn`` on the JAX package's tensors of ``args``, as one jitted
    program (op by op, every op of the call compiles apart), or eagerly
    where the function reads values on the host (``unique``,
    ``nonzero`` …) and cannot be traced."""
    try:
        return jax.jit(lambda: [o.value if isinstance(o, JTensor) else o
                                for o in leaves(fn(*to_j(args), **kwargs))])()
    except (jax.errors.JAXTypeError, jax.errors.ConcretizationTypeError,
            TypeError, ValueError):
        return fn(*to_j(args), **kwargs)


def run(name, args, kwargs=None, seed=None, jmod=P, tmod=paddle):
    """The port's ``name`` and the JAX package's on the same inputs; a
    seeded (random) call runs the JAX function eagerly, after the same
    ``seed`` on both sides (a traced draw would not advance the global
    key walk)."""
    kwargs = kwargs or {}
    if seed is not None:
        P.seed(seed)
        want = getattr(jmod, name)(*to_j(args), **kwargs)
        paddle.seed(seed)
    else:
        want = jax_call(getattr(jmod, name), args, kwargs)
    got = getattr(tmod, name)(*to_t(args), **kwargs)
    return got, want


# ---------------------------------------------------------------- inputs
R = np.random.RandomState(0)
X = R.randn(3, 4).astype(np.float32)
Y = R.randn(3, 4).astype(np.float32)
X3 = R.randn(2, 3, 4).astype(np.float32)
POS = (R.rand(3, 4) + 0.5).astype(np.float32)
UNIT = (R.rand(3, 4) * 1.8 - 0.9).astype(np.float32)
PROB = (R.rand(3, 4) * 0.9 + 0.05).astype(np.float32)
V = R.randn(5).astype(np.float32)
W = R.randn(4).astype(np.float32)
I1 = R.randint(-5, 6, (3, 4))
I2 = R.randint(-5, 6, (3, 4))
B1 = R.rand(3, 4) > 0.5
B2 = R.rand(3, 4) > 0.5
A = R.randn(4, 3).astype(np.float32)
M = R.randn(4, 4).astype(np.float32)
WC = (M + 4 * np.eye(4)).astype(np.float32)          # well conditioned
SPD = (M @ M.T + 4 * np.eye(4)).astype(np.float32)
TALL = R.randn(6, 3).astype(np.float32)
BT = R.randn(6, 2).astype(np.float32)
NAN = np.array([1.0, np.nan, np.inf, -np.inf, -2.0], np.float32)
SORTED = np.sort(R.randn(8)).astype(np.float32)


# (args, kwargs) by function name; a name missing here fails the test
CREATION = {
    "to_tensor": (([[1.5, 2.0], [3.0, 4.5]],), {}),
    "zeros": (([2, 3],), {}), "ones": (([2, 3],), {"dtype": "int32"}),
    "full": (([2, 3], 1.5), {}), "empty": (([2, 3],), {}),
    "zeros_like": ((X,), {}), "ones_like": ((X,), {"dtype": "float32"}),
    "full_like": ((X, 2.5), {}), "empty_like": ((X,), {}),
    "arange": ((0, 10, 3), {}), "linspace": ((0.0, 1.0, 7), {}),
    "logspace": ((0.0, 2.0, 5), {}), "eye": ((3, 4), {}),
    "diag": ((V,), {"offset": 1}), "diagflat": ((W,), {}),
    "tril": ((M,), {}), "triu": ((M, 1), {}),
    "meshgrid": ((V, W), {}), "assign": ((X,), {}), "clone": ((X,), {}),
    "rand": (([3, 4],), {}), "randn": (([3, 4],), {}),
    "standard_normal": (([5],), {}),
    "normal": ((0.5, 2.0, [4, 3]), {}),
    "uniform": (([3, 3],), {"min": -2.0, "max": 3.0}),
    "randint": ((0, 100, [10]), {}), "randperm": ((17,), {}),
    "multinomial": ((np.array([0.1, 0.2, 0.3, 0.4], np.float32), 3), {}),
    "bernoulli": ((PROB,), {}),
    "standard_gamma": ((np.full(20000, 2.5, np.float32),), {}),
    "binomial": ((np.full(20000, 10.0, np.float32),
                  np.full(20000, 0.3, np.float32)), {}),
}
DISTRIBUTION = ("standard_gamma", "binomial")

MATH = {
    "add": ((X, Y), {}), "subtract": ((X, Y), {}),
    "multiply": ((X, Y), {}), "divide": ((X, POS), {}),
    "floor_divide": ((I1, np.abs(I2) + 1), {}),
    "remainder": ((I1, np.abs(I2) + 1), {}), "mod": ((X, POS), {}),
    "floor_mod": ((X, POS), {}), "pow": ((POS, X), {}),
    "matmul": ((X, Y), {"transpose_y": True}),
    "scale": ((X,), {"scale": 2.0, "bias": 1.0}),
    "maximum": ((X, Y), {}), "minimum": ((X, Y), {}), "fmax": ((X, Y), {}),
    "fmin": ((X, Y), {}), "sqrt": ((POS,), {}), "rsqrt": ((POS,), {}),
    "exp": ((X,), {}), "expm1": ((X,), {}), "log": ((POS,), {}),
    "log2": ((POS,), {}), "log10": ((POS,), {}), "log1p": ((POS,), {}),
    "abs": ((X,), {}), "neg": ((X,), {}), "sign": ((X,), {}),
    "sin": ((X,), {}), "cos": ((X,), {}), "tan": ((UNIT,), {}),
    "asin": ((UNIT,), {}), "acos": ((UNIT,), {}), "atan": ((X,), {}),
    "sinh": ((X,), {}), "cosh": ((X,), {}), "tanh": ((X,), {}),
    "asinh": ((X,), {}), "acosh": ((POS + 1,), {}), "atanh": ((UNIT,), {}),
    "floor": ((X * 3,), {}), "ceil": ((X * 3,), {}),
    "round": ((X * 3,), {}), "trunc": ((X * 3,), {}),
    "square": ((X,), {}), "reciprocal": ((POS,), {}), "erf": ((X,), {}),
    "erfinv": ((UNIT,), {}), "lgamma": ((POS,), {}),
    "digamma": ((POS,), {}), "sigmoid": ((X,), {}), "frac": ((X * 3,), {}),
    "atan2": ((X, Y), {}), "clip": ((X,), {"min": -0.5, "max": 0.5}),
    "lerp": ((X, Y, 0.3), {}),
    "addmm": ((X[:, :3].copy(), X, Y.T.copy()), {"beta": 0.5, "alpha": 2.0}),
    "baddbmm": ((X3[:, :, :3].copy(), X3, X3.transpose(0, 2, 1).copy()),
                {}),
    "reduce_as": ((X3, np.zeros((3, 1), np.float32)), {}),
    "nan_to_num": ((NAN,), {}), "stanh": ((X,), {}),
    "logit": ((PROB,), {"eps": 1e-6}), "trace": ((M,), {"offset": 1}),
    "sum": ((X3,), {"axis": 1}), "mean": ((X3,), {"axis": [0, 2]}),
    "prod": ((X,), {"axis": 1, "keepdim": True}),
    "max": ((X3,), {"axis": -1}), "min": ((X3,), {}),
    "amax": ((X3,), {"axis": [0, 1]}), "amin": ((X3,), {"axis": 2}),
    "std": ((X3,), {"axis": 1}), "var": ((X3,), {"unbiased": False}),
    "median": ((X,), {"axis": 1}), "logsumexp": ((X3,), {"axis": 1}),
    "cumsum": ((X,), {"axis": 1}), "cumprod": ((X,), {"dim": 0}),
    "count_nonzero": ((I1,), {"axis": 1}), "argmax": ((X3,), {"axis": 1}),
    "argmin": ((X3,), {}), "argsort": ((X,), {"axis": 1}),
    "sort": ((X,), {"axis": 1, "descending": True}),
    "topk": ((X, 3), {}), "kthvalue": ((X, 2), {}),
    "searchsorted": ((SORTED, V), {}),
    "unique": ((I1,), {"return_counts": True}), "nonzero": ((B1,), {}),
    "bincount": ((np.abs(I1).reshape(-1),), {}),
    "equal": ((I1, I2), {}), "not_equal": ((I1, I2), {}),
    "greater_than": ((X, Y), {}), "greater_equal": ((I1, I2), {}),
    "less_than": ((X, Y), {}), "less_equal": ((I1, I2), {}),
    "equal_all": ((X, X), {}), "allclose": ((X, X + 1e-9), {}),
    "isclose": ((X, Y), {}), "isnan": ((NAN,), {}), "isinf": ((NAN,), {}),
    "isfinite": ((NAN,), {}), "logical_and": ((B1, B2), {}),
    "logical_or": ((B1, B2), {}), "logical_xor": ((B1, B2), {}),
    "logical_not": ((B1,), {}), "bitwise_and": ((I1, I2), {}),
    "bitwise_or": ((I1, I2), {}), "bitwise_xor": ((I1, I2), {}),
    "bitwise_not": ((I1,), {}), "all": ((B1,), {"axis": 1}),
    "any": ((B1,), {"keepdim": True}), "dot": ((X, Y), {}),
    "bmm": ((X3, X3.transpose(0, 2, 1).copy()), {}),
    "mm": ((X, A), {}), "outer": ((V, W), {}), "inner": ((X, Y), {}),
    "kron": ((M[:2, :2].copy(), X), {}),
    "cross": ((R.randn(4, 3).astype(np.float32),
               R.randn(4, 3).astype(np.float32)), {}),
    "diff": ((X,), {"axis": 1}),
}

# XLA's lgamma (a Lanczos sum) and torch's differ by a few float32 ulps of
# the terms they sum: 1.8e-6 of the largest value at these inputs
MATH_RTOL = {"lgamma": 4e-6}

IDX = np.array([2, 0, 1])
IDX2 = np.array([[0, 1], [2, 3], [1, 0]])
MANIP = {
    "reshape": ((X3, [4, -1]), {}), "view": ((X3, [6, 4]), {}),
    "transpose": ((X3, [1, 0, 2]), {}), "t": ((X,), {}),
    "moveaxis": ((X3, 0, 2), {}), "swapaxes": ((X3, 0, 1), {}),
    "concat": (([X, Y],), {"axis": 1}), "stack": (([X, Y],), {}),
    "split": ((X3, [1, -1]), {"axis": 2}), "chunk": ((X, 2), {"axis": 1}),
    "unstack": ((X3,), {"axis": 1}), "unbind": ((X3,), {}),
    "squeeze": ((X[None, :, None],), {"axis": [0, 2]}),
    "unsqueeze": ((X, [0, 2]), {}), "flatten": ((X3,), {"start_axis": 1}),
    "flip": ((X, [0, 1]), {}), "roll": ((X, 2), {"axis": 1}),
    "rot90": ((M,), {}), "tile": ((X, [2, 1]), {}),
    "broadcast_to": ((W, [3, 4]), {}), "expand": ((W, [3, -1]), {}),
    "expand_as": ((W, X), {}), "broadcast_tensors": (([W, X[:, :1]],), {}),
    "repeat_interleave": ((X, 2), {"axis": 0}),
    "gather": ((X, IDX), {}), "index_select": ((X, IDX), {"axis": 0}),
    "gather_nd": ((X, IDX2), {}),
    "take_along_axis": ((X, np.argsort(X, 1)[:, :2].copy(), 1), {}),
    "put_along_axis": ((X, np.argsort(X, 1)[:, :2].copy(),
                        np.ones((3, 2), np.float32), 1), {"reduce": "add"}),
    "scatter": ((X, IDX, Y), {}),
    "scatter_nd_add": ((X, IDX2, V[:3].copy()), {}),
    "scatter_nd": ((IDX2, V[:3].copy(), [3, 4]), {}),
    "index_add": ((X, IDX, 0, Y), {}),
    "index_put": ((X, (np.array([0, 2]), np.array([1, 3])),
                   np.array([9.0, 8.0], np.float32)), {}),
    "masked_select": ((X, B1), {}), "masked_fill": ((X, B1, 0.5), {}),
    "where": ((B1, X, Y), {}),
    "getitem": ((X3, (slice(0, 2), 1)), {}),
    "slice": ((X3, [0, 2], [0, 1], [1, 3]), {}),
    "pad": ((X3[None], [1, 2, 0, 1]), {"mode": "reflect"}),
    "cast": ((X * 3, "int32"), {}), "astype": ((X, "float16"), {}),
    "numel": ((X3,), {}), "shape": ((X3,), {}),
    "tensordot": ((X, A, 1), {}),
    "as_complex": ((X3[..., :2].copy(),), {}),
    "as_real": ((X.astype(np.complex64) + 1j * Y,), {}),
    "real": ((X.astype(np.complex64) + 1j * Y,), {}),
    "imag": ((X.astype(np.complex64) + 1j * Y,), {}),
    "conj": ((X.astype(np.complex64) + 1j * Y,), {}),
}


def _recon_svd(got, want):
    (gu, gs, gv), (wu, ws, wv) = [[as_np(t) for t in leaves(o)]
                                  for o in (got, want)]
    close(gs, ws)
    close(gu @ np.diag(gs) @ gv, wu @ np.diag(ws) @ wv)


def _recon_lowrank(got, want):
    (gu, gs, gv), (wu, ws, wv) = [[as_np(t) for t in leaves(o)]
                                  for o in (got, want)]
    close(gs, ws)
    close(gu @ np.diag(gs) @ gv.T, wu @ np.diag(ws) @ wv.T)


def _recon_eigh(got, want):
    (gw, gv), (ww, wv) = [[as_np(t) for t in leaves(o)]
                          for o in (got, want)]
    close(gw, ww)
    close(gv @ np.diag(gw) @ gv.T, wv @ np.diag(ww) @ wv.T)


LINALG = {
    "norm": ((X,), {"p": 3, "axis": 1}), "dist": ((X, Y, 3), {}),
    "einsum": (("ij,jk->ik", X, A), {}), "cholesky": ((SPD,), {}),
    "inverse": ((WC,), {}), "inv": ((WC,), {}), "pinv": ((A,), {}),
    "matrix_power": ((WC / 4, 3), {}), "qr": ((A,), {}),
    "svd": ((A,), {}), "eig": ((WC,), {}), "eigh": ((SPD,), {}),
    "eigvalsh": ((SPD,), {}), "det": ((WC,), {}), "slogdet": ((WC,), {}),
    "solve": ((WC, X.T.copy()), {}),
    "triangular_solve": ((np.triu(WC).copy(), X.T.copy()), {}),
    "lstsq": ((TALL, BT), {}), "matrix_rank": ((A,), {}),
    "cov": ((X,), {}), "corrcoef": ((X,), {}),
    "histogram": ((X,), {"bins": 5, "min": -1, "max": 1}),
    "vector_norm": ((X,), {"p": 3}),
    "matrix_norm": ((X3,), {"p": "fro", "axis": [1, 2]}),
    "cond": ((WC,), {}), "svd_lowrank": ((TALL,), {"q": 2}),
    "cholesky_inverse": ((np.linalg.cholesky(SPD).astype(np.float32),), {}),
    "ormqr": ((TALL, np.array([1.2, 0.7], np.float32), BT), {}),
    "pca_lowrank": ((TALL,), {"q": 2}),
}
RECON = {"svd": _recon_svd, "svd_lowrank": _recon_lowrank,
         "pca_lowrank": _recon_lowrank, "eigh": _recon_eigh}
# LAPACK's and XLA's float32 inverse paths round differently: these
# quotients of the well-conditioned WC (condition ~3) agree to 2e-6
LINALG_RTOL = {"cond": 4e-6, "pinv": 2e-6}


# ---------------------------------------------------------------- tests
RANDOM = ("rand", "randn", "standard_normal", "normal", "uniform",
          "randint", "randperm", "multinomial", "bernoulli") + DISTRIBUTION


@pytest.mark.parametrize("name", _public("creation"))
def test_creation(name):
    args, kwargs = CREATION[name]
    got, want = run(name, args, kwargs, seed=3 if name in RANDOM else None)
    if name in DISTRIBUTION:
        g, w = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
        assert g.shape == w.shape
        assert abs(g.mean() - w.mean()) <= 0.05 * abs(w.mean())
        assert abs(g.std() - w.std()) <= 0.05 * w.std()
        return
    compare(got, want)


@pytest.mark.parametrize("name", _public("math"))
def test_math(name):
    args, kwargs = MATH[name]
    got, want = run(name, args, kwargs)
    compare(got, want, MATH_RTOL.get(name, RTOL))


@pytest.mark.parametrize("name", _public("manipulation"))
def test_manipulation(name):
    args, kwargs = MANIP[name]
    jmod = importlib.import_module("paddle_tpu.ops.manipulation")
    got, want = run(name, args, kwargs, jmod=jmod, tmod=paddle.ops)
    compare(got, want)


@pytest.mark.parametrize("name", _public("linalg"))
def test_linalg(name):
    args, kwargs = LINALG[name]
    jmod = importlib.import_module("paddle_tpu.ops.linalg")
    tmod = importlib.import_module("paddle_tpu_torch.ops.linalg")
    got, want = run(name, args, kwargs, jmod=jmod, tmod=tmod)
    if name in RECON:
        RECON[name](got, want)
    else:
        compare(got, want, LINALG_RTOL.get(name, RTOL))


def test_registry_names_match_the_reference():
    """Every op the JAX registry records for these four modules is in the
    port's registry under the same name. (Names the JAX registry takes
    from ``ops/inplace.py`` and ``ops/tail.py`` — the in-place ``name_``
    variants, ``bitwise_invert`` — are not attributes of these modules;
    they wait for ROADMAP.md Queue A step 12b.)"""
    from paddle_tpu.ops._op import OP_REGISTRY as JREG
    from paddle_tpu_torch.ops import OP_REGISTRY as TREG
    mods = [importlib.import_module(f"paddle_tpu.ops.{m}") for m in
            ("creation", "math", "manipulation", "linalg")]
    names = {m.__name__ for m in mods}
    want = {n for n, f in JREG.items()
            if getattr(getattr(f, "raw_fn", f), "__module__", "") in names
            and (n.startswith("_") or any(hasattr(m, n) for m in mods))}
    assert want <= set(TREG), sorted(want - set(TREG))
