"""The port's long-tail op modules (``paddle_tpu_torch.ops.extra``,
``ops.tail``, ``ops.inplace``) against the JAX package's, on the CPU: one
parametrised test per module over every public function the JAX module
defines, as ``test_torch_ops.py`` holds the four core modules. Float
outputs agree to 1e-6 of the reference's largest magnitude, integers and
bools are equal (the log-gamma family 4e-6, as ``lgamma`` in
``test_torch_ops.py``). ``poisson`` is a torch sampler (the reference's
distribution, not its draws): sample means within 5 % over 20000
draws. ``eigvals`` of a real matrix holds its conjugate pairs in either
order, so the sorted values are compared.

Beyond values: the results of ``as_strided``, ``unfold`` and ``view``
are copies (writing through them leaves the source unchanged, as the
JAX package's new arrays do); every in-place ``*_`` variant equals the
JAX package's result and its gradient flows as there; the random
refills draw the JAX package's uniform bits bit for bit (``uniform_``,
``bernoulli_``, ``geometric_``), within float32 ulps after ``log`` and
``tan``, and within the normal ops' 1e-5 after ``erfinv``;
the two cases torch's autograd refuses (an in-place op on a leaf that
requires grad, on a tensor an earlier op saved) raise torch's error.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as paddle
from test_torch_ops import (R, X, Y, X3, POS, UNIT, PROB, V, W, I1, I2, M,
                            WC, SPD, SORTED, as_np, compare, run)
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-6
# the log-gamma family: torch's and XLA's lgamma part by a few ulps of
# the largest value (``test_torch_ops.py`` MATH_RTOL["lgamma"])
GAMMA_RTOL = 4e-6
GAMMA = ("gammaln", "multigammaln", "lgamma")


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")
    yield


def _names(modname):
    from test_torch_ops import _public
    return _public(modname)


NANS = np.array([[1.0, np.nan, 3.0, -2.0], [np.nan, np.nan, 0.5, 4.0],
                 [2.0, 2.0, np.nan, 1.0]], np.float32)
MODE = np.array([[1, 3, 3, 2, 1, 3], [4, 4, 2, 2, 5, 5]], np.float32)
LU_IN = (M + 0.5 * np.eye(4)).astype(np.float32)
QR_A = np.linalg.qr(R.randn(5, 3).astype(np.float64), mode="raw")
HH_X = np.ascontiguousarray(QR_A[0].T).astype(np.float32)
HH_TAU = QR_A[1].astype(np.float32)
UINT = R.randint(0, 40, (3, 4)).astype(np.int32)
SHIFT = R.randint(0, 5, (3, 4)).astype(np.int32)
NEG_I = np.array([-64, -3, 17, 255], np.int32)
CONSEC = np.array([1, 1, 2, 2, 3, 1, 1], np.int64)
HIST = R.rand(40, 2).astype(np.float32)
B_MASK = R.rand(3, 4) > 0.5

EXTRA = {
    "bucketize": ((V, SORTED), {}),
    "mode": ((MODE,), {"axis": -1}),
    "logaddexp": ((X, Y), {}), "copysign": ((X, Y), {}),
    "heaviside": ((X, Y), {}), "hypot": ((X, Y), {}),
    "angle": ((X,), {}), "sinc": ((X,), {}),
    "logcumsumexp": ((X,), {"axis": 1}),
    "renorm": ((X, 2.0, 0, 1.0), {}),
    "diagonal": ((X3,), {"offset": 1, "axis1": 1, "axis2": 2}),
    "diag_embed": ((X,), {"offset": 1}),
    "nanmean": ((NANS,), {"axis": 1}),
    "nansum": ((NANS,), {"axis": 0, "keepdim": True}),
    "quantile": ((X,), {"q": [0.25, 0.5], "axis": 1}),
    "nanquantile": ((NANS,), {"q": 0.3, "axis": 1}),
    "polar": ((POS, X), {}),
    "deg2rad": ((X,), {}), "rad2deg": ((X,), {}),
    "gcd": ((I1, I2), {}), "lcm": ((I1, I2), {}),
    "vander": ((V,), {"n": 4}),
    "trapezoid": ((X,), {"dx": 0.5}),
    "cdist": ((X, Y), {}), "pdist": ((X,), {}),
    "cholesky_solve": ((X[:, :3].T.copy(), np.linalg.cholesky(
        SPD[:3, :3]).astype(np.float32)), {}),
    "multi_dot": (([X, M, M.T.copy()],), {}),
    "lu": ((LU_IN,), {"get_infos": True}),
    "eigvals": ((WC,), {}),
    "householder_product": ((HH_X, HH_TAU), {}),
    "ldexp": ((X, I1), {}), "frexp": ((X,), {}),
    "nextafter": ((X, Y), {}),
    "isneginf": ((np.array([1.0, -np.inf, np.inf, np.nan], np.float32),),
                 {}),
    "isposinf": ((np.array([1.0, -np.inf, np.inf, np.nan], np.float32),),
                 {}),
    "signbit": ((np.array([1.0, -0.0, 0.0, -3.0], np.float32),), {}),
    "combinations": ((V,), {"r": 3}),
    "lu_unpack": ((), {}),
    "broadcast_shape": (([3, 1, 4], [5, 1]), {}),
    "complex": ((X, Y), {}), "mv": ((X, W), {}), "sgn": ((X,), {}),
    "i0": ((X,), {}), "i0e": ((X,), {}), "i1": ((X,), {}),
    "i1e": ((X,), {}), "polygamma": ((POS, 1), {}),
    "nanmedian": ((NANS,), {"axis": 1}),
    "unflatten": ((X3, 2, [2, 2]), {}),
    "view_as": ((X, np.zeros((4, 3), np.float32)), {}),
    "take": ((X, np.array([[0, -1], [13, 5]])), {"mode": "wrap"}),
    "index_sample": ((X, np.array([[0, 3], [1, 1], [2, 0]])), {}),
    "index_fill": ((X, np.array([0, 2]), 1, 9.5), {}),
    "select_scatter": ((X, W, 0, 1), {}),
    "masked_scatter": ((X, B_MASK, R.randn(12).astype(np.float32)), {}),
    "multiplex": (([X, Y], np.array([[1], [0], [1]], np.int32)), {}),
    "shard_index": ((np.array([[1], [6], [12], [19]], np.int64), 20, 2, 1),
                    {}),
    "strided_slice": ((X3, [1, 2], [0, 3], [3, 0], [2, -2]), {}),
    "tensor_split": ((X3, 3), {"axis": 2}),
    "hsplit": ((X, [1, 3]), {}), "vsplit": ((X, 3), {}),
    "dsplit": ((X3, 2), {}),
    "unique_consecutive": ((CONSEC,), {"return_inverse": True,
                                       "return_counts": True}),
    "tolist": ((X,), {}), "rank": ((X3,), {}),
    "is_tensor": ((X,), {}), "is_complex": ((X,), {}),
    "is_floating_point": ((X,), {}), "is_integer": ((I1,), {}),
    "is_empty": ((X,), {}),
    "tril_indices": ((4, 5, 1), {}), "triu_indices": ((4, 3, -1), {}),
    "poisson": ((np.full(20000, 3.5, np.float32),), {}),
    "randint_like": ((X, -5, 17), {}),
    "set_printoptions": ((), {"precision": 6}),
}

TAIL = {
    "hstack": (([X, Y],), {}), "vstack": (([X, Y],), {}),
    "dstack": (([X, Y],), {}), "row_stack": (([X, Y],), {}),
    "column_stack": (([V, V],), {}),
    "atleast_1d": ((X, V), {}), "atleast_2d": ((V,), {}),
    "atleast_3d": ((X,), {}),
    "block_diag": (([X, M[:2, :3].copy()],), {}),
    "fill_diagonal": ((X, 7.0), {"offset": 1, "wrap": True}),
    "fill_diagonal_tensor": ((X, np.arange(3, dtype=np.float32)),
                             {"offset": 0}),
    "diagonal_scatter": ((M, V[:3].copy()), {"offset": 1}),
    "slice_scatter": ((X, np.zeros((2, 4), np.float32), [0], [0], [3],
                       [2]), {}),
    "as_strided": ((X, [3, 2], [1, 4]), {"offset": 1}),
    "unfold": ((X3, 2, 2, 1), {}),
    "view": ((X3, [6, 4]), {}),
    "cummax": ((np.array([[1, 3, 3, 2, 5, 5]], np.float32),), {"axis": 1}),
    "cummin": ((np.array([[4, 3, 3, 5, 1, 1]], np.float32),), {"axis": 1}),
    "bitwise_left_shift": ((UINT, SHIFT), {}),
    "bitwise_right_shift": ((NEG_I, np.array([1, 2, 3, 0], np.int32)),
                            {"is_arithmetic": False}),
    "gammaln": ((POS,), {}), "gammainc": ((POS, PROB), {}),
    "gammaincc": ((POS, PROB), {}), "multigammaln": ((POS + 1.0, 2), {}),
    "isreal": ((X,), {}), "positive": ((X,), {}), "negative": ((X,), {}),
    "logaddexp2": ((X, Y), {}), "erfc": ((X,), {}), "xlogy": ((X, POS), {}),
    "cumulative_trapezoid": ((X,), {"dx": 0.5, "axis": 1}),
    "histogramdd": ((HIST,), {"bins": [3, 4], "density": True}),
    "histogram_bin_edges": ((X,), {"bins": 6}),
    "increment": ((X, 2.5), {}), "clip_by_norm": ((X, 1.0), {}),
    "crop": ((X3, [1, -1, 2], [1, 0, 1]), {}),
    "isin": ((I1, np.array([0, 2, -3])), {}),
    "vecdot": ((X, Y), {}), "matrix_exp": ((0.3 * M,), {}),
    "floor_mod": ((X, POS), {}), "exp2": ((X,), {}),
    "cartesian_prod": (([V[:2].copy(), W[:3].copy()],), {}),
    "nanmin": ((NANS,), {"axis": 1}), "nanmax": ((NANS,), {"axis": 0}),
    "logdet": ((SPD,), {}), "vdot": ((X, Y), {}), "ravel": ((X3,), {}),
    "one_hot": ((np.array([0, 3, 1]), 4), {}),
    "chain_matmul": (([X, M, M],), {}),
    "unique_with_counts": ((CONSEC,), {}),
}


def _lu_unpack_case():
    lu_t = paddle.lu(paddle.to_tensor(LU_IN))
    lu_j = P.lu(P.to_tensor(LU_IN))
    got = paddle.lu_unpack(*lu_t)
    want = P.lu_unpack(*lu_j)
    compare(got, want)
    p, l, u = (as_np(t) for t in got)
    np.testing.assert_allclose(p @ l @ u, LU_IN, atol=1e-5)


@pytest.mark.parametrize("name", _names("extra"))
def test_extra(name):
    if name == "lu_unpack":
        return _lu_unpack_case()
    args, kwargs = EXTRA[name]
    if name == "set_printoptions":
        import paddle_tpu.core.tensor as jt
        saved = dict(jt._print_options)
        try:
            P.set_printoptions(**kwargs)
            paddle.set_printoptions(**kwargs)
            assert torch._tensor_str.PRINT_OPTS.precision == 6
        finally:
            jt._print_options.clear()
            jt._print_options.update(saved)
            torch.set_printoptions(profile="default")
        return
    got, want = run(name, args, kwargs,
                    seed=3 if name in ("poisson", "randint_like") else None)
    if name == "poisson":
        g, w = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
        assert g.shape == w.shape
        assert abs(g.mean() - w.mean()) <= 0.05 * w.mean()
        return
    if name == "eigvals":
        g, w = np.sort_complex(as_np(got)), np.sort_complex(as_np(want))
        assert np.max(np.abs(g - w)) <= RTOL * 10 * np.max(np.abs(w))
        return
    compare(got, want, RTOL)


@pytest.mark.parametrize("name", _names("tail"))
def test_tail(name):
    args, kwargs = TAIL[name]
    got, want = run(name, args, kwargs)
    compare(got, want, GAMMA_RTOL if name in GAMMA else RTOL)


# ------------------------------------------------------- copies, not views
@pytest.mark.parametrize("name,args", [
    ("as_strided", ([3, 2], [1, 4], 1)), ("unfold", (1, 2, 1)),
    ("view", ([4, 3],)), ("view", ("float32",)),
])
def test_results_are_copies(name, args):
    """Writing through the result leaves the source as the JAX package's
    (an immutable array) is."""
    src = paddle.to_tensor(X)
    out = getattr(paddle, name)(src, *args)
    out[...] = 100.0
    jsrc = P.to_tensor(X)
    jout = getattr(P, name)(jsrc, *args)
    jout[...] = 100.0
    compare(src, jsrc)
    np.testing.assert_array_equal(as_np(src), X)


# ------------------------------------------------------- in-place variants
def _jax_inplace_names():
    from paddle_tpu.ops import inplace as jin
    return [n for n in jin.__all__ if n not in (
        "uniform_", "normal_", "exponential_", "bernoulli_", "cauchy_",
        "geometric_", "log_normal_", "fill_", "zero_")]


BASE_ARGS = {
    "add": (Y,), "subtract": (Y,), "multiply": (Y,), "divide": (POS,),
    "remainder": (POS,), "mod": (POS,), "floor_divide": (POS,),
    "pow": (2.0,), "clip": (-0.5, 0.5), "scale": (2.0, 1.0), "lerp": (Y, 0.3),
    "hypot": (Y,), "ldexp": (I1,), "copysign": (Y,), "gammainc": (PROB,),
    "gammaincc": (PROB,), "squeeze": (), "unsqueeze": (1,),
    "reshape": ([2, 6],), "flatten": (), "transpose": ([1, 0],), "t": (),
    "scatter": (np.array([2, 0]), np.ones((2, 4), np.float32)),
    "masked_fill": (B_MASK, -1.0),
    "index_add": (np.array([0, 2]), 0, np.ones((2, 4), np.float32)),
    "index_put": ((np.array([0, 2]), np.array([1, 3])),
                  np.array([5.0, 6.0], np.float32)),
    "index_fill": (np.array([1]), 1, 4.0),
    "masked_scatter": (B_MASK, R.randn(12).astype(np.float32)),
    "put_along_axis": (np.array([[0], [1], [3]]),
                       np.array([[1.0], [2.0], [3.0]], np.float32), 1),
    "renorm": (2.0, 0, 1.0), "cumsum": (1,), "cumprod": (1,),
    "tril": (), "triu": (1,), "fill_diagonal": (3.0,),
    "fill_diagonal_tensor": (np.arange(3, dtype=np.float32),),
    "logical_and": (B_MASK,), "logical_or": (B_MASK,),
    "logical_xor": (B_MASK,), "logical_not": (),
    "bitwise_and": (I2,), "bitwise_or": (I2,), "bitwise_xor": (I2,),
    "bitwise_not": (), "less_than": (Y,), "less_equal": (Y,),
    "greater_than": (Y,), "greater_equal": (Y,), "not_equal": (Y,),
    "equal": (Y,),
}
RECEIVER = {"gcd": I1, "lcm": I1, "bitwise_and": I1, "bitwise_or": I1,
            "bitwise_xor": I1, "bitwise_not": I1, "logical_not": B_MASK,
            "logical_and": R.rand(3, 4) > 0.3,
            "logical_or": R.rand(3, 4) > 0.3,
            "logical_xor": R.rand(3, 4) > 0.3,
            "sqrt": POS, "rsqrt": POS, "log": POS, "log2": POS,
            "log10": POS, "log1p": POS, "digamma": POS, "lgamma": POS,
            "gammaln": POS, "gammainc": POS, "gammaincc": POS,
            "asin": UNIT, "acos": UNIT, "atanh": UNIT, "erfinv": UNIT,
            "acosh": POS + 1.0, "logit": PROB, "squeeze": X[None],
            "fill_diagonal": X.copy(), "reciprocal": POS}
EXTRA_ARGS = {"gcd": (I2,), "lcm": (I2,)}


@pytest.mark.parametrize("name", _jax_inplace_names())
def test_inplace(name):
    """``paddle.<op>_(x, …)`` writes the functional op's result into ``x``
    and returns ``x``, as the JAX package's rebinding does."""
    from paddle_tpu.ops import inplace as jin
    base = name[:-1]
    if name == "where_":
        args = (B_MASK, X.copy(), Y)
        jx, tx = P.to_tensor(args[1]), paddle.to_tensor(args[1])
        jres = jin.where_(P.to_tensor(B_MASK), jx, P.to_tensor(Y))
        tres = paddle.where_(paddle.to_tensor(B_MASK), tx,
                             paddle.to_tensor(Y))
        assert tres is tx
        compare(tx, jx)
        return
    recv = RECEIVER.get(base, X)
    args = BASE_ARGS.get(base, EXTRA_ARGS.get(base, ()))
    tj = P.to_tensor(recv)
    tt = paddle.to_tensor(recv)
    conv_j = [P.to_tensor(a) if isinstance(a, np.ndarray) else
              tuple(P.to_tensor(v) for v in a) if isinstance(a, tuple)
              else a for a in args]
    conv_t = [paddle.to_tensor(a) if isinstance(a, np.ndarray) else
              tuple(paddle.to_tensor(v) for v in a) if isinstance(a, tuple)
              else a for a in args]
    getattr(jin, name)(tj, *conv_j)
    out = getattr(paddle, name)(tt, *conv_t)
    assert out is tt
    compare(tt, tj, GAMMA_RTOL if base in GAMMA else RTOL)


def test_inplace_gradient_flows_through_the_rebind():
    """``y = x * w; add_(y, z); exp_(y)``: gradients to x, w and z are the
    JAX package's (each op recorded on a copy of its receiver)."""
    def run_side(lib, tt):
        x = tt(X, stop_gradient=False)
        w = tt(Y, stop_gradient=False)
        z = tt(POS, stop_gradient=False)
        y = x * w
        lib.add_(y, z)
        lib.multiply_(y, w)
        lib.tanh_(y)
        (y * tt(M[:3])).sum().backward()
        return y, x.grad, w.grad, z.grad

    from paddle_tpu.ops import inplace as jin

    class JLib:
        add_ = staticmethod(jin.add_)
        multiply_ = staticmethod(jin.multiply_)
        tanh_ = staticmethod(jin.tanh_)

    want = run_side(JLib, P.to_tensor)
    got = run_side(paddle, paddle.to_tensor)
    compare(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        compare(g, w, 1e-5)


def test_inplace_shape_ops_keep_the_gradient():
    x = paddle.to_tensor(X3, stop_gradient=False)
    y = x * 2.0
    paddle.transpose_(y, [2, 0, 1])
    paddle.reshape_(y, [4, 6])
    (y * paddle.to_tensor(np.arange(24, dtype=np.float32)
                          .reshape(4, 6))).sum().backward()
    jx = P.to_tensor(X3, stop_gradient=False)
    jy = jx * 2.0
    P.transpose_(jy, [2, 0, 1])
    P.reshape_(jy, [4, 6])
    (jy * P.to_tensor(np.arange(24, dtype=np.float32)
                      .reshape(4, 6))).sum().backward()
    compare(y, jy)
    compare(x.grad, jx.grad)


def test_inplace_departures_raise_torchs_error():
    """The two cases torch's autograd refuses (ROADMAP.md Queue C): an
    in-place op on a leaf that requires grad, and on a tensor an earlier
    op saved for its backward (the backward raises)."""
    leaf = paddle.to_tensor(X, stop_gradient=False)
    with pytest.raises(RuntimeError, match="leaf Variable"):
        paddle.add_(leaf, 1.0)
    # the JAX package takes both
    jleaf = P.to_tensor(X, stop_gradient=False)
    P.add_(jleaf, 1.0)
    x = paddle.to_tensor(X, stop_gradient=False)
    h = x * 1.0
    saved = h * h          # mul saves h
    paddle.add_(h, 1.0)
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        saved.sum().backward()
    # under no_grad a leaf takes the write (as the refills do)
    with paddle.no_grad():
        paddle.add_(leaf, 1.0)
    np.testing.assert_allclose(as_np(leaf), X + 1.0)


# ------------------------------------------------------- the refills
NORMAL_TOL = 1e-5
REFILLS = [("uniform_", {"min": -2.0, "max": 3.0}, 0),
           ("bernoulli_", {"p": 0.3}, 0),
           ("geometric_", {"probs": 0.3}, 0),
           ("fill_", {"value": 2.5}, 0), ("zero_", {}, 0),
           ("exponential_", {"lam": 1.5}, 2),
           ("cauchy_", {"loc": 0.5, "scale": 2.0}, 4),
           ("normal_", {"mean": 0.5, "std": 2.0}, NORMAL_TOL),
           ("log_normal_", {"mean": 0.2, "std": 0.5}, NORMAL_TOL)]


@pytest.mark.parametrize("name,kwargs,bound", REFILLS)
def test_refill_draws_the_reference_bits(name, kwargs, bound):
    """The same seed gives the JAX package's values: bit for bit where the
    value is the uniform bits (``uniform_``, ``bernoulli_``,
    ``geometric_`` after its ceil); within ``bound`` float32 ulps (at the
    scale of max(|value|, 1)) after ``log``/``tan``; after ``erfinv``
    (``normal_``, ``log_normal_``) within 1e-5 of the largest magnitude,
    the bound of the normal creation ops (``torch.erfinv`` and XLA's part
    in the last place, which the tails magnify). The receiver's history
    is cut (no ``grad_fn``), its ``requires_grad`` kept."""
    from paddle_tpu.ops import inplace as jin
    shape = (64, 33)
    P.seed(11)
    j = P.to_tensor(np.zeros(shape, np.float32))
    getattr(jin, name)(j, **kwargs)
    paddle.seed(11)
    base = paddle.to_tensor(np.zeros(shape, np.float32), stop_gradient=False)
    t = base * 1.0
    out = getattr(paddle, name)(t, **kwargs)
    assert out is t and t.grad_fn is None and t.requires_grad
    g, w = as_np(t), as_np(j)
    if bound == 0:
        np.testing.assert_array_equal(g, w)
    elif bound == NORMAL_TOL:
        compare(t, j, NORMAL_TOL)
    else:
        spacing = np.spacing(np.maximum(np.abs(w), 1.0).astype(np.float32))
        assert np.all(np.abs(g - w) <= bound * spacing), name
    # the next draw continues the same key walk on both sides
    np.testing.assert_array_equal(as_np(paddle.rand([5])),
                                  np.asarray(P.rand([5]).value))


def test_refill_bits_on_the_host_walk_equal_the_uniform_op():
    """``uniform_`` hashes on the receiver's device with the creation
    ``uniform``'s walk: the same call after the same seed."""
    paddle.seed(5)
    a = paddle.uniform_(paddle.zeros([7, 9]), min=-1.0, max=1.0)
    paddle.seed(5)
    b = paddle.uniform([7, 9], min=-1.0, max=1.0)
    np.testing.assert_array_equal(as_np(a), as_np(b))


def test_registry_names_match_the_reference():
    """Every op the JAX registry records from ``extra``, ``tail`` and
    ``inplace`` (the in-place variants and refills included) is in the
    port's registry under the same name."""
    from paddle_tpu.ops import inplace as jin
    from paddle_tpu.ops._op import OP_REGISTRY as JREG
    from paddle_tpu_torch.ops import OP_REGISTRY as TREG
    mods = {f"paddle_tpu.ops.{m}" for m in ("extra", "tail", "inplace")}
    want = {n for n, f in JREG.items()
            if getattr(getattr(f, "raw_fn", f), "__module__", "") in mods}
    want |= set(jin.__all__) - {"graph_alias"}
    want |= {"bitwise_invert", "one_hot"}
    assert want <= set(TREG), sorted(want - set(TREG))
