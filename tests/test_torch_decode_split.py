"""The dense-cache decode kernel's split-KV arithmetic, checked on the CPU
against the JAX reference.

``csrc/decode.cu`` runs paged decode's split-KV walk (``csrc/split_kv.cuh``)
over the dense cache ``[B, S_max, Hkv, D]``: key ``p`` of row ``b`` at row
``b * S_max + p``, which is the paged walk over ``B`` blocks of ``S_max``
rows with the table ``arange(B)[:, None]``, under the split rule with
capacity ``S_max``. So ``test_torch_paged_split.py``'s emulation of that
walk, given the cache so viewed, is the dense kernel's arithmetic; it must
sit within ``chip_smoke.py``'s ``TOL`` of the JAX
``decode_attention_reference`` (``paddle_tpu/kernels/pallas_decode.py:205``).
Inputs come from a numpy seed: lengths 0, 1, 31, 33, a split +- 1, 4093
and 4096 (``S_max``), NaN in every cache row past its length; G = 1 and 4,
D = 64 and 128, bf16 and fp32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL
from paddle_tpu.kernels.pallas_decode import \
    decode_attention_reference as jax_decode_reference
from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
from paddle_tpu_torch.kernels import decode as tdk
from paddle_tpu_torch.kernels import paged_decode as tpd
from paddle_tpu_torch.kernels import split_kv
from test_torch_paged_split import H100_SMS, _split_emulation

HKV, S_MAX = 2, 4096


def _lengths(B=8):
    sl = split_kv.split_len(B, HKV, S_MAX, H100_SMS)
    return np.array([0, 1, 31, 33, sl - 1, sl + 1, 4093, S_MAX], np.int32)


def _inputs(G, D, seed):
    """q [8, G*HKV, D], caches [8, S_MAX, HKV, D] with NaN past each
    row's length, lengths."""
    r = np.random.RandomState(seed)
    lengths = _lengths()
    q = r.randn(len(lengths), G * HKV, D).astype(np.float32)
    k = r.randn(len(lengths), S_MAX, HKV, D).astype(np.float32)
    v = r.randn(len(lengths), S_MAX, HKV, D).astype(np.float32)
    for b, n in enumerate(lengths):
        k[b, n:] = v[b, n:] = np.nan
    return q, k, v, lengths


def _as_pool(k_cache):
    """The dense cache as a pool of B blocks of S_max rows, and its table
    ``arange(B)[:, None]``."""
    B = k_cache.shape[0]
    return k_cache, torch.arange(B, dtype=torch.int32)[:, None]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
def test_split_emulation_within_tol_of_jax_reference(G, D, dtype):
    q, k, v, lengths = _inputs(G, D, seed=G * 1000 + D)
    jdt = getattr(jnp, dtype)
    want = jax_decode_reference(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                jnp.asarray(v, jdt), jnp.asarray(lengths))
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    pool_k, table = _as_pool(tk)
    got = _split_emulation(tq, pool_k, tv, table,
                           torch.from_numpy(lengths)).float()
    assert torch.isfinite(got).all()
    assert (got[0] == 0).all()                          # length 0
    atol, rtol = TOL[dtype]
    assert ((got - want).abs() <= atol + rtol * want.abs()).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_reference_over_the_dense_view_is_the_dense_reference(dtype):
    """The dense address is the paged one with table arange(B): the plain
    paged decode over the viewed cache equals the plain dense decode bit
    for bit."""
    q, k, v, lengths = (torch.from_numpy(x) for x in _inputs(4, 64, seed=3))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    pool_k, table = _as_pool(k)
    assert torch.equal(
        tpd.paged_decode_attention_reference(q, pool_k, v, table, lengths),
        tdk.decode_attention_reference(q, k, v, lengths))


def test_split_rule_at_the_smoke_geometry():
    """8 dense rows of 32 KV heads, S_max 4096: 832-key splits, 5 a row,
    as paged decode splits the same capacity."""
    sl = split_kv.split_len(8, 32, 4096, H100_SMS)
    assert sl == 832 and -(-4096 // sl) == 5
    assert sl == tpd.split_len(8, 32, 4096, H100_SMS)


def test_limits():
    tdk.check_limits(32, 32, 128)
    tdk.check_limits(32, 8, 256)
    with pytest.raises(NotImplementedError, match="head_dim 16"):
        tdk.check_limits(4, 2, 16)
    with pytest.raises(NotImplementedError, match="accumulator"):
        tdk.check_limits(32, 2, 256)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = [torch.from_numpy(x) for x in _inputs(4, 64, seed=8)]
    reset_launches()
    got = tdk.decode_attention(*args)
    assert LAUNCHES["decode"] == 0
    assert torch.equal(got, tdk.decode_attention_reference(*args))
