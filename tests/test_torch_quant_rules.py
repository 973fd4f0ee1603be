"""The quantization rules of the port's quantized serving, bit for bit the
JAX package's on the same float32 input, on the CPU.

- ``quantize_kv_rows`` (int8, per row and KV head) and
  ``quantize_kv_rows_fp8`` (saturating e4m3): data and scales equal,
  with all-zero rows, values exactly at the rounding midpoints, at ±448
  and far beyond;
- ``quantize_weight_int8`` (both contraction axes, 8 and 4 bits) and
  ``quantize_collective_int8`` (per row);
- ``quantize_decode_params`` on ``llama_tiny``'s stacked weights, tied and
  untied heads, and the dequantized head ``_dq_head``;
- the block pool's storage, planes and byte counts, and the prefill
  writers that quantize on write through a block table (padding rows and
  a sentinel tail never written; an fp8 pool's planes never touched).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jllama
from paddle_tpu.quantization import quantize_collective_int8 as j_qcoll
from paddle_tpu.quantization import quantize_weight_int8 as j_qweight
from paddle_tpu.serving import decode as jdec
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.serving.block_manager import BlockManager as JBlockManager
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.quantization import (quantize_collective_int8,
                                           quantize_weight_int8)
from paddle_tpu_torch.serving import decode as tdec
from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.serving.block_manager import BlockManager
from torch_threads import one_torch_thread  # noqa: F401


def _rows(seed, shape=(5, 7, 4, 16)):
    """K/V-like rows with an all-zero row, a row whose values sit on the
    int8 rounding midpoints, huge and tiny rows."""
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * 3).astype(np.float32)
    x[0, 0] = 0.0                                   # all-zero rows
    x[1, 0, 0] = np.arange(16) * (127.0 / 15) - 63.5 * (127.0 / 127)
    x[1, 1, 0] = (np.arange(16) - 8) + 0.5          # halves after scaling
    x[1, 1, 0, 0] = 127.0
    x[2, 0] *= 1e6                                  # far past 448
    x[2, 1] *= 1e-30                                # subnormal territory
    return x


def _np(t):
    return np.asarray(t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn
                      else t)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_kv_rows_bitwise(seed):
    x = _rows(seed)
    jq, js = jkv.quantize_kv_rows(jnp.asarray(x))
    tq, ts = tkv.quantize_kv_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts[0, 0] == 0).all() and (tq[0, 0] == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_kv_rows_fp8_bitwise(seed):
    x = _rows(seed)
    x[3, 0, 0, :6] = [448.0, -448.0, 449.0, 464.0, 1e4, -3e38]
    x[3, 0, 1, :4] = [2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11, -2.0 ** -7]
    want = np.asarray(jkv.quantize_kv_rows_fp8(jnp.asarray(x))).view(np.uint8)
    got = tkv.quantize_kv_rows_fp8(torch.from_numpy(x))
    assert got.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_np(got), want)
    assert tkv.FP8_MAX == jkv.FP8_MAX == 448.0
    assert got.float().abs().max() <= 448.0


@pytest.mark.parametrize("axis,bits", [(0, 8), (1, 8), (0, 4)])
def test_quantize_weight_int8_bitwise(axis, bits):
    w = np.random.RandomState(axis + bits).randn(24, 40).astype(np.float32)
    w[:, 3] = 0.0
    w[5, :] = 0.0
    jq, js = j_qweight(jnp.asarray(w), reduce_axis=axis, bits=bits)
    tq, ts = quantize_weight_int8(torch.from_numpy(w), reduce_axis=axis,
                                  bits=bits)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="2..8-bit"):
        quantize_weight_int8(torch.from_numpy(w), 0, bits=9)


def test_quantize_collective_int8_bitwise():
    x = _rows(5).reshape(35, 64)
    jq, js = j_qcoll(jnp.asarray(x))
    tq, ts = quantize_collective_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tuple(ts.shape) == (35, 1)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_quantize_decode_params_bitwise(tied):
    paddle.seed(3)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(
        num_hidden_layers=2, tie_word_embeddings=tied))
    p, jtied = jdec.llama_decode_params(jm)
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(
        num_hidden_layers=2, tie_word_embeddings=tied), device="cpu")
    tllama.load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()},
                              jtied)
    jq = jdec.quantize_decode_params(p, jtied)
    tp, ttied = tllama.llama_decode_params(tm)
    tq = tdec.quantize_decode_params(tp, ttied)
    for k in tdec._WEIGHT_QUANT_KEYS + ("lm_head",):
        for a, b in zip(tq[k], jq[k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in ("embed", "input_ln", "final_norm"):
        assert tq[k] is tp[k]
    want = np.asarray(jdec._dq_head(jq, jtied, jnp.float32))
    got = tdec._dq_head(tq, ttied, torch.float32)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    wa = jdec._dq_head(jq, jtied, jnp.float32, a8=True)
    ta = tdec._dq_head(tq, ttied, torch.float32, a8=True)
    for a, b in zip(ta, wa):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
def test_block_manager_storage_equals_jax(kv):
    j = JBlockManager(3, 6, 8, 2, 16, dtype=jnp.float32, kv_dtype=kv)
    t = BlockManager(3, 6, 8, 2, 16, dtype=torch.float32, kv_dtype=kv,
                     device="cpu")
    assert (t.block_nbytes, t.scale_block_nbytes) \
        == (j.block_nbytes, j.scale_block_nbytes)
    assert len(t.k) == 1                          # one shard
    assert tuple(t.k[0].shape) == tuple(j.k.shape)
    assert (t.quantized, t.fp8) == (j.quantized, j.fp8)
    if kv is None:
        assert t.k_scale is None and j.k_scale is None
    else:
        np.testing.assert_array_equal(t.k_scale[0].numpy(),
                                      np.asarray(j.k_scale))
        assert str(t.k[0].dtype).split(".")[-1].startswith(
            "int8" if kv == "int8" else "float8_e4m3fn")
    t.release()
    assert t.k is None and t.k_scale is None
    assert t.scale_block_nbytes == j.scale_block_nbytes
    with pytest.raises(ValueError, match="kv_dtype must be"):
        BlockManager(1, 2, 2, 1, 4, kv_dtype="int4", device="cpu")


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_prefill_writers_bitwise(kv):
    r = np.random.RandomState(11)
    L, nb, bs, Hkv, D, S = 2, 6, 8, 2, 16, 24
    pk = (r.randn(L, S, Hkv, D) * 50).astype(np.float32)
    pv = (r.randn(L, S, Hkv, D) * 50).astype(np.float32)
    table = np.array([4, 1, nb, nb], np.int32)     # sentinel past 2 blocks
    plen = 13
    j = JBlockManager(L, nb, bs, Hkv, D, kv_dtype=kv)
    t = BlockManager(L, nb, bs, Hkv, D, kv_dtype=kv, device="cpu")
    (tk,), (tv,), (tks,), (tvs,) = t.k, t.v, t.k_scale, t.v_scale  # 1 shard
    if kv == "int8":
        jk, jv, jks, jvs = jkv._paged_write_prefill_q(
            j.k, j.v, j.k_scale, j.v_scale, jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(table), np.int32(plen))
        tkv._paged_write_prefill_q(tk, tv, tks, tvs,
                                   torch.from_numpy(pk),
                                   torch.from_numpy(pv),
                                   torch.from_numpy(table), plen)
        np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
        np.testing.assert_array_equal(tvs.numpy(), np.asarray(jvs))
    else:
        jk, jv = jkv._paged_write_prefill_f8(
            j.k, j.v, jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
            np.int32(plen))
        tkv._paged_write_prefill_f8(tk, tv, torch.from_numpy(pk),
                                    torch.from_numpy(pv),
                                    torch.from_numpy(table), plen)
        assert (tks == 1).all() and (tvs == 1).all()
    for got, want in ((tk, jk), (tv, jv)):
        want = np.asarray(want)
        np.testing.assert_array_equal(
            _np(got), want.view(np.uint8) if kv == "fp8" else want)
    # padding rows past the prompt never land: block 1 rows 5.. untouched
    assert (_np(tk)[:, 1, plen - bs:] == 0).all()
