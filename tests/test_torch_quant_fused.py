"""The fused decode tick's quantized modes on the CPU (its plain version:
the scanned tick with the plain paged attention) against the JAX
package's ``fused_decode_tick_reference`` with the same quantized pools
and int8 weights, on ``llama_tiny`` (2 layers) with the JAX weights
carried across, float32.

An int8 pool (per-row scales) with int8 weight pairs, and an fp8 pool
(per-block planes) with int8 weights and without: tokens and keys equal,
logits within 1e-5, the appended int8 rows' data equal and their scales
within fp32 ``TOL`` (fp8 rows equal as values: a value the summation
order leaves a last-place sign apart casts to -0 in one and +0 in the
other), nothing written outside the appended rows, and an fp8 pool's
planes never touched. The JAX logits are read where its tick
hands them to its sampler.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from chip_smoke import TOL
from paddle_tpu.kernels.pallas_fused_decode_tick import \
    fused_decode_tick_reference as jax_tick
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import decode as jdec
from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
from paddle_tpu_torch.kernels import fused_decode_tick as tft
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.serving import decode as tdec
from paddle_tpu_torch.serving import kv_cache as tkv
from test_torch_fused_tick import EPS, HD, NH, NKV, THETA, _appended, \
    _tick_inputs
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def qmodels(request):
    tied = request.param
    paddle.seed(13)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(
        num_hidden_layers=2, tie_word_embeddings=tied))
    p, jtied = jdec.llama_decode_params(jm)
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(
        num_hidden_layers=2, tie_word_embeddings=tied), device="cpu")
    tllama.load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()},
                              jtied)
    return p, tm, tied


def _pools(pk, pv, mode):
    """float pools → (port pair, JAX pair) per side."""
    if mode == "int8":
        k = tkv.quantize_kv_rows(torch.from_numpy(pk))
        v = tkv.quantize_kv_rows(torch.from_numpy(pv))
        tj = [(jnp.asarray(d.numpy()), jnp.asarray(s.numpy()))
              for d, s in (k, v)]
        return k, v, tj
    L, nb, _, hkv, _ = pk.shape
    sc = np.random.RandomState(2).uniform(0.5, 2, (L, nb, hkv)).astype(
        np.float32)
    out = []
    for x in (pk, pv):
        d = tkv.quantize_kv_rows_fp8(torch.from_numpy(x))
        out.append((d, torch.from_numpy(sc.copy())))
    tj = [(jnp.asarray(d.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn),
           jnp.asarray(s.numpy())) for d, s in out]
    return out[0], out[1], tj


def _np(t):
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn
            else t).numpy()


CASES = {"int8_w8": ("int8", True), "fp8_w8": ("fp8", True),
         "fp8_dense": ("fp8", False)}


@pytest.mark.parametrize("rows", [3, 20], ids=["rows3", "rows20"])
@pytest.mark.parametrize("case", list(CASES))
def test_quantized_tick_matches_jax(qmodels, case, rows, monkeypatch):
    mode, w8 = CASES[case]
    p, tm, tied = qmodels
    pk, pv, tables, tok, lens, app, keys, temps, topks = _tick_inputs(
        seed=4, rows=rows)
    (tk, tv, (jk, jv)) = _pools(pk * 3, pv * 3, mode)
    k0, v0 = [tuple(t.clone() for t in side) for side in (tk, tv)]
    jp = jdec.quantize_decode_params(p, tied) if w8 else p
    tp, ttied = tllama.llama_decode_params(tm)
    if w8:
        tp = tdec.quantize_decode_params(tp, ttied)
    s_tot = tables.shape[1] * pk.shape[2]
    js, jc = jllama._rope_tables(s_tot, HD, THETA)
    seen = {}
    real = jdec.sample_rows

    def spy(logits, *a):
        seen["logits"] = np.asarray(logits)
        return real(logits, *a)
    monkeypatch.setattr(jdec, "sample_rows", spy)
    jnxt, jpk, jpv, jkeys = jax_tick(
        jp, tuple(jp[k] for k in jdec._STACK_KEYS),
        jdec._dq_head(jp, tied, jnp.float32), jnp.asarray(tables), js, jc,
        jnp.asarray(tok, jnp.int32), jk, jv, jnp.asarray(lens),
        jnp.asarray(keys, jnp.uint32), jnp.asarray(app), jnp.asarray(temps),
        jnp.asarray(topks), nh=NH, nkv=NKV, hd=HD, eps=EPS,
        decode_attn="jnp")
    ts, tc = tllama._rope_tables(s_tot, HD, THETA)
    reset_launches()
    with torch.inference_mode():
        nxt, opk, opv, tkeys, logits = tft.fused_decode_tick(
            tp, tdec._dq_head(tp, ttied, torch.float32), tables,
            torch.from_numpy(tables), ts, tc, torch.from_numpy(tok), tk, tv,
            lens, keys, app, temps, topks, nh=NH, nkv=NKV, hd=HD, eps=EPS,
            return_logits=True)
    assert LAUNCHES["fused_decode_tick"] == 0
    assert opk is tk and opv is tv
    assert nxt.tolist() == np.asarray(jnxt).tolist()
    assert (tdec._keys_host(tkeys).numpy()
            == np.asarray(jkeys).astype(np.int64)).all()
    np.testing.assert_allclose(logits.numpy(), seen["logits"], rtol=1e-5,
                               atol=1e-5)
    nb, bs = pk.shape[1], pk.shape[2]
    want = _appended(tables, lens, app, nb, bs)
    atol, rtol = TOL["float32"]
    for got, ref, before in ((tk, jpk, k0), (tv, jpv, v0)):
        data = _np(got[0])
        ref_data = np.asarray(ref[0])
        if mode == "fp8":
            ref_data = ref_data.view(np.uint8)
            assert torch.equal(got[1], before[1])    # planes never written
        changed = (data != _np(before[0])).any(axis=(0, 3, 4))
        assert set(zip(*map(list, np.nonzero(changed)))) <= want
        for b, r in want:
            if mode == "fp8":     # as values: a sum's last-place sign
                np.testing.assert_array_equal(   # may make -0 of +0
                    got[0][:, b, r].float().numpy(),
                    np.asarray(ref[0][:, b, r], np.float32))
            else:
                np.testing.assert_array_equal(data[:, b, r],
                                              ref_data[:, b, r])
            if mode == "int8":
                gs, ws = got[1][:, b, r].numpy(), np.asarray(ref[1])[:, b, r]
                assert (np.abs(gs - ws) <= atol + rtol * np.abs(ws)).all()
        np.testing.assert_array_equal(np.delete(data, [b for b, _ in want],
                                                axis=1),
                                      np.delete(ref_data,
                                                [b for b, _ in want], axis=1))


def test_a8_tick_is_the_scanned_tick(qmodels):
    """``fused=True`` with a8 runs the scanned tick (the reference's
    routing), with the same bits as asking for it."""
    p, tm, tied = qmodels
    pk, pv, tables, tok, lens, app, keys, temps, topks = _tick_inputs(5)
    tp, ttied = tllama.llama_decode_params(tm)
    tp = tdec.quantize_decode_params(tp, ttied)
    ts, tc = tllama._rope_tables(32, HD, THETA)
    head = tdec._dq_head(tp, ttied, torch.float32, a8=True)
    outs = []
    for fused in (True, False):
        tk, tv, _ = _pools(pk, pv, "int8")
        with torch.inference_mode():
            out = tdec._fused_decode_tick(
                [tp], head, tables, torch.from_numpy(tables), ts, tc,
                torch.from_numpy(tok), [tk], [tv], lens, keys, app, temps,
                topks, nh=NH, nkv=NKV, hd=HD, eps=EPS, fused=fused, a8=True,
                return_logits=True)
            outs.append((out[0], out[1][0], out[2][0]) + out[3:] + (tk, tv))
    for a, b in zip(*outs):
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        for x, y in zip(a, b):
            assert torch.equal(x, y)
