"""Parity of the port's fused decode tick (engine ``fused_tick=True``) with
the JAX package, on the CPU.

- The tick itself: the port's ``fused_decode_tick`` on CPU tensors (its
  plain version: the scanned tick with the plain paged attention) against
  the JAX ``_fused_tick_pallas`` in interpret mode, on ``llama_tiny`` (2
  layers) with the JAX weights carried across, untied and tied heads, at
  3 rows and at 20 (above the 16 the kernel once took): sampled rows, a
  greedy row whose append hits a sentinel table entry, and masked idle
  rows. Tokens and keys exact; pools within 1e-6 (float32 summation
  order); only the live rows' appends change the pool.
- The engine: the default engine's request matrix
  (``tests/test_torch_engine.py``) through the port's and the JAX
  engine's ``fused_tick=True`` (JAX on its Pallas mega-kernel in interpret
  mode): greedy and seeded streams and finish reasons identical.
- The knob's errors: ``fused_tick`` needs the unified ragged paged engine.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels.pallas_fused_decode_tick import _fused_tick_pallas
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving import decode as jdec
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
from paddle_tpu_torch.kernels import fused_decode_tick as tft
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)
from paddle_tpu_torch.serving import decode as tdec
from test_torch_engine import GEOMETRY, _drive, _eos_inside_a_tick, _matrix

POOL_ATOL = 1e-6
NH, NKV, HD, EPS, THETA = 4, 2, 16, 1e-5, 10000.0


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def tick_models(request):
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


def _tick_inputs(seed=3, rows=3):
    """R=3 over a 6-block pool (bs 8, mb 4, sentinel 6): row 0 samples at
    length 10; row 1 is greedy at length 16, whose block 2 is unmapped, so
    its append drops; row 2 is idle (app_mask 0). With more rows the pool
    grows by 2 blocks a row and rows 3.. get seeded lengths 0..23 on their
    own blocks: every third one samples (top-k 3), every fifth is idle."""
    r = np.random.RandomState(seed)
    L, bs, D = 2, 8, HD
    nb = 6 + 2 * (rows - 3)
    tables = np.full((rows, 4), nb, np.int32)
    tables[0, :2] = [4, 1]
    tables[1, :2] = [0, 3]
    tok = np.zeros(rows, np.int64)
    tok[:3] = [17, 200, 0]
    lens = np.zeros(rows, np.int32)
    lens[:2] = [10, 16]
    app = np.ones(rows, np.int32)
    app[2] = 0
    temps = np.zeros(rows, np.float32)
    temps[0] = 0.9
    topks = np.zeros(rows, np.int32)
    topks[0] = 5
    for b in range(3, rows):
        tables[b, :2] = [6 + 2 * (b - 3), 7 + 2 * (b - 3)]
        tok[b] = r.randint(0, 256)
        lens[b] = r.randint(0, 24)
        app[b] = 0 if b % 5 == 0 else 1
        if b % 3 == 0:
            temps[b], topks[b] = 0.7, 3
    pk = r.randn(L, nb, bs, NKV, D).astype(np.float32)
    pv = r.randn(L, nb, bs, NKV, D).astype(np.float32)
    keys = r.randint(0, 2 ** 32, (rows, 2), dtype=np.uint64).astype(np.int64)
    return pk, pv, tables, tok, lens, app, keys, temps, topks


def _appended(tables, lens, app, nb, bs):
    """(block, row) pairs the live rows append to: masked rows, rows past
    capacity and sentinel table entries do not write."""
    out = set()
    for b in range(len(lens)):
        phys = tables[b, min(lens[b] // bs, tables.shape[1] - 1)]
        if app[b] and lens[b] < tables.shape[1] * bs and phys < nb:
            out.add((int(phys), int(lens[b] % bs)))
    return out


class TestFusedTick:
    @pytest.mark.parametrize("rows", [3, 20], ids=["rows3", "rows20"])
    def test_cpu_path_matches_jax_fused_kernel(self, tick_models, rows):
        p, tm, tied = tick_models
        pk, pv, tables, tok, lens, app, keys, temps, topks = _tick_inputs(
            rows=rows)
        s_tot = tables.shape[1] * pk.shape[2]
        js, jc = jllama._rope_tables(s_tot, HD, THETA)
        stack = tuple(p[k] for k in jdec._STACK_KEYS)
        jhead = jdec._dq_head(p, tied, p["embed"].dtype)
        jnxt, jpk, jpv, jkeys = _fused_tick_pallas(
            p, stack, jhead, jnp.asarray(tables), js, jc,
            jnp.asarray(tok, jnp.int32), jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(lens), jnp.asarray(keys, jnp.uint32),
            jnp.asarray(app), jnp.asarray(temps), jnp.asarray(topks),
            nh=NH, nkv=NKV, hd=HD, eps=EPS)
        tp, ttied = tllama.llama_decode_params(tm)
        assert ttied == tied
        ts, tc = tllama._rope_tables(s_tot, HD, THETA)
        tpk, tpv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
        reset_launches()
        with torch.inference_mode():
            nxt, opk, opv, tkeys = tft.fused_decode_tick(
                tp, tdec._head(tp, tied), tables, torch.from_numpy(tables),
                ts, tc, torch.from_numpy(tok), tpk, tpv, lens, keys, app,
                temps, topks, nh=NH, nkv=NKV, hd=HD, eps=EPS)
        assert LAUNCHES["fused_decode_tick"] == 0     # CPU: plain version
        assert opk is tpk and opv is tpv              # written in place
        assert nxt.tolist() == np.asarray(jnxt).tolist()
        assert (tdec._keys_host(tkeys).numpy()
                == np.asarray(jkeys).astype(np.int64)).all()
        for got, want in ((tpk, jpk), (tpv, jpv)):
            assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) \
                <= POOL_ATOL
        # the masked rows and the sentinel entry leave the pool untouched;
        # row 0 appends at block 1, row 2
        nb, bs = pk.shape[1], pk.shape[2]
        want = _appended(tables, lens, app, nb, bs)
        assert (1, 2) in want and len(want) >= 1 + (rows - 3) // 2
        for got in (tpk, tpv):
            changed = (got.numpy() != (pk if got is tpk else pv)).any(
                axis=(0, 3, 4))
            assert set(zip(*map(list, np.nonzero(changed)))) == want
        if rows > 3:
            assert (temps > 0).sum() > 2 and (app == 0).sum() > 1

    def test_reference_is_the_scanned_tick_with_plain_attention(
            self, tick_models):
        _, tm, tied = tick_models
        pk, pv, tables, tok, lens, app, keys, temps, topks = _tick_inputs(5)
        tp, _ = tllama.llama_decode_params(tm)
        ts, tc = tllama._rope_tables(32, HD, THETA)
        outs = []
        for fn in (tft.fused_decode_tick_reference, tdec._fused_decode_tick):
            tpk, tpv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
            with torch.inference_mode():
                out = fn(tp, tdec._head(tp, tied), tables,
                         torch.from_numpy(tables), ts, tc,
                         torch.from_numpy(tok), tpk, tpv, lens, keys, app,
                         temps, topks, nh=NH, nkv=NKV, hd=HD, eps=EPS,
                         return_logits=True)
            outs.append(out)
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        assert outs[0][4].dtype == torch.float32
        assert outs[0][4].shape == (3, tm.config.vocab_size)


# ---------------------------------------------------------- engine matrix
@pytest.fixture(scope="module")
def engine_models():
    paddle.seed(21)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny())   # Pallas decode
    p, tied = jdec.llama_decode_params(jm)
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(), device="cpu")
    tllama.load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()},
                              tied)
    return jm, tm


@pytest.fixture(scope="module")
def fused_runs(engine_models):
    jm, tm = engine_models
    eos, _ = _eos_inside_a_tick(tm)
    matrix = _matrix(eos)
    jax_out, _ = _drive(JEngine(jm, fused_tick=True, **GEOMETRY), JRequest,
                        matrix)
    port_out, eng = _drive(ContinuousBatchingEngine(
        tm, fused_tick=True, **GEOMETRY), GenerationRequest, matrix)
    return jax_out, port_out, eng, matrix


class TestFusedEngineAgainstJax:
    def test_greedy_streams_identical(self, fused_runs):
        jax_out, port_out, *_ = fused_runs
        for name in ("long", "short", "eos", "one_token", "victim_running"):
            assert port_out[name][0] == jax_out[name][0], name

    def test_seeded_sampled_streams_equal(self, fused_runs):
        jax_out, port_out, *_ = fused_runs
        for name in ("sampled", "long_sampled"):
            assert port_out[name][0] == jax_out[name][0], name

    def test_finish_reasons_identical(self, fused_runs):
        jax_out, port_out, *_ = fused_runs
        assert {n: r for n, (_, r) in port_out.items()} \
            == {n: r for n, (_, r) in jax_out.items()}

    def test_fused_ticks_ran(self, fused_runs):
        _, _, eng, _ = fused_runs
        assert eng.fused_tick
        assert eng.stats["decode_steps"] > eng.stats["decode_calls"]
        assert eng.cache.pool.num_free == eng.cache.pool.num_blocks

    def test_streams_equal_the_unfused_engine_and_the_flag_off(
            self, engine_models, fused_runs):
        """The fused engine serves the default engine's streams, and the
        same with ``FLAGS_use_cuda_kernels`` off (the plain versions)."""
        _, tm = engine_models
        _, port_out, _, matrix = fused_runs
        unfused, _ = _drive(ContinuousBatchingEngine(tm, **GEOMETRY),
                            GenerationRequest, matrix)
        try:
            set_flags({"FLAGS_use_cuda_kernels": False})
            off, _ = _drive(ContinuousBatchingEngine(
                tm, fused_tick=True, **GEOMETRY), GenerationRequest, matrix)
        finally:
            set_flags({"FLAGS_use_cuda_kernels": True})
        assert unfused == port_out and off == port_out


@pytest.mark.parametrize("knob", [dict(paged_attn=False),
                                  dict(ragged_step=False)],
                         ids=lambda k: next(iter(k)))
def test_fused_tick_needs_the_unified_ragged_paged_engine(engine_models,
                                                          knob):
    jm, tm = engine_models
    for Engine, m in ((JEngine, jm), (ContinuousBatchingEngine, tm)):
        with pytest.raises(ValueError, match="unified ragged paged"):
            Engine(m, fused_tick=True, **knob)
