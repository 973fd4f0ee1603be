"""The two-program step (engine ``ragged_step=False``) of the port against
the JAX package, on the CPU, on ``llama_tiny`` (2 layers) with the JAX
model's weights carried across.

- the decode program: ``_paged_decode_steps_impl`` against JAX's within
  1e-5 (pools), tokens and keys equal, over running rows, a free slot
  (sentinel table) and a mid-prefill slot at the dead-slot clamp, whose
  appends drop;
- the engine: a mixed matrix (long prompts in chunks, a seeded-sampled
  request, an EOS, a one-token request, a cancel mid-prefill and one
  mid-decode) gives the JAX two-program engine's streams, finish reasons,
  chunk and decode counts and compile counts, and the unified engine's
  streams; a step with both a chunk and decode rows runs the pair (one
  suffix-program chunk call, one decode call); the dense engine ignores
  ``ragged_step``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving import decode as jdec
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           llama_decode_params,
                                           load_decode_params)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)
from paddle_tpu_torch.serving import decode as tdec
from torch_threads import one_torch_thread  # noqa: F401


GEOMETRY = dict(num_slots=3, max_seq_len=128, prefix_block_size=8,
                prefill_chunk=16, headroom_mult=None)
CONSTS = dict(nh=4, nkv=2, hd=16, eps=1e-5, theta=10000.0, tied=False)
ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    paddle.seed(21)
    jm = JLlama(j_tiny(num_hidden_layers=2, decode_attention="jnp"))
    p, tied = jdec.llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(num_hidden_layers=2), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, p, tm


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


# ------------------------------------------------------ the decode program
@pytest.mark.parametrize("n_steps", [1, 3])
def test_paged_decode_steps_match_jax(models, n_steps):
    """Rows 0 and 1 run at lengths 10 and 7 (row 1 sampled, crossing a
    block at tick 1); row 2 is a free slot (sentinel table, length 0);
    row 3 a mid-prefill slot at the dead-slot clamp (length = capacity)."""
    _, p, tm = models
    r = np.random.RandomState(8)
    nb, bs, mb = 10, 8, 4
    pk = r.randn(2, nb, bs, 2, 16).astype(np.float32)
    pv = r.randn(2, nb, bs, 2, 16).astype(np.float32)
    tables = np.full((4, mb), nb, np.int32)
    tables[0, :2] = [2, 6]
    tables[1, :2] = [4, 1]
    tables[3, :2] = [0, 9]
    tokens = np.array([5, 77, 0, 13], np.int32)
    lens = np.array([10, 7, 0, mb * bs], np.int32)
    keys = r.randint(0, 2 ** 31, (4, 2)).astype(np.int64)
    temps = np.array([0.0, 0.9, 0.0, 0.0], np.float32)
    topks = np.array([0, 6, 0, 0], np.int32)
    jout = jdec._paged_decode_steps_impl(
        p, jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
        jnp.asarray(tokens), jnp.asarray(lens),
        jnp.asarray(keys, jnp.uint32), jnp.asarray(temps),
        jnp.asarray(topks), n_steps=n_steps, decode_attn="jnp", **CONSTS)
    tp, _ = llama_decode_params(tm)
    tpk, tpv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    toks, opk, opv, tkeys = tdec._paged_decode_steps_impl(
        [tp], [tpk], [tpv], tables, tokens, lens, keys, temps, topks,
        n_steps=n_steps, **CONSTS)
    assert opk[0] is tpk and opv[0] is tpv
    for got, want in ((tpk, jout[1]), (tpv, jout[2])):
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= ATOL
    assert toks[:, :2].tolist() == np.asarray(jout[0])[:, :2].tolist()
    assert (tkeys.numpy() == np.asarray(jout[3]).astype(np.int64)).all()
    # the free slot and the clamped slot appended nothing
    changed = (tpk.numpy() != pk).any(axis=(0, 3, 4))
    assert not changed[[0, 9]].any()
    assert changed[6, 2:2 + n_steps].all()


# --------------------------------------------------------------- engines
def _matrix():
    return [("long", _prompt(1, 45), dict(max_new_tokens=8)),
            ("victim_prefill", _prompt(2, 50), dict(max_new_tokens=5)),
            ("short", _prompt(3, 12), dict(max_new_tokens=10)),
            ("sampled", _prompt(5, 20), dict(max_new_tokens=9,
                                             temperature=0.8, top_k=5,
                                             seed=7)),
            ("eos", _prompt(4, 9), dict(max_new_tokens=12,
                                        eos_token_id=None)),
            ("one_token", _prompt(6, 7), dict(max_new_tokens=1)),
            ("victim_running", _prompt(7, 10), dict(max_new_tokens=30))]


def _drive(engine, Request, matrix):
    seqs = {name: engine.submit(Request(prompt=p, **kw))
            for name, p, kw in matrix}
    steps = 0
    while engine.has_work():
        if steps == 1:
            assert seqs["victim_prefill"].status == "prefilling"
            engine.cancel(seqs["victim_prefill"])
        vr = seqs["victim_running"]
        if vr.status == "running" and len(vr.tokens) >= 3:
            engine.cancel(vr)
        engine.step()
        steps += 1
    return {n: (list(map(int, s.tokens)), s.finish_reason)
            for n, s in seqs.items()}


@pytest.fixture(scope="module")
def runs(models):
    jm, _, tm = models
    matrix = _matrix()
    # an EOS the 'eos' request meets inside its stream
    probe = ContinuousBatchingEngine(tm, **GEOMETRY).generate(
        [GenerationRequest(prompt=_prompt(4, 9), max_new_tokens=12)])[0]
    toks = probe.tolist()
    eos = next(t for i, t in enumerate(toks) if i >= 4 and t not in toks[:i])
    matrix[4][2]["eos_token_id"] = eos
    jeng = JEngine(jm, ragged_step=False, **GEOMETRY)
    port = ContinuousBatchingEngine(tm, ragged_step=False, **GEOMETRY)
    return (_drive(jeng, JRequest, matrix),
            _drive(port, GenerationRequest, matrix), jeng, port, matrix)


class TestEngine:
    def test_streams_equal_jax(self, runs):
        jax_out, port_out, *_ = runs
        assert port_out == jax_out
        assert port_out["eos"][1] == "stop"
        assert port_out["victim_prefill"] == ([], "cancelled")

    def test_counts_equal_jax(self, runs):
        _, _, jeng, port, _ = runs
        for key in ("decode_calls", "decode_steps", "prefill_chunks",
                    "chunk_tokens", "prefills", "prefill_tokens",
                    "cancelled", "unified_steps"):
            assert port.stats[key] == jeng.stats[key], key
        assert port.stats["unified_steps"] == 0
        assert (port.decode_compilations(), port.prefill_compilations()) \
            == (jeng.decode_compilations(), jeng.prefill_compilations())
        assert port.cache.pool.num_free == port.cache.pool.num_blocks

    def test_streams_equal_the_unified_step(self, models, runs):
        _, port_out, _, _, matrix = runs
        unified = _drive(ContinuousBatchingEngine(models[2], **GEOMETRY),
                         GenerationRequest, matrix)
        for name in port_out:
            if not name.startswith("victim"):
                assert unified[name] == port_out[name], name

    def test_mixed_step_runs_the_pair(self, models):
        """A step with a chunk to prefill and a slot decoding runs one
        chunk call (the paged suffix program) and one decode call."""
        tm = models[2]
        eng = ContinuousBatchingEngine(tm, ragged_step=False, **GEOMETRY)
        eng.submit(GenerationRequest(prompt=_prompt(3, 12),
                                     max_new_tokens=20))
        eng.step()
        eng.submit(GenerationRequest(prompt=_prompt(1, 60),
                                     max_new_tokens=2))
        calls = {}
        for name in ("_suffix_fn", "_decode_fn"):
            orig = getattr(eng, name)

            def counted(*a, _o=orig, _n=name):
                calls[_n] = calls.get(_n, 0) + 1
                return _o(*a)
            setattr(eng, name, counted)
        eng.step()     # admit the long prompt, no chunk yet
        calls.clear()
        eng.step()
        assert calls == {"_suffix_fn": 1, "_decode_fn": 1}
        assert eng.stats["prefill_chunks"] >= 1

    def test_dense_engine_ignores_ragged_step(self, models):
        tm = models[2]
        reqs = [GenerationRequest(prompt=_prompt(s, 11), max_new_tokens=5)
                for s in (1, 2)]
        outs = []
        for ragged in (True, False):
            eng = ContinuousBatchingEngine(tm, paged_attn=False,
                                           ragged_step=ragged, **GEOMETRY)
            assert not eng.ragged_step
            outs.append([o.tolist() for o in eng.generate(reqs)])
        assert outs[0] == outs[1]
