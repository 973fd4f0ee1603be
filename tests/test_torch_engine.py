"""The port's ``ContinuousBatchingEngine`` against the JAX engine, on the
CPU, on ``llama_tiny(decode_attention="jnp")`` with its weights carried
across.

One request matrix runs through both engines with the same default
geometry (paged pool, unified ragged step, chunked prefill, fused decode
ticks) at test scale (3 slots, block 8, chunk 16) and the chunk grant
pinned at its cap (``headroom_mult=None``: the adaptive grant reads a
wall clock, which two engines cannot share). The matrix holds cold short
prompts, prompts longer than the chunk, an EOS inside a fused tick, a
max-token cut, a cancel mid-prefill and a cancel mid-decode. Greedy
streams and finish reasons must be IDENTICAL; the seeded-sampled stream
must be equal too (its random bits are exact; only a last-place rounding
of ``log`` could flip a near-tie draw, which these seeds do not hit).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving.decode import llama_decode_params
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           load_decode_params)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest, PoolExhausted)

GEOMETRY = dict(num_slots=3, max_seq_len=128, prefix_block_size=8,
                prefill_chunk=16, headroom_mult=None)


@pytest.fixture(scope="module")
def models():
    paddle.seed(21)
    jm = JLlama(j_tiny(decode_attention="jnp"))
    p, tied = llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


def _eos_inside_a_tick(tm):
    """An EOS id that request 'eos' meets at its 5th-or-later token (in
    the fused tail of a step), found from its greedy stream."""
    out = ContinuousBatchingEngine(tm, **GEOMETRY).generate(
        [GenerationRequest(prompt=_prompt(4, 9), max_new_tokens=12)])[0]
    toks = out.tolist()
    for i in range(4, len(toks)):
        if toks[i] not in toks[:i]:
            return toks[i], i
    pytest.skip("greedy stream repeats itself from the start")


def _matrix(eos):
    """(name, prompt, kwargs) in submission order: two long prompts first
    so the cancel lands mid-prefill."""
    return [
        ("long", _prompt(1, 45), dict(max_new_tokens=8)),
        ("victim_prefill", _prompt(2, 50), dict(max_new_tokens=5)),
        ("short", _prompt(3, 12), dict(max_new_tokens=10)),
        ("sampled", _prompt(5, 20), dict(max_new_tokens=9, temperature=0.8,
                                         top_k=5, seed=7)),
        ("eos", _prompt(4, 9), dict(max_new_tokens=12, eos_token_id=eos)),
        ("one_token", _prompt(6, 7), dict(max_new_tokens=1)),
        ("victim_running", _prompt(7, 10), dict(max_new_tokens=30)),
        ("long_sampled", _prompt(8, 37), dict(max_new_tokens=6,
                                              temperature=1.1, seed=99)),
    ]


def _drive(engine, Request, matrix, fault_hook=None):
    engine.fault_hook = fault_hook
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
            for n, s in seqs.items()}, engine


@pytest.fixture(scope="module")
def runs(models):
    jm, tm = models
    eos, _ = _eos_inside_a_tick(tm)
    matrix = _matrix(eos)
    jax_out, _ = _drive(JEngine(jm, **GEOMETRY), JRequest, matrix)
    port_out, eng = _drive(ContinuousBatchingEngine(tm, **GEOMETRY),
                           GenerationRequest, matrix)
    return jax_out, port_out, eng, eos, matrix


class TestAgainstJaxEngine:
    def test_greedy_streams_identical(self, runs):
        jax_out, port_out, *_ = runs
        for name in ("long", "short", "eos", "one_token", "victim_running"):
            assert port_out[name][0] == jax_out[name][0], name

    def test_finish_reasons_identical(self, runs):
        jax_out, port_out, *_ = runs
        assert {n: r for n, (_, r) in port_out.items()} \
            == {n: r for n, (_, r) in jax_out.items()}

    def test_seeded_sampled_streams_equal(self, runs):
        jax_out, port_out, *_ = runs
        for name in ("sampled", "long_sampled"):
            assert port_out[name][0] == jax_out[name][0], name

    def test_eos_inside_a_fused_tick_stops(self, runs):
        _, port_out, eng, eos, _ = runs
        toks, reason = port_out["eos"]
        assert reason == "stop" and toks[-1] == eos and len(toks) < 12
        assert eng.stats["decode_steps"] > eng.stats["decode_calls"]

    def test_cuts_and_cancels(self, runs):
        _, port_out, eng, *_ = runs
        assert port_out["one_token"][1] == "length"
        assert len(port_out["one_token"][0]) == 1
        assert port_out["victim_prefill"] == ([], "cancelled")
        toks, reason = port_out["victim_running"]
        assert reason == "cancelled" and 3 <= len(toks) < 30
        assert eng.stats["cancelled"] == 2

    def test_chunked_prefill_rode_the_unified_step(self, runs):
        _, _, eng, *_ = runs
        assert eng.stats["prefill_chunks"] >= 6
        assert eng.stats["unified_steps"] == eng.stats["steps"]
        assert eng.cache.num_free == 3
        assert eng.cache.pool.num_free == eng.cache.pool.num_blocks


class TestEngineBehaviour:
    def test_decode_fusion_is_transparent(self, models, runs):
        """decode_chunk=1 (one tick per step) gives the same streams."""
        _, tm = models
        _, port_out, _, _, matrix = runs
        out, eng = _drive(ContinuousBatchingEngine(
            tm, decode_chunk=1, **GEOMETRY), GenerationRequest, matrix)
        for name in port_out:
            if not name.startswith("victim"):
                assert out[name] == port_out[name], name
        assert eng.stats["decode_steps"] == eng.stats["decode_calls"]

    def test_pool_exhaustion_preempts_and_recomputes(self, models, runs):
        """A PoolExhausted in the step body preempts the youngest sequence
        by recompute; every stream continues unchanged."""
        _, tm = models
        _, port_out, _, _, matrix = runs
        fired = []

        def hook(engine):
            if engine.stats["steps"] == 6 and not fired:
                fired.append(1)
                raise PoolExhausted()
        out, eng = _drive(ContinuousBatchingEngine(tm, **GEOMETRY),
                          GenerationRequest, matrix, fault_hook=hook)
        assert eng.stats["preemptions"] == 1
        for name in port_out:
            if not name.startswith("victim"):
                assert out[name] == port_out[name], name

    def test_deadline_expires(self, models):
        _, tm = models
        eng = ContinuousBatchingEngine(tm, **GEOMETRY)
        seq = eng.submit(GenerationRequest(prompt=_prompt(9, 5),
                                           max_new_tokens=50,
                                           timeout_s=1e-9))
        eng.step()
        assert seq.finish_reason == "timeout" and seq.tokens == []
        assert eng.stats["timeouts"] == 1

    def test_validate_rejects_bad_requests(self, models):
        _, tm = models
        eng = ContinuousBatchingEngine(tm, **GEOMETRY)
        for req in (GenerationRequest(prompt=[], max_new_tokens=1),
                    GenerationRequest(prompt=[1], max_new_tokens=0),
                    GenerationRequest(prompt=[1] * 120, max_new_tokens=9)):
            with pytest.raises(ValueError):
                eng.submit(req)
        with pytest.raises(TypeError):
            eng.submit("not a request")


# fused_tick and paged_attn are ported; what stays off the ported path for
# them is the fused tick's int8-pool mode and the dense engine's prefix
# cache (the case id is the first key)
KNOBS = [dict(prefix_cache=True), dict(spec_decode=True),
         dict(decode_ticks=4), dict(kv_dtype="int8"), dict(kv_dtype="fp8"),
         dict(quantize_weights=True), dict(quantize_activations=True),
         dict(tp=2), dict(host_tier_bytes=1 << 20),
         dict(priority_classes={"gold": 1}),
         dict(fused_tick=True, kv_dtype="int8"),
         dict(collective_overlap=True),
         dict(paged_attn=False, prefix_cache=True),
         dict(ragged_step=False)]


@pytest.mark.parametrize("knob", KNOBS, ids=lambda k: next(iter(k)))
def test_off_default_knobs_raise(models, knob):
    _, tm = models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousBatchingEngine(tm, **knob)


def test_priority_class_request_raises(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, **GEOMETRY)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.submit(GenerationRequest(prompt=[1, 2], priority_class="gold"))


@pytest.mark.cuda
def test_kernels_match_plain_versions_in_the_engine():
    """On a GPU: greedy streams with the CUDA kernels equal those with
    the plain versions (fp32, llama_tiny widths at head_dim 64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cfg = llama_tiny(hidden_size=256, num_attention_heads=4,
                     num_key_value_heads=2)
    model = LlamaForCausalLM(cfg, device="cuda", seed=5)
    outs = {}
    try:
        for use in (True, False):
            set_flags({"FLAGS_use_cuda_kernels": use})
            eng = ContinuousBatchingEngine(model, **GEOMETRY)
            outs[use] = [o.tolist() for o in eng.generate(
                [GenerationRequest(prompt=_prompt(s, n), max_new_tokens=8)
                 for s, n in ((1, 45), (2, 12), (3, 30))])]
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    assert outs[True] == outs[False]
