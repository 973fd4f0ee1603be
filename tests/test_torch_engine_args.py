"""The port engine's constructor against the JAX engine's, on the CPU.

``ContinuousBatchingEngine`` takes the reference's argument list in the
reference's order (``paddle_tpu/serving/engine.py``); it serves the values
the port has and raises ``NotImplementedError`` naming the ROADMAP step
that ports each other one. ``LlamaConfig.decode_attention`` selects the
kernels (``"pallas"``) or their plain versions (``"jnp"``). While the
kernels are on, the constructor holds the model against every kernel the
chosen engine launches, so an engine the kernels cannot serve raises
before a request is admitted; on the CPU that check is reached by faking
the one function that says whether the kernels are on.
"""
import inspect
import types

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
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           llama_tiny, load_decode_params)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)
from paddle_tpu_torch.serving import decode as sdecode
from paddle_tpu_torch.serving import engine as sengine

GEOMETRY = dict(num_slots=3, max_seq_len=128, prefix_block_size=8,
                prefill_chunk=16, headroom_mult=None)


@pytest.fixture(scope="module")
def tiny():
    return LlamaForCausalLM(llama_tiny(num_hidden_layers=2), device="cpu",
                            seed=3)


def test_reference_arguments_in_the_reference_order():
    ours = list(inspect.signature(ContinuousBatchingEngine).parameters)
    ref = list(inspect.signature(JEngine).parameters)
    assert ours == ref


def test_served_values_by_keyword_and_by_position(tiny):
    kw = dict(prefill_bucketing="pow2", jit_cache=None, prefix_blocks=None,
              step_clock=None, spec_k=7, drafter=None, collective_dtype="fp")
    a = ContinuousBatchingEngine(tiny, **GEOMETRY, **kw)
    # model, num_slots, max_seq_len, decode_chunk, prefill_bucketing,
    # jit_cache, prefix_cache, prefix_blocks, prefix_block_size,
    # paged_attn, prefill_chunk, ragged_step, headroom_mult, step_clock,
    # spec_decode, spec_k, drafter, decode_ticks, kv_dtype,
    # quantize_weights, quantize_activations, tp, collective_dtype
    b = ContinuousBatchingEngine(tiny, 3, 128, 8, "pow2", None, False, None,
                                 8, True, 16, True, None, None, False, 7,
                                 None, 1, None, False, False, 1, "fp")
    for eng in (a, b):
        assert eng.num_slots == 3 and eng.max_seq_len == 128
        assert eng.cache.block_size == 8 and eng._chunk == 16
    req = [GenerationRequest(prompt=np.arange(20, dtype=np.int32),
                             max_new_tokens=5)]
    assert [o.tolist() for o in a.generate(req)] == \
        [o.tolist() for o in b.generate(req)]


def _served_exact_bucket(tiny):
    eng = ContinuousBatchingEngine(tiny, **GEOMETRY,
                                   prefill_bucketing="exact")
    assert [eng._bucket(n) for n in (1, 5, 9, 100)] == [1, 5, 9, 100]
    eng.generate([GenerationRequest(prompt=np.arange(13, dtype=np.int32),
                                    max_new_tokens=2)])
    sig, = eng._jit[("prefill",)].signatures
    assert sig[1] == ((1, 13), "int32")      # ids at the prompt's length


def _served_shared_jit_cache(tiny):
    jit = {}
    reqs = [GenerationRequest(prompt=np.arange(n, dtype=np.int32),
                              max_new_tokens=3) for n in (5, 20)]
    a = ContinuousBatchingEngine(tiny, **GEOMETRY, decode_chunk=1,
                                 jit_cache=jit)
    a.generate(reqs)
    counts = (a.decode_compilations(), a.prefill_compilations())
    assert counts[0] == 1
    b = ContinuousBatchingEngine(tiny, **GEOMETRY, decode_chunk=1,
                                 jit_cache=jit)
    b.generate(reqs)
    assert (b.decode_compilations(), b.prefill_compilations()) == counts


def _served_step_clock(tiny):
    ticks = iter(range(100, 10000))
    eng = ContinuousBatchingEngine(tiny, **GEOMETRY,
                                   step_clock=lambda: float(next(ticks)))
    seq = eng.submit(GenerationRequest(prompt=np.arange(6, dtype=np.int32),
                                       max_new_tokens=3))
    assert seq.t_submit == 100.0
    while eng.has_work():
        eng.step()
    # every stamp is a reading of the injected clock, one per step start
    stamps = (seq.t_admitted, seq.t_first_token, seq.t_finish)
    assert all(t == int(t) and 100 < t < 10000 for t in stamps)
    assert seq.ttft_s == seq.t_first_token - 100.0


def _served_prefix_blocks(tiny):
    """prefix_blocks sizes the trie's budget on top of the live grid of
    the paged pool, and the whole pool of the dense engine's trie."""
    eng = ContinuousBatchingEngine(tiny, **GEOMETRY, prefix_cache=True,
                                   prefix_blocks=4)
    live = 3 * (128 // 8)
    assert eng.cache.pool.num_blocks == live + 4
    assert eng.prefix_cache.max_blocks == 4
    dense = ContinuousBatchingEngine(tiny, **GEOMETRY, paged_attn=False,
                                     prefix_cache=True, prefix_blocks=4)
    assert dense.prefix_cache.pool.num_blocks == 4
    p = np.arange(20, dtype=np.int32)
    for e in (eng, dense):
        e.generate([GenerationRequest(prompt=p, max_new_tokens=2)])
        e.generate([GenerationRequest(prompt=p, max_new_tokens=2)])
        assert e.stats["prefill_tokens_saved"] == 16
    with pytest.raises(ValueError, match="prefix_blocks"):
        ContinuousBatchingEngine(tiny, **GEOMETRY, prefix_cache=True,
                                 prefix_blocks=0)


def _served_drafter(tiny):
    """A drafter is the speculative engine's; with speculation off it is
    ignored, as the reference ignores it."""
    from paddle_tpu_torch.serving.drafter import NgramDrafter
    d = NgramDrafter(max_ngram=2)
    eng = ContinuousBatchingEngine(tiny, **GEOMETRY, spec_decode=True,
                                   spec_k=7, drafter=d)
    assert eng.drafter is d and eng.spec_k == 7
    assert ContinuousBatchingEngine(tiny, **GEOMETRY,
                                    drafter=d).drafter is None
    eng.generate([GenerationRequest(prompt=np.arange(9, dtype=np.int32),
                                    max_new_tokens=3)])
    assert eng.stats["spec_steps"] > 0


@pytest.mark.parametrize("check", [_served_exact_bucket,
                                   _served_shared_jit_cache,
                                   _served_step_clock,
                                   _served_prefix_blocks,
                                   _served_drafter],
                         ids=["prefill_bucketing", "jit_cache",
                              "step_clock", "prefix_blocks", "drafter"])
def test_once_unported_values_are_served(tiny, check):
    """prefill_bucketing="exact", a shared jit_cache and step_clock were
    refused until the front door was ported, prefix_blocks until the
    prefix cache was, a drafter until spec decode was; each is served
    now."""
    check(tiny)


@pytest.mark.parametrize("knob", [dict(prefill_bucketing="none"),
                                  dict(collective_dtype="bf16")])
def test_invalid_values_raise_as_the_reference_does(tiny, knob):
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(tiny, **GEOMETRY, **knob)


def test_decode_attention_is_validated():
    assert LlamaConfig().decode_attention == "pallas"
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1,
                                    decode_attention="triton"),
                         device="cpu", seed=0)
    with pytest.raises(ValueError, match="decode_attention"):
        ContinuousBatchingEngine(m, **GEOMETRY)


def _poison(monkeypatch):
    """Make every kernel wrapper the serving programs can pick raise."""
    def boom(*a, **k):
        raise AssertionError("a kernel wrapper ran")
    for name in ("_attention", "paged_decode_attention",
                 "ragged_paged_attention", "decode_attention",
                 "fused_decode_tick"):
        monkeypatch.setattr(sdecode, name, boom)


@pytest.mark.parametrize("knob", [{}, dict(fused_tick=True),
                                  dict(paged_attn=False)],
                         ids=["default", "fused_tick", "dense"])
def test_jnp_selects_the_plain_versions(monkeypatch, knob):
    """With decode_attention="jnp" no kernel wrapper is reached, on each
    engine, while the flag stays on; with "pallas" they are."""
    _poison(monkeypatch)
    req = [GenerationRequest(prompt=np.arange(30, dtype=np.int32) % 256,
                             max_new_tokens=4)]
    jnp_model = LlamaForCausalLM(llama_tiny(num_hidden_layers=1,
                                            decode_attention="jnp"),
                                 device="cpu", seed=1)
    ContinuousBatchingEngine(jnp_model, **GEOMETRY, **knob).generate(req)
    pallas_model = LlamaForCausalLM(llama_tiny(num_hidden_layers=1),
                                    device="cpu", seed=1)
    with pytest.raises(AssertionError, match="kernel wrapper"):
        ContinuousBatchingEngine(pallas_model, **GEOMETRY,
                                 **knob).generate(req)


def test_jnp_greedy_streams_equal_the_jax_engine():
    paddle.seed(5)
    jm = JLlama(j_tiny(decode_attention="jnp"))
    p, tied = llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(decode_attention="jnp"), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    prompts = [np.random.RandomState(s).randint(0, 256, n).astype(np.int32)
               for s, n in ((1, 40), (2, 9), (3, 21))]
    want = JEngine(jm, **GEOMETRY).generate(
        [JRequest(prompt=x, max_new_tokens=10) for x in prompts])
    got = ContinuousBatchingEngine(tm, **GEOMETRY).generate(
        [GenerationRequest(prompt=x, max_new_tokens=10) for x in prompts])
    assert [list(map(int, o)) for o in got] == \
        [list(map(int, np.asarray(o))) for o in want]


def test_kernels_on_reads_the_flag_the_config_and_the_device():
    cuda = {"embed": types.SimpleNamespace(device=torch.device("cuda"))}
    cpu = {"embed": torch.zeros(1)}
    pallas, jnp_cfg = llama_tiny(), llama_tiny(decode_attention="jnp")
    assert sengine._kernels_on(cuda, pallas)
    assert not sengine._kernels_on(cpu, pallas)
    assert not sengine._kernels_on(cuda, jnp_cfg)
    try:
        set_flags({"FLAGS_use_cuda_kernels": False})
        assert not sengine._kernels_on(cuda, pallas)
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})


@pytest.mark.parametrize("cfg,knob,match", [
    # a head dim that is not a multiple of 8 (12): the flash forward (cold
    # prefill) refuses it first, naming Queue C 7's rest
    (dict(hidden_size=48), {}, "flash kernel: head_dim 12"),
    (dict(hidden_size=48), dict(paged_attn=False),
     "flash kernel: head_dim 12"),
    # llama_tiny's head dim 16, refused before Queue C 7: every engine
    # constructs
    (dict(), {}, None),
    (dict(), dict(paged_attn=False), None),
    (dict(), dict(fused_tick=True), None),
    # the fused tick takes any row count: 17 and 64 slots construct
    (dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2),
     dict(fused_tick=True, num_slots=17), None),
    # ... and widths that are multiples of 64 (its GEMV tiles)
    (dict(hidden_size=192, num_attention_heads=3, num_key_value_heads=3,
          intermediate_size=96),
     dict(fused_tick=True), "fused tick kernel: hidden 192, intermediate 96"),
    # 32 query heads of 128 over one KV head overflow the split-KV walk's
    # accumulator (dense decode; paged decode and ragged alike)
    (dict(hidden_size=4096, num_attention_heads=32, num_key_value_heads=1),
     dict(paged_attn=False), "decode kernel: 32 query heads"),
    (dict(hidden_size=4096, num_attention_heads=32, num_key_value_heads=1),
     {}, "ragged attention kernel: 32 query heads"),
], ids=["flash_default", "flash_dense", "tiny_default", "tiny_dense",
        "tiny_fused", "fused_rows", "fused_width", "dense_group",
        "ragged_group"])
def test_kernel_limits_raise_at_construction(monkeypatch, cfg, knob, match):
    """Each case raises naming the kernel limit it meets, with the kernels
    on; a case without a match names a limit that was lifted, and the
    engine constructs (``fused_rows``: the fused tick at 17 and 64
    slots, beyond the 16 rows it once took)."""
    monkeypatch.setattr(sengine, "_kernels_on", lambda params, config: True)
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1,
                                    **dict(dict(intermediate_size=64), **cfg)),
                         device="cpu", seed=0)
    if match is None:
        slots_list = (knob["num_slots"], 64) if "num_slots" in knob \
            else (GEOMETRY["num_slots"],)
        for slots in slots_list:
            eng = ContinuousBatchingEngine(
                m, **dict(GEOMETRY, **dict(knob, num_slots=slots)))
            assert eng.fused_tick == bool(knob.get("fused_tick"))
            assert eng.num_slots == slots
        return
    with pytest.raises(NotImplementedError, match=match):
        ContinuousBatchingEngine(m, **dict(GEOMETRY, **knob))


def test_kernel_limits_pass_for_a_geometry_the_kernels_take(monkeypatch):
    monkeypatch.setattr(sengine, "_kernels_on", lambda params, config: True)
    m = LlamaForCausalLM(llama_tiny(num_hidden_layers=1, hidden_size=256,
                                    num_attention_heads=4,
                                    num_key_value_heads=2),
                         device="cpu", seed=0)
    for knob in ({}, dict(fused_tick=True, num_slots=16),
                 dict(paged_attn=False)):
        ContinuousBatchingEngine(m, **dict(GEOMETRY, **knob))
