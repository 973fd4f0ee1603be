"""Quantized serving of the port's engine against the JAX engine with the
same knobs, on the CPU, on ``llama_tiny(decode_attention="jnp")`` with the
JAX weights carried across (float32).

The request matrix of ``tests/test_torch_engine.py`` (cold and chunked
prompts, an EOS inside a fused tick, a max-token cut, a cancel
mid-prefill and one mid-decode, greedy and seeded-sampled rows) runs
through both engines for every quantized knob set: ``kv_dtype`` int8 and
fp8 on the unified engine, ``quantize_weights`` on the unified, dense
and two-program engines, ``quantize_activations``, ``fused_tick`` with an
int8 pool and int8 weights, and ``decode_ticks=4`` on an int8 pool.
Streams and finish reasons must be IDENTICAL, and so must the compile
counts. A prefix-cache hit on an int8 pool carries the scale planes: a
second wave that hits streams exactly as the JAX engine's. The
validation errors are the reference's, and so are the pool's byte
accounting (``bytes_per_token``, ``occupancy_bytes``).
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving.decode import llama_decode_params
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           load_decode_params)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)
from test_torch_engine import GEOMETRY, _drive, _eos_inside_a_tick, _matrix
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def models():
    paddle.seed(21)
    jm = JLlama(j_tiny(decode_attention="jnp"))
    p, tied = llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


@pytest.fixture(scope="module")
def matrix(models):
    eos, _ = _eos_inside_a_tick(models[1])
    return _matrix(eos)


def _drive_both(models, matrix, knobs):
    jm, tm = models
    want, jeng = _drive(JEngine(jm, **GEOMETRY, **knobs), JRequest, matrix)
    got, eng = _drive(ContinuousBatchingEngine(tm, **GEOMETRY, **knobs),
                      GenerationRequest, matrix)
    return want, got, jeng, eng


KV_KNOBS = {"kv_int8": dict(kv_dtype="int8"),
            "kv_fp8": dict(kv_dtype="fp8"),
            "kv_int8_ticks4": dict(kv_dtype="int8", decode_ticks=4)}


@pytest.mark.parametrize("name", list(KV_KNOBS))
def test_quantized_pool_streams_equal_jax(models, matrix, name):
    want, got, jeng, eng = _drive_both(models, matrix, KV_KNOBS[name])
    assert got == want
    assert eng.kv_dtype == jeng.kv_dtype == KV_KNOBS[name]["kv_dtype"]
    assert (eng.decode_compilations(), eng.prefill_compilations()) \
        == (jeng.decode_compilations(), jeng.prefill_compilations())
    assert eng.cache.pool.num_free == eng.cache.pool.num_blocks
    if "decode_ticks" in KV_KNOBS[name]:
        for key in ("mtick_syncs", "mtick_ticks", "steps"):
            assert eng.stats[key] == jeng.stats[key], key


def test_int8_pool_holds_the_reference_bytes(models, matrix):
    """After the same traffic the int8 pool's data and scale planes equal
    the JAX engine's wherever a sequence wrote (the fp32 forward agrees
    to summation order, and the int8 grid absorbs it on these rows)."""
    jm, tm = models
    reqs = [r for r in matrix if not r[0].startswith("victim")][:3]
    jeng = JEngine(jm, **GEOMETRY, kv_dtype="int8")
    eng = ContinuousBatchingEngine(tm, **GEOMETRY, kv_dtype="int8")
    for e, R in ((jeng, JRequest), (eng, GenerationRequest)):
        for _, p, kw in reqs:
            e.submit(R(prompt=p, **kw))
        for _ in range(3):
            e.step()
    for e in (jeng, eng):
        assert e.cache.tables.tolist() == jeng.cache.tables.tolist()
    live = sorted({int(b) for b in eng.cache.tables.reshape(-1)
                   if b < eng.cache.pool.num_blocks})
    jq = np.asarray(jeng.cache.pool.k)[:, live]
    tq = eng.cache.pool.k[0][:, live].numpy()          # the one shard
    assert np.mean(jq == tq) > 0.999
    np.testing.assert_allclose(eng.cache.pool.k_scale[0][:, live].numpy(),
                               np.asarray(jeng.cache.pool.k_scale)[:, live],
                               rtol=1e-5, atol=1e-7)


def test_prefix_hit_on_int8_pool_carries_the_scales(models):
    """A first wave publishes a shared system prompt into the int8 pool's
    trie; a second wave hits it (the shared blocks' data AND scale planes
    read through the table): streams equal the JAX engine's, and the
    prefix stats too."""
    jm, tm = models
    sys_p = np.random.RandomState(7).randint(0, 256, 20).astype(np.int32)

    def req(tail_seed, n=6, **kw):
        tail = np.random.RandomState(tail_seed).randint(0, 256, n)
        kw.setdefault("max_new_tokens", 6)
        return dict(prompt=np.concatenate([sys_p, tail]).astype(np.int32),
                    **kw)

    geo = dict(GEOMETRY, prefix_cache=True, kv_dtype="int8")
    jeng, eng = JEngine(jm, **geo), ContinuousBatchingEngine(tm, **geo)
    for wave in ([req(1), req(2, 9)],
                 [req(3), req(4, temperature=0.8, top_k=5, seed=11),
                  req(5, 3)]):
        want = [o.tolist() for o in jeng.generate([JRequest(**r)
                                                   for r in wave])]
        got = [o.tolist() for o in eng.generate([GenerationRequest(**r)
                                                 for r in wave])]
        assert got == want
    assert eng.stats["prefill_tokens_saved"] \
        == jeng.stats["prefill_tokens_saved"] > 0
    assert eng.prefix_cache.stats == jeng.prefix_cache.stats


BAD = [
    (dict(kv_dtype="int4"), "kv_dtype must be"),
    (dict(kv_dtype="int8", ragged_step=False), "unified ragged"),
    (dict(kv_dtype="fp8", paged_attn=False), "unified ragged"),
    (dict(quantize_activations=True), "requires quantize_weights"),
    (dict(quantize_weights=True, quantize_activations=True,
          paged_attn=False), "unified ragged"),
    (dict(quantize_weights=True, quantize_activations=True,
          ragged_step=False), "unified ragged"),
]


@pytest.mark.parametrize("knobs,match", BAD,
                         ids=[f"bad{i}" for i in range(len(BAD))])
def test_invalid_compositions_raise_the_reference_errors(models, knobs,
                                                         match):
    jm, tm = models
    with pytest.raises(ValueError, match=match) as want:
        JEngine(jm, **GEOMETRY, **knobs)
    with pytest.raises(ValueError, match=match) as got:
        ContinuousBatchingEngine(tm, **GEOMETRY, **knobs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kv", ["int8", "fp8", None])
def test_byte_accounting_equals_jax(models, matrix, kv):
    jm, tm = models
    jeng = JEngine(jm, **GEOMETRY, kv_dtype=kv, prefix_cache=True)
    eng = ContinuousBatchingEngine(tm, **GEOMETRY, kv_dtype=kv,
                                   prefix_cache=True)
    for e, R in ((jeng, JRequest), (eng, GenerationRequest)):
        for _, p, kw in matrix[:3]:
            e.submit(R(prompt=p, **kw))
        e.step()
    assert eng.cache.bytes_per_token() == jeng.cache.bytes_per_token()
    assert eng.cache.occupancy_bytes() == jeng.cache.occupancy_bytes()
    assert (eng.cache.pool.block_nbytes, eng.cache.pool.scale_block_nbytes) \
        == (jeng.cache.pool.block_nbytes, jeng.cache.pool.scale_block_nbytes)


def test_shared_prefix_cache_checks_kv_dtype(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, **GEOMETRY, prefix_cache=True,
                                   kv_dtype="int8")
    with pytest.raises(ValueError, match="kv_dtype"):
        ContinuousBatchingEngine(tm, **GEOMETRY,
                                 prefix_cache=eng.prefix_cache)
    again = ContinuousBatchingEngine(tm, **GEOMETRY, kv_dtype="int8",
                                     prefix_cache=eng.prefix_cache)
    assert again.cache.pool is eng.cache.pool


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_gateway_quantized_surface_equals_jax(models, matrix, kv):
    """The gateway's quantized surface on a quantized pool: the
    ``kv_pool_bytes{kind="kv|scales"}`` and ``serving_kv_bytes_per_token``
    gauges and the profile document's ``kv_pool`` block equal the JAX
    gateway's after the same traffic (an int8 pool reports its scale
    planes, fp8 its per-block planes)."""
    from paddle_tpu.serving.server import ServingGateway as JGateway
    from paddle_tpu_torch.serving.server import ServingGateway
    from test_metrics_prom import parse_prometheus
    jm, tm = models
    knobs = dict(GEOMETRY, kv_dtype=kv, quantize_weights=True)
    got = {}
    for eng, Gw, R in ((ContinuousBatchingEngine(tm, **knobs),
                        ServingGateway, GenerationRequest),
                       (JEngine(jm, **knobs), JGateway, JRequest)):
        gw = Gw(eng, start=False)
        try:
            for _, p, kw in matrix[:2]:
                eng.submit(R(prompt=p, **kw))
            eng.step()
            fams = parse_prometheus(gw.registry.render())
            got[Gw] = (
                {k: v for k, v in fams["kv_pool_bytes"]["samples"].items()},
                fams["serving_kv_bytes_per_token"]["samples"][
                    ("serving_kv_bytes_per_token", ())],
                gw.profile_doc()["kv_pool"])
        finally:
            gw.shutdown(drain=False, timeout=10)
    assert got[ServingGateway] == got[JGateway]
    (pool_bytes, per_token, doc) = got[ServingGateway]
    assert doc["kv_dtype"] == kv and doc["quantize_weights"] is True
    scales = pool_bytes[("kv_pool_bytes", (("kind", "scales"),))]
    assert scales > 0 and per_token == doc["bytes_per_token"]
