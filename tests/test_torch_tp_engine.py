"""The port's tensor-parallel engine (``tp=N``) against the JAX package's,
on the CPU: ``llama_tiny`` (GQA, 4 query heads over 2 KV heads) and its
MHA variant (4 over 4, for ``tp=4``), the JAX model's weights carried
across (every shard of the port on the CPU; the JAX engines shard over
the conftest's 8 virtual devices).

The reference's request matrix (``tests/test_tp.py``): greedy shorts, a
seeded-sampled row, a 40-token prompt that chunks, then a second pass of
the same traffic that hits the prefix trie. Streams and finish reasons of
the port's ``tp=2`` engine equal the JAX ``tp=2`` engine's and the port's
own ``tp=1`` engine's, and ``decode_compilations() == 1`` holds inclusive
of the sharded geometry; so do ``tp=4`` on the MHA model, the int8
collectives (port against JAX), the overlap schedule (equal to no
overlap), spec decode, ``decode_ticks=4``, an int8 pool and the fused
tick (the scanned tick, shard by shard), each against the same knobs at
``tp=1`` and on JAX. The jit keys carry the reference's ``("tp2", dtype)``
tail.

Each JAX engine run is held in a module cache keyed by its knobs and its
request matrix. Every engine runs with the cost observatory on, and the
port's collective ledger equals the JAX engine's for each knob set.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.profiler.cost import CostObservatory as JCost
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving import decode as jdec
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           load_decode_params)
from paddle_tpu_torch.profiler.cost import CostObservatory
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)

from torch_threads import one_torch_thread  # noqa: F401

BS = 8       # KV block size
CHUNK = 16   # chunked-prefill budget (2 blocks)


def _pair(seed, **cfg):
    paddle.seed(seed)
    jm = JLlama(j_tiny(decode_attention="jnp", **cfg))
    p, tied = jdec.llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(**cfg), device="cpu", seed=0)
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair(33)


@pytest.fixture(scope="module")
def mha_models():
    return _pair(34, num_key_value_heads=4)


def _geo(**kw):
    # the chunk grant pinned at its cap: the adaptive grant reads a wall
    # clock, which two engines cannot share
    g = dict(num_slots=2, max_seq_len=96, decode_chunk=1,
             prefix_block_size=BS, prefill_chunk=CHUNK, headroom_mult=None)
    g.update(kw)
    return g


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n,)).astype(np.int32)


def _traffic():
    """The reference's matrix: greedy shorts, a seeded-sampled row, a
    long prompt that chunks (40 > CHUNK)."""
    return [dict(prompt=_prompt(1, 12), max_new_tokens=5),
            dict(prompt=_prompt(2, 10), max_new_tokens=5),
            dict(prompt=_prompt(3, 12), max_new_tokens=5, temperature=0.9,
                 top_k=5, seed=123),
            dict(prompt=_prompt(4, 40), max_new_tokens=4)]


def _engine(models, side, **kw):
    jm, tm = models
    if side == "jax":
        geo = sorted((k, str(v)) for k, v in kw.items())
        kw.setdefault("jit_cache", jm.__dict__.setdefault(f"_jit_{geo}", {}))
        return JEngine(jm, **_geo(**kw))
    return ContinuousBatchingEngine(tm, **_geo(**kw))


def _matrix(models, side, **kw):
    """Two passes of the traffic through one prefix-caching engine (pass
    2 hits pass 1's donated chains), the cost observatory on. Returns
    (streams, finish reasons, engine)."""
    Request = JRequest if side == "jax" else GenerationRequest
    eng = _engine(models, side, prefix_cache=True, **kw)
    eng.cost = (JCost if side == "jax" else CostObservatory)()
    streams, reasons = [], []
    for _ in range(2):
        seqs = [eng.submit(Request(**r)) for r in _traffic()]
        while eng.has_work():
            eng.step()
        streams += [list(map(int, s.output_ids())) for s in seqs]
        reasons += [s.finish_reason for s in seqs]
    return streams, reasons, eng


_JAX = {}


def _jax(models, **kw):
    key = (id(models[0]), tuple(sorted((k, str(v)) for k, v in kw.items())))
    if key not in _JAX:
        s, r, eng = _matrix(models, "jax", **kw)
        _JAX[key] = (s, r, eng.decode_compilations(), eng.cost.collectives)
    return _JAX[key]


def _tp1(knob):
    return {k: v for k, v in knob.items()
            if k not in ("tp", "collective_dtype", "collective_overlap")}


@pytest.mark.parametrize("knob", [
    dict(tp=2), dict(tp=2, collective_dtype="int8"),
    dict(tp=2, spec_decode=True, spec_k=3), dict(tp=2, decode_ticks=4),
    dict(tp=2, kv_dtype="int8"), dict(tp=2, fused_tick=True,
                                      decode_ticks=4)],
    ids=["tp2", "int8_collectives", "spec", "decode_ticks", "int8_pool",
         "fused_tick"])
def test_streams_equal_jax_and_tp1(models, knob):
    """The port's sharded engine equals the JAX engine with the same knobs
    and the port's tp=1 engine (the int8 all-reduce is lossy, so its
    streams are held to JAX's and, on this model, to tp=1's too), token
    for token with the same finish reasons; one decode program each; its
    collective ledger is the JAX engine's, ops and bytes (the multi-tick
    engine counts the tail ticks the reference's while_loop ran, the
    speculative one a packed verify a step)."""
    want, reasons, j_compiles, j_ledger = _jax(models, **knob)
    got, got_reasons, eng = _matrix(models, "port", **knob)
    assert (got, got_reasons) == (want, reasons)
    assert eng.cost.collectives == j_ledger and j_ledger
    assert eng.decode_compilations() == j_compiles == 1
    assert eng.prefill_compilations() >= 1
    assert eng.tp == 2 and len(eng.tp_devices) == 2
    assert eng.collective_dtype == knob.get("collective_dtype", "fp")
    base, base_reasons, _ = _matrix(models, "port", **_tp1(knob))
    assert (got, got_reasons) == (base, base_reasons)


def test_tp4_on_the_mha_model(mha_models):
    """tp=4 (4 KV heads, one a shard) equals JAX tp=4 and the port's
    tp=1."""
    want, reasons, _, j_ledger = _jax(mha_models, tp=4)
    got, got_reasons, eng = _matrix(mha_models, "port", tp=4)
    assert (got, got_reasons) == (want, reasons)
    assert eng.cost.collectives == j_ledger
    assert eng.decode_compilations() == 1
    base, base_reasons, _ = _matrix(mha_models, "port")
    assert (got, got_reasons) == (base, base_reasons)


@pytest.mark.parametrize("dtype", ["fp", "int8"])
def test_overlap_equals_no_overlap(models, dtype):
    """collective_overlap=True (the row-chunked schedule, fp on its ring)
    gives the unchunked schedule's streams at tp=2, and JAX's overlap
    engine's."""
    plain, plain_reasons, _ = _matrix(models, "port", tp=2,
                                      collective_dtype=dtype)
    got, got_reasons, eng = _matrix(models, "port", tp=2,
                                    collective_dtype=dtype,
                                    collective_overlap=True)
    assert (got, got_reasons) == (plain, plain_reasons)
    assert eng.collective_overlap
    if dtype == "fp":
        want, reasons, _, j_ledger = _jax(models, tp=2,
                                          collective_overlap=True)
        assert (got, got_reasons) == (want, reasons)
        assert eng.cost.collectives == j_ledger


def test_pools_equal_bit_for_bit_under_overlap(models):
    """At tp=2 the fp ring adds each element once, as the plain sum does,
    and row chunks change no row: the overlapped engine's pool shards
    equal the plain engine's bit for bit after the same traffic."""
    _, _, plain = _matrix(models, "port", tp=2)
    _, _, over = _matrix(models, "port", tp=2, collective_overlap=True)
    for a, b in zip(plain.cache.pool.k + plain.cache.pool.v,
                    over.cache.pool.k + over.cache.pool.v):
        assert bool((a == b).all())


def test_jit_keys_carry_the_tp_tag(models):
    """The degree and wire dtype join every program key of a sharded
    engine (the reference's ``("tp2", dtype)`` tail, then ``"ov"`` under
    overlap), tp=1 keys stay untagged, and each engine sharing the cache
    counts only its own programs."""
    jit = {}
    req = [GenerationRequest(**dict(_traffic()[0], max_new_tokens=2))]
    e1 = _engine(models, "port", jit_cache=jit)
    e1.generate(req)
    keys1 = set(jit)
    assert all("tp2" not in k for k in keys1)
    e2 = _engine(models, "port", tp=2, jit_cache=jit)
    e2.generate(req)
    keys2 = set(jit) - keys1
    assert keys2 and all(k[-2:] == ("tp2", "fp") for k in keys2)
    e3 = _engine(models, "port", tp=2, collective_overlap=True,
                 jit_cache=jit)
    e3.generate(req)
    keys3 = set(jit) - keys1 - keys2
    assert keys3 and all(k[-3:] == ("tp2", "fp", "ov") for k in keys3)
    assert e1.decode_compilations() == e2.decode_compilations() == 1
    assert e3.decode_compilations() == 1
