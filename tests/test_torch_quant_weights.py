"""int8 weights (``quantize_weights``) and int8 x int8 projections
(``quantize_activations``) of the port's engines against the JAX engine
with the same knobs, on the CPU, on ``llama_tiny(decode_attention="jnp")``
with the JAX weights carried across (float32).

The request matrix of ``tests/test_torch_engine.py`` runs through the
unified engine (with w8, with w8 + a8, with ``fused_tick`` over an int8
pool and int8 weights, with ``fused_tick`` over an fp8 pool, the fused
multi-tick tail over both, and with a8 + ``fused_tick``, which the
reference routes to the scanned tick), the
two-program engine and the dense engine (w8): greedy and seeded-sampled
streams and finish reasons IDENTICAL, compile counts equal.

a8 over an int8 pool is held against the port's own engines, not JAX's:
there both quantizers re-round what the two frameworks' float32 sums
leave at the last place, and one stream of the matrix parts from JAX's at
its sixth token (a layer's K row one int8 step apart on 8 of 32 values).
The fused a8 engine over that pool must equal the unified a8 engine over
it token for token: the reference's routing (an a8 tick is the scanned
tick).

The converted parameters are made once a model and shared by every engine
over it; the program keys carry the reference's variant tags.
"""
import numpy as np
import pytest

from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)
from test_torch_engine import GEOMETRY, _drive
from test_torch_quant_engine import matrix, models  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

W_KNOBS = {
    "w8_unified": dict(quantize_weights=True),
    "w8_a8": dict(quantize_weights=True, quantize_activations=True),
    "w8_two_program": dict(quantize_weights=True, ragged_step=False),
    "fused_int8_w8": dict(fused_tick=True, kv_dtype="int8",
                          quantize_weights=True),
    "fused_fp8": dict(fused_tick=True, kv_dtype="fp8"),
    "a8_fused_scanned": dict(fused_tick=True, quantize_weights=True,
                             quantize_activations=True),
    "fused_ticks4_int8_w8": dict(fused_tick=True, decode_ticks=4,
                                 kv_dtype="int8", quantize_weights=True),
    "fused_ticks4_fp8": dict(fused_tick=True, decode_ticks=4,
                             kv_dtype="fp8"),
}


@pytest.mark.parametrize("name", list(W_KNOBS))
def test_quantized_weight_streams_equal_jax(models, matrix, name):
    jm, tm = models
    knobs = W_KNOBS[name]
    want, jeng = _drive(JEngine(jm, **GEOMETRY, **knobs), JRequest, matrix)
    got, eng = _drive(ContinuousBatchingEngine(tm, **GEOMETRY, **knobs),
                      GenerationRequest, matrix)
    assert got == want
    assert (eng.decode_compilations(), eng.prefill_compilations()) \
        == (jeng.decode_compilations(), jeng.prefill_compilations())
    assert eng.quantize_weights == jeng.quantize_weights
    assert eng.quantize_activations == jeng.quantize_activations


def _run(engine, Request, matrix):
    seqs = {n: engine.submit(Request(prompt=p, **kw)) for n, p, kw in matrix}
    while engine.has_work():
        engine.step()
    return {n: (list(map(int, s.tokens)), s.finish_reason)
            for n, s in seqs.items()}


def test_dense_engine_with_int8_weights_equals_jax(models, matrix):
    """The dense engine (one-shot prefill, no mid-prefill state to
    cancel): the matrix without its two cancelled victims."""
    jm, tm = models
    m = [r for r in matrix if not r[0].startswith("victim")]
    knobs = dict(paged_attn=False, quantize_weights=True)
    jeng = JEngine(jm, **GEOMETRY, **knobs)
    eng = ContinuousBatchingEngine(tm, **GEOMETRY, **knobs)
    assert _run(eng, GenerationRequest, m) == _run(jeng, JRequest, m)
    assert eng.decode_compilations() == jeng.decode_compilations()


def test_a8_fused_over_int8_pool_is_the_scanned_tick(models, matrix):
    _, tm = models
    knobs = dict(quantize_weights=True, quantize_activations=True,
                 kv_dtype="int8")
    want, _ = _drive(ContinuousBatchingEngine(tm, **GEOMETRY, **knobs),
                     GenerationRequest, matrix)
    got, eng = _drive(ContinuousBatchingEngine(
        tm, **GEOMETRY, fused_tick=True, **knobs), GenerationRequest, matrix)
    assert got == want
    assert eng.stats["decode_steps"] > eng.stats["decode_calls"]


def test_converted_params_are_shared_and_keys_tagged(models):
    _, tm = models
    jit = {}
    a = ContinuousBatchingEngine(tm, **GEOMETRY, quantize_weights=True,
                                 kv_dtype="int8", jit_cache=jit)
    b = ContinuousBatchingEngine(tm, **GEOMETRY, quantize_weights=True,
                                 quantize_activations=True, jit_cache=jit)
    assert a._params is b._params is tm.__dict__["_decode_qparams"]
    q, sc = a._params["wq"]
    assert q.dtype == np.int8 or str(q.dtype) == "torch.int8"
    assert tuple(sc.shape) == (q.shape[0], 1, q.shape[2])
    for e, R in ((a, GenerationRequest), (b, GenerationRequest)):
        e.generate([R(prompt=np.arange(1, 9, dtype=np.int32),
                      max_new_tokens=3)])
    keys = set(jit)
    assert ("prefill", "w8") in keys and ("prefill", "w8", "a8") in keys
    assert ("psuffix", "kv8", "w8") not in keys   # no hit, no suffix
    assert any(k[0] == "ragged" and k[5:] == ("kv8", "w8") for k in keys)
    assert any(k[0] == "ragged" and k[5:] == ("w8", "a8") for k in keys)
    assert a.decode_compilations() == b.decode_compilations() == 1
