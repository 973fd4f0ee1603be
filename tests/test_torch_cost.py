"""The port's cost observatory and program counts against the JAX
package's, on the CPU.

For the same traffic through engines of the same geometry, the port's
observatory must count the same calls per program (and the same compile
events) as the JAX observatory, each request must have ridden the same
number of programs (``Sequence.launches``), and
``decode_compilations()`` / ``prefill_compilations()`` must equal the JAX
engine's for pow2 and exact bucketing, ``decode_chunk`` 1 and 8, and a
rebuilt engine sharing the program cache. The launch census — the
kernels a program's first call launched, read off ``kernels.LAUNCHES``
— is checked with counting stand-ins for the kernel wrappers (on the
CPU no kernel launches): it must be what each program launches per call,
and the census times the calls must be the launch counters' total.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.profiler.cost import CostObservatory as JCost
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving.decode import llama_decode_params
from paddle_tpu_torch import kernels
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           load_decode_params)
from paddle_tpu_torch.profiler import metrics
from paddle_tpu_torch.profiler.cost import CostObservatory
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)
from paddle_tpu_torch.serving import decode as sdecode
from paddle_tpu_torch.serving.faults import FaultPlan
from paddle_tpu_torch.serving.server import ServingGateway

LAYERS = 2
GEOM = dict(num_slots=3, max_seq_len=128, prefix_block_size=8,
            prefill_chunk=16, headroom_mult=None)


@pytest.fixture(scope="module")
def models():
    paddle.seed(51)
    jm = JLlama(j_tiny(decode_attention="jnp", num_hidden_layers=LAYERS))
    p, tied = llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(num_hidden_layers=LAYERS),
                          device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


def _traffic():
    rng = np.random.RandomState(9)
    lens = (5, 40, 12, 3)
    return [dict(prompt=rng.randint(0, 256, (n,)).astype(np.int32),
                 max_new_tokens=6 + i,
                 **(dict(temperature=0.7, top_k=4, seed=i) if i % 2 else {}))
            for i, n in enumerate(lens)]


def _kinds(co):
    """calls and compiles per program, the attention name dropped from
    the label (jnp there, pallas here)."""
    out = {}
    for label, rec in co.programs.items():
        key = label.replace(",jnp]", "]").replace(",pallas]", "]")
        out[key] = (rec["calls"], rec["compiles"])
    return out


def _run(Engine, Request, Cost, model, **kw):
    eng = Engine(model, jit_cache={}, **dict(GEOM, **kw))
    eng.cost = Cost()
    seqs = [eng.submit(Request(**r)) for r in _traffic()]
    while eng.has_work():
        eng.step()
    return eng, seqs


@pytest.mark.parametrize("decode_chunk", [1, 8])
def test_program_calls_and_launches_per_request_equal_jax(models,
                                                          decode_chunk):
    jm, tm = models
    jeng, jseqs = _run(JEngine, JRequest, JCost, jm,
                       decode_chunk=decode_chunk)
    eng, seqs = _run(ContinuousBatchingEngine, GenerationRequest,
                     CostObservatory, tm, decode_chunk=decode_chunk)
    assert [s.tokens for s in seqs] == [s.tokens for s in jseqs]
    assert _kinds(eng.cost) == _kinds(jeng.cost)
    assert [s.launches for s in seqs] == [s.launches for s in jseqs]
    for kind in ("prefill", "ragged"):
        assert eng.cost.kind_calls(kind) == jeng.cost.kind_calls(kind)
    assert eng.cost.kind_calls("ragged") == eng.stats["unified_steps"]
    doc = eng.cost.export()
    assert doc["totals"]["dispatches"] == sum(
        r["calls"] for r in doc["programs"])
    # host->device: exactly the numpy arguments' bytes (ids, lengths,
    # keys, temps, top_ks of each padded prefill group)
    pre = eng.cost.programs["prefill"]
    assert pre["h2d_bytes"] > 0 and pre["d2h_bytes"] > 0


@pytest.mark.parametrize("bucketing,decode_chunk", [
    ("pow2", 1), ("pow2", 8), ("exact", 1), ("exact", 8)])
def test_compilations_equal_jax_and_survive_a_rebuild(models, bucketing,
                                                      decode_chunk):
    jm, tm = models
    counts = []
    for Engine, Request, model in ((JEngine, JRequest, jm),
                                   (ContinuousBatchingEngine,
                                    GenerationRequest, tm)):
        jit = {}
        got = []
        for _ in range(2):             # a rebuild sharing the cache
            eng = Engine(model, jit_cache=jit, decode_chunk=decode_chunk,
                         prefill_bucketing=bucketing, **GEOM)
            eng.generate([Request(**r) for r in _traffic()])
            got.append((eng.decode_compilations(),
                        eng.prefill_compilations()))
        counts.append(got)
    assert counts[1] == counts[0]
    assert counts[1][0] == counts[1][1]
    if decode_chunk == 1:
        assert counts[1][0][0] == 1


def _counting(monkeypatch):
    """Stand-ins that count a launch per kernel-wrapper call, as the
    wrappers do on the card."""
    for attr, name in (("_attention", "flash"),
                       ("paged_decode_attention", "paged_decode"),
                       ("ragged_paged_attention", "ragged_attention")):
        fn = getattr(sdecode, attr)

        def counted(*a, _fn=fn, _name=name, **k):
            kernels.count_launch(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(sdecode, attr, counted)


def test_launch_census_is_the_per_call_launch_count(models, monkeypatch):
    _counting(monkeypatch)
    kernels.reset_launches()
    eng, _ = _run(ContinuousBatchingEngine, GenerationRequest,
                  CostObservatory, models[1], decode_chunk=4)
    total = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    cen = {label: c["launches"] for label, c in eng.cost.censuses.items()}
    assert cen["prefill"] == {"flash": LAYERS}
    for label, c in cen.items():
        if label.startswith("ragged["):
            n = int(label.split(",")[2])     # ragged[R,T,n,attn]
            want = {"ragged_attention": LAYERS}
            if n > 1:
                want["paged_decode"] = LAYERS * (n - 1)
            assert c == want, label
    summed = {}
    for label, rec in eng.cost.programs.items():
        for k, v in cen[label].items():
            summed[k] = summed.get(k, 0) + v * rec["calls"]
    assert summed == {k: v for k, v in total.items() if v}
    doc = eng.cost.export()
    assert all("census" in r for r in doc["programs"])


def test_profile_counts_equal_engine_counters(models):
    """/debug/profile's program calls read the engine's own counters;
    dispatch and token series stay monotonic across a rebuild."""
    tm = models[1]
    jit = {}

    def factory():
        return ContinuousBatchingEngine(tm, jit_cache=jit, decode_chunk=1,
                                        **GEOM)
    gw = ServingGateway(factory(), engine_factory=factory,
                        fault_hook=FaultPlan().at_step(5, "fatal"),
                        start=False)
    try:
        first = gw.engine
        streams = [gw.submit(GenerationRequest(**r)) for r in _traffic()]
        gw.start()
        for s in streams:
            s.result()
        doc = gw.capture_profile()
    finally:
        gw.shutdown(drain=True, timeout=30)
    assert gw.restarts == 1
    calls = {p["kind"]: 0 for p in doc["programs"]}
    for p in doc["programs"]:
        calls[p["kind"]] += p["calls"]
    steps = first.stats["unified_steps"] + gw.engine.stats["unified_steps"]
    assert calls["ragged"] == steps
    tokens = sum(len(s.tokens()) for s in streams)
    assert doc["totals"]["decoded_tokens"] == gw._stat("tokens_generated")
    assert gw._stat("tokens_generated") >= tokens
    assert doc["kv_pool"]["kv_dtype"] == "float32"


def test_peak_flops_reads_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.peak_flops_per_chip()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert metrics.peak_flops_per_chip() == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="no peak rate"):
        metrics.peak_flops_per_chip()
