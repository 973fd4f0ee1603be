"""The port's span tracer through its engine and gateway, on the CPU.

A chaos replay under a ``VirtualClock`` (a transient retry, a pool
preemption, a fatal rebuild, a hung step past the watchdog, a NaN
rebuild) must export a trace that is BYTE-identical across two port
runs, and each request's lifecycle events (``queued``, ``prefill``,
``prefill_chunk[i]``, ``decode``, ``preempted``, ``recovered``,
``finished`` …, in order, on its lane) must equal the JAX engine's under
the same plan and traffic. Streams stay equal to the fault-free run with
tracing on. A ``/debug/trace?steps=8`` window over HTTP holds the step
phases, and ``python -m paddle_tpu_torch.profiler`` reads a saved trace.
"""
import json
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.profiler.tracing import SpanTracer as JTracer
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving import FaultPlan as JPlan
from paddle_tpu.serving import VirtualClock as JClock
from paddle_tpu.serving.decode import llama_decode_params
from paddle_tpu.serving.server import ServingGateway as JGateway
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           load_decode_params)
from paddle_tpu_torch.profiler.tracing import (NULL_SPAN, TID_GATEWAY,
                                               TID_REQ0, SpanTracer)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)
from paddle_tpu_torch.serving.faults import FaultPlan, VirtualClock
from paddle_tpu_torch.serving.server import ServingGateway, serve
from torch_threads import one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
NUM_SLOTS, S_MAX = 3, 128
GEOM = dict(num_slots=NUM_SLOTS, max_seq_len=S_MAX, decode_chunk=1,
            prefix_block_size=8, prefill_chunk=32)


@pytest.fixture(scope="module")
def models():
    paddle.seed(41)
    jm = JLlama(j_tiny(decode_attention="jnp"))
    p, tied = llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


def _workload():
    """Greedy and seeded-sampled shorts plus one prompt that chunks."""
    rng = np.random.RandomState(5)
    reqs = []
    for i in range(6):
        kw = dict(temperature=0.8, top_k=5, seed=300 + i) if i % 3 == 2 \
            else {}
        reqs.append(dict(prompt=rng.randint(0, 256, (10,)).astype(np.int32),
                         max_new_tokens=8, **kw))
    reqs.append(dict(prompt=rng.randint(0, 256, (72,)).astype(np.int32),
                     max_new_tokens=4))
    return reqs


def _plan(Plan, clk):
    return (Plan(clock=clk).at_step(3, "transient").at_step(6, "pool")
            .at_step(9, "fatal").at_step(13, "hung", stall_s=60.0)
            .at_step(17, "nan"))


def _chaos_run(side, model, jit, with_plan, trace):
    """One supervised serving pass under a VirtualClock on the port
    (``side="port"``) or the JAX package (``side="jax"``)."""
    port = side == "port"
    Clock, Plan, Tracer, Gateway, Engine, Request = (
        (VirtualClock, FaultPlan, SpanTracer, ServingGateway,
         ContinuousBatchingEngine, GenerationRequest) if port else
        (JClock, JPlan, JTracer, JGateway, JEngine, JRequest))
    clk = Clock()

    def factory():
        return Engine(model, step_clock=clk, jit_cache=jit, **GEOM)

    plan = _plan(Plan, clk) if with_plan else None
    tracer = Tracer(clock=clk)
    gw = Gateway(factory(), engine_factory=factory, max_queue=32,
                 fault_hook=plan, clock=clk, watchdog_deadline_s=5.0,
                 retry_backoff_s=0.0, max_restarts=16, start=False,
                 tracer=tracer, trace=trace)
    try:
        streams = [gw.submit(Request(**r)) for r in _workload()]
        gw.start()
        outs = [(list(map(int, ids)), reason)
                for ids, reason in (s.result() for s in streams)]
    finally:
        gw.shutdown(drain=True, timeout=60)
    return outs, tracer, gw


def _lanes(doc):
    """Per-request-lane event names, in order (the lifecycle sequence),
    and the gateway lane's."""
    lanes = {}
    for e in doc["traceEvents"]:
        if e["tid"] >= TID_REQ0 or e["tid"] == TID_GATEWAY:
            lanes.setdefault(e["tid"], []).append(e["name"])
    return lanes


def test_chaos_trace_byte_stable_and_equal_to_jax_lifecycle(models):
    jm, tm = models
    jit = {}
    base, _, _ = _chaos_run("port", tm, jit, with_plan=False, trace=False)
    assert all(r == "length" for _, r in base)
    # warm pass with the plan: recovery-path prefill shapes get recorded
    # here, so both compared replays run warm (the watchdog exempts a
    # step that records a new program)
    _chaos_run("port", tm, jit, with_plan=True, trace=True)
    outs1, tr1, gw1 = _chaos_run("port", tm, jit, True, True)
    outs2, tr2, gw2 = _chaos_run("port", tm, jit, True, True)
    assert outs1 == base and outs2 == base
    doc1 = json.dumps(tr1.export(), sort_keys=True)
    doc2 = json.dumps(tr2.export(), sort_keys=True)
    assert doc1 == doc2
    assert gw1.restarts == gw2.restarts == 3       # fatal + hung + nan
    evs = json.loads(doc1)["traceEvents"]
    names = {e["name"] for e in evs}
    assert {"step", "plan", "launch", "host-accept", "admit",
            "prefill_launch", "queued", "prefill", "decode", "finished",
            "fault", "rebuild", "recovery", "preempted",
            "prefill_chunk[0]"} <= names
    assert max(e["ts"] for e in evs) >= 60e6       # the hung stall
    # the JAX engine under the same plan and traffic, warm the same way
    jjit = {}
    jbase, _, _ = _chaos_run("jax", jm, jjit, with_plan=False, trace=False)
    assert jbase == base
    _chaos_run("jax", jm, jjit, with_plan=True, trace=True)
    jouts, jtr, jgw = _chaos_run("jax", jm, jjit, True, True)
    assert jouts == base and jgw.restarts == gw1.restarts
    assert _lanes(json.loads(doc1)) == _lanes(jtr.export())


def test_tracing_off_and_attached_disabled_change_nothing(models):
    tm = models[1]
    reqs = _workload()[:3]
    plain = ContinuousBatchingEngine(tm, **GEOM).generate(
        [GenerationRequest(**r) for r in reqs])
    tracer = SpanTracer()
    eng = ContinuousBatchingEngine(tm, **GEOM)
    eng.tracer = tracer                      # attached, not recording
    outs = eng.generate([GenerationRequest(**r) for r in reqs])
    assert [o.tolist() for o in outs] == [o.tolist() for o in plain]
    assert tracer.events() == []
    tracer.enable()
    eng2 = ContinuousBatchingEngine(tm, **GEOM)
    eng2.tracer = tracer
    outs = eng2.generate([GenerationRequest(**r) for r in reqs])
    assert [o.tolist() for o in outs] == [o.tolist() for o in plain]
    assert {e["name"] for e in tracer.events()} >= {"step", "launch"}


def test_tracer_unit_copy():
    """The copy behaves as the JAX package's: disabled is a no-op, the
    ring drops the oldest, request lanes are dense first-seen."""
    clk = VirtualClock(5.0)
    tr = SpanTracer(capacity=4, clock=clk)
    tr.instant("x")
    assert tr.span("z") is NULL_SPAN and tr.events() == []
    tr.enable()
    for i in range(10):
        tr.instant(f"e{i}")
    assert [e["name"] for e in tr.events()] == ["e6", "e7", "e8", "e9"]
    assert tr.dropped == 6
    assert (tr.req_tid(42), tr.req_tid(7), tr.req_tid(42)) == \
        (TID_REQ0, TID_REQ0 + 1, TID_REQ0)


def test_debug_trace_window_and_profiler_cli(models, tmp_path):
    srv = serve(models[1], port=0, num_slots=NUM_SLOTS, max_seq_len=S_MAX,
                max_queue=16, model_name="trace-test")
    try:
        gw = srv.gateway
        gw.submit(GenerationRequest(prompt=[1, 2, 3, 4],
                                    max_new_tokens=2)).result()
        streams = []

        def traffic():
            streams.extend(gw.submit(GenerationRequest(**r))
                           for r in _workload()[:4])

        t = threading.Thread(target=traffic)
        t.start()
        with urllib.request.urlopen(srv.url + "/debug/trace?steps=8",
                                    timeout=60) as r:
            doc = json.load(r)
        t.join(timeout=30)
        for s in streams:
            s.result()
    finally:
        srv.shutdown(drain=False, timeout=30)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"step", "plan", "launch", "host-accept"} <= names
    assert sum(e["name"] == "step" for e in doc["traceEvents"]) == 8
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.profiler",
                        str(path), "--top", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "engine:launch" in r.stdout and "engine:step" in r.stdout
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.profiler",
                        str(tmp_path)], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and "Queue A step 14" in r.stderr
