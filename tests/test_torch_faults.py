"""The fault matrix of tests/test_fault_tolerance.py on the port's
supervised gateway, on the CPU, with every stream held against the JAX
engine's fault-free run of the same requests.

``llama_tiny`` weights come from the JAX model; the engines run the test
geometry of the reference's matrix (2 slots, block 8, chunk 16,
``decode_chunk=1``) without the prefix cache (not ported: ROADMAP Queue A
step 9). After a transient, fatal, nan, hung or pool fault every stream
must equal the fault-free run; a poisoned request is the only one failed;
slot and block accounting land exact; the watchdog exempts a step that
recorded a new program or built a kernel library (a slow nvcc build,
stubbed here). Gateways are built unstarted, so each plan's step
indices are deterministic against the traffic, and every one is shut down.
"""
import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving.decode import llama_decode_params
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           load_decode_params)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      FINISH_REASONS, GenerationRequest,
                                      PoolExhausted)
from paddle_tpu_torch.serving.faults import (FatalFault, FaultPlan,
                                             VirtualClock)
from paddle_tpu_torch.serving.server import ServingGateway, serve

from test_metrics_prom import parse_prometheus
from torch_threads import one_torch_thread  # noqa: F401

BS, CHUNK, SLOTS, S_MAX = 8, 16, 2, 96
GEOM = dict(num_slots=SLOTS, max_seq_len=S_MAX, decode_chunk=1,
            prefix_block_size=BS, prefill_chunk=CHUNK)


@pytest.fixture(scope="module")
def models():
    paddle.seed(33)
    jm = JLlama(j_tiny(decode_attention="jnp"))
    p, tied = llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


@pytest.fixture
def shutdown():
    """Collects gateways; every one is shut down after the test."""
    gws = []
    yield gws.append
    for gw in gws:
        gw.shutdown(drain=False, timeout=30)
        assert not gw._thread.is_alive()


def _factory(tm, jit_cache=None):
    cache = jit_cache if jit_cache is not None else \
        tm.__dict__.setdefault("_serving_jit", {})

    def factory():
        return ContinuousBatchingEngine(tm, jit_cache=cache, **GEOM)
    return factory


def _prompt(seed, n=12):
    return np.random.RandomState(seed).randint(0, 256, (n,)).astype(np.int32)


def _kw(ps, n=12, **kw):
    kw.setdefault("max_new_tokens", 8)
    return dict(prompt=_prompt(ps, n), **kw)


def _traffic():
    """Greedy shorts, one seeded-sampled row, one prompt that chunks."""
    return [_kw(1), _kw(2, n=10),
            _kw(3, temperature=0.9, top_k=5, seed=123),
            _kw(4, n=60, max_new_tokens=5)]


def _jax_baseline(jm, reqs):
    """The fault-free oracle: the JAX engine on the same requests."""
    eng = JEngine(jm, jit_cache=jm.__dict__.setdefault("_serving_jit", {}),
                  **GEOM)
    return [o.tolist() for o in eng.generate([JRequest(**r) for r in reqs])]


@pytest.fixture(scope="module")
def want(models):
    """JAX's fault-free streams of the standard traffic, equal to the
    port's own fault-free run."""
    w = _jax_baseline(models[0], _traffic())
    eng = _factory(models[1])()
    assert [o.tolist() for o in eng.generate(
        [GenerationRequest(**r) for r in _traffic()])] == w
    return w


def _drive(eng):
    while eng.has_work():
        eng.step()


def _await(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert pred(), "condition not reached before timeout"


def _gateway(tm, plan, keep, jit_cache=None, **kw):
    """A supervised gateway wired as serve() wires it, NOT started."""
    factory = _factory(tm, jit_cache)
    kw.setdefault("max_queue", 16)
    gw = ServingGateway(factory(), engine_factory=factory, fault_hook=plan,
                        start=False, **kw)
    keep(gw)
    return gw


def _run(gw, reqs):
    streams = [gw.submit(GenerationRequest(**r)) for r in reqs]
    gw.start()
    return streams, [st.result() for st in streams]


def test_error_is_in_finish_vocabulary():
    assert "error" in FINISH_REASONS


class TestPreemptionByRecompute:
    def test_pool_fault_preempts_youngest_streams_identical(self, models,
                                                            want):
        eng = _factory(models[1])()
        seqs = [eng.submit(GenerationRequest(**r)) for r in _traffic()]
        FaultPlan().at_step(4, "pool").install(eng)
        _drive(eng)
        assert [s.tokens for s in seqs] == want
        assert eng.stats["preemptions"] == 1 and eng.stats["restores"] == 1
        assert eng.cache.num_free == SLOTS
        assert eng.cache.pool.num_used == 0          # nothing leaked
        assert int((eng.cache.pool._ref > 0).sum()) == 0

    def test_unrepairable_exhaustion_reraises(self, models):
        eng = _factory(models[1])()
        eng.submit(GenerationRequest(**_kw(5)))
        FaultPlan().at_step(0, "pool").install(eng)
        with pytest.raises(PoolExhausted):
            eng.step()
        assert eng.scheduler.num_queued == 1
        _drive(eng)
        assert eng.cache.num_free == SLOTS


class TestEngineRestore:
    def test_restore_mid_stream_byte_identical(self, models, want):
        jit = {}
        factory = _factory(models[1], jit)
        eng = factory()
        seqs = [eng.submit(GenerationRequest(**r)) for r in _traffic()]
        emitted = {s.request_id: [] for s in seqs}
        eng.on_token = lambda s, t: emitted[s.request_id].append(t)
        for _ in range(4):
            eng.step()
        keys = np.asarray(eng._keys, np.int64)
        live = sorted((s for s in eng._slots if s is not None
                       and not s.done), key=lambda s: s.request_id)
        for s in live:
            if s.tokens and s.status == "running":
                s.key = keys[s.slot].copy()
        queued = list(eng.scheduler.queue)
        eng2 = factory()
        eng2.on_token = eng.on_token
        before = eng2.decode_compilations()
        for s in live + queued:
            assert eng2.restore(s)
        _drive(eng2)
        assert [s.tokens for s in seqs] == want
        assert [emitted[s.request_id] for s in seqs] == want
        assert eng2.decode_compilations() == before == 1

    def test_mid_admission_crash_unwinds_to_queue(self, models, want):
        eng = _factory(models[1])()
        seqs = [eng.submit(GenerationRequest(**r)) for r in _traffic()]
        orig = eng._admit_cold
        state = {"armed": True}

        def boom(group, finished):
            if state["armed"]:
                state["armed"] = False
                raise FatalFault("device error mid-admission")
            return orig(group, finished)

        eng._admit_cold = boom
        with pytest.raises(FatalFault):
            eng.step()
        assert [q.request_id for q in eng.scheduler.queue] == \
            [s.request_id for s in seqs]
        assert eng.cache.num_free == SLOTS
        _drive(eng)
        assert [s.tokens for s in seqs] == want

    def test_restored_long_content_chunks(self, models):
        eng = _factory(models[1])()
        r = _kw(6, n=40, max_new_tokens=30)
        seq = eng.submit(GenerationRequest(**r))
        ref = _jax_baseline(models[0], [r])[0]
        while len(seq.tokens) < 10:
            eng.step()
        eng._preempt(seq)                 # 40 + 9 = 49 rows > CHUNK
        assert seq.status == "queued" and seq.work_len == 49
        chunks0 = eng.stats["prefill_chunks"]
        _drive(eng)
        assert seq.tokens == ref
        assert eng.stats["prefill_chunks"] > chunks0

    def test_evict_then_restore_on_a_sibling(self, models, want):
        """evict() hands a live sequence to another engine's restore."""
        factory = _factory(models[1])
        a, b = factory(), factory()
        seqs = [a.submit(GenerationRequest(**r)) for r in _traffic()]
        for _ in range(3):
            a.step()
        moved = [s for s in a._slots if s is not None]
        for s in moved:
            assert a.evict(s) and s.slot is None
            assert b.restore(s)
        assert a.cache.num_free == SLOTS
        while a.has_work() or b.has_work():
            for e in (a, b):
                if e.has_work():
                    e.step()
        assert [s.tokens for s in seqs] == want


class TestSupervisedDriver:
    def test_transient_fault_retries_same_engine(self, models, want,
                                                 shutdown):
        plan = FaultPlan().at_step(2, "transient")
        gw = _gateway(models[1], plan, shutdown)
        _, outs = _run(gw, _traffic())
        assert [ids.tolist() for ids, _ in outs] == want
        assert gw.restarts == 0 and plan.log == [(2, "transient")]
        fams = parse_prometheus(gw.registry.render())
        assert fams["serving_faults_total"]["samples"][
            ("serving_faults_total", (("kind", "transient"),))] == 1

    def test_transient_streak_escalates_to_rebuild(self, models, want,
                                                   shutdown):
        plan = FaultPlan()
        for i in range(6):
            plan.at_step(2 + i, "transient")
        gw = _gateway(models[1], plan, shutdown, max_transient_retries=3,
                      retry_backoff_s=0.0)
        _, outs = _run(gw, _traffic())
        assert gw.restarts >= 1
        assert [ids.tolist() for ids, _ in outs] == want

    @pytest.mark.parametrize("kind,at", [("fatal", 3), ("nan", 4)])
    def test_fatal_and_nan_recover_streams_identical(self, models, want,
                                                     shutdown, kind, at):
        """A fatal fault rebuilds and recovers by recompute; the nan
        fault first fills the pool with NaN in place, so equal streams
        prove the corrupt storage was not reused. The rebuild counts no
        new decode program, and the dead engine's pool was released."""
        jit = {}
        plan = FaultPlan().at_step(at, kind)
        gw = _gateway(models[1], plan, shutdown, jit_cache=jit)
        first = gw.engine
        _, outs = _run(gw, _traffic())
        assert [ids.tolist() for ids, _ in outs] == want
        assert [r for _, r in outs] == ["length"] * 4
        assert gw.restarts == 1 and len(gw.restart_latencies) == 1
        assert gw.engine.decode_compilations() == 1
        assert first.cache.pool.k is None and gw.engine is not first

    def test_hung_step_watchdog_rebuilds(self, models, want, shutdown):
        clk = VirtualClock()
        plan = FaultPlan(clock=clk).at_step(3, "hung", stall_s=99.0)
        gw = _gateway(models[1], plan, shutdown, watchdog_deadline_s=5.0,
                      clock=clk)
        _, outs = _run(gw, _traffic())
        assert [ids.tolist() for ids, _ in outs] == want
        assert gw.restarts == 1
        fams = parse_prometheus(gw.registry.render())
        assert fams["serving_faults_total"]["samples"][
            ("serving_faults_total", (("kind", "hung"),))] == 1

    def test_watchdog_exempts_steps_that_record_a_program(self, models,
                                                          shutdown):
        """The reference's rule: a stalled step that recorded a new
        program (fresh cache) is exempt; a warm one is hung."""
        clk = VirtualClock()
        plan = (FaultPlan(clock=clk).at_step(0, "hung", stall_s=99.0)
                .at_step(5, "hung", stall_s=99.0))
        gw = _gateway(models[1], plan, shutdown, jit_cache={},
                      watchdog_deadline_s=5.0, clock=clk)
        streams, _ = _run(gw, _traffic())
        assert all(st.finish_reason == "length" for st in streams)
        assert gw.restarts == 1

    @pytest.mark.parametrize("builds", [True, False],
                             ids=["slow_build", "no_build"])
    def test_watchdog_exempts_a_slow_kernel_build(self, models, shutdown,
                                                  monkeypatch, builds):
        """A warm step in which a kernel library is built (nvcc, stubbed
        here as 99 s on the virtual clock) and loaded is not hung; the
        same stall without a build is."""
        clk = VirtualClock()
        monkeypatch.setattr(_build, "_loaded", {})
        monkeypatch.setattr(_build, "build_all", lambda names: (
            clk.advance(99.0), {n: "stub.so" for n in names})[1])
        monkeypatch.setattr(_build.ctypes, "CDLL", lambda path:
                            types.SimpleNamespace(
                                pt_flash_fwd=types.SimpleNamespace()))
        calls = {"n": 0}

        def hook(engine):
            calls["n"] += 1
            if calls["n"] == 6:
                if builds:
                    _build.load("flash")
                else:
                    clk.advance(99.0)

        gw = _gateway(models[1], hook, shutdown, watchdog_deadline_s=5.0,
                      clock=clk)
        streams, _ = _run(gw, _traffic())
        assert all(st.finish_reason == "length" for st in streams)
        assert gw.restarts == (0 if builds else 1)
        assert _build.libraries_loaded() == (1 if builds else 0)

    def test_no_factory_strands_with_errors_not_hangs(self, models,
                                                      shutdown):
        plan = FaultPlan().at_step(2, "fatal")
        gw = ServingGateway(_factory(models[1])(), fault_hook=plan,
                            start=False)
        shutdown(gw)
        streams = [gw.submit(GenerationRequest(**r)) for r in _traffic()]
        gw.start()
        for st in streams:
            with pytest.raises(RuntimeError, match="engine driver died"):
                st.result()
        assert all(st.finish_reason == "error" for st in streams)

    def test_restart_budget_exhaustion_strands_with_errors(self, models,
                                                           shutdown):
        plan = FaultPlan().poison(lambda s: True, kind="fatal")
        gw = _gateway(models[1], plan, shutdown, max_restarts=2,
                      retry_backoff_s=0.0)
        streams = [gw.submit(GenerationRequest(**r)) for r in _traffic()]
        gw.start()
        for st in streams:
            try:
                st.result()
            except RuntimeError:
                pass
        assert gw.restarts == 2
        assert all(st.finish_reason is not None for st in streams)


class TestPoisonQuarantine:
    def test_bisection_fails_only_the_culprit(self, models, shutdown):
        bystanders = [_kw(i, n=8 + i) for i in range(4)]        # 8..11
        want = _jax_baseline(models[0], bystanders)
        plan = FaultPlan().poison(lambda s: s.prompt_len == 13)
        gw = _gateway(models[1], plan, shutdown, max_restarts=16,
                      retry_backoff_s=0.0)
        streams = [gw.submit(GenerationRequest(**r)) for r in bystanders]
        bad = gw.submit(GenerationRequest(**_kw(50, n=13,
                                                max_new_tokens=40)))
        gw.start()
        outs = [st.result() for st in streams]
        with pytest.raises(RuntimeError, match="poisoned request"):
            bad.result()
        assert bad.finish_reason == "error"
        assert [ids.tolist() for ids, _ in outs] == want
        assert gw.restarts >= 2
        assert not gw._parked and gw._suspect_ids is None
        _await(lambda: gw.health_state == "ok")

    def test_cancel_during_recovery_is_honored(self, models, shutdown):
        plan = FaultPlan().poison(lambda s: s.prompt_len == 13)
        gw = _gateway(models[1], plan, shutdown, max_restarts=16,
                      retry_backoff_s=0.0)
        victim = gw.submit(GenerationRequest(**_kw(60, n=8,
                                                   max_new_tokens=60)))
        bad = gw.submit(GenerationRequest(**_kw(61, n=13,
                                                max_new_tokens=60)))
        gw.start()
        _await(lambda: gw.restarts >= 1)
        victim.cancel()
        ids, reason = victim.result()
        assert reason in ("cancelled", "length")
        try:
            bad.result()
        except RuntimeError:
            pass
        _await(lambda: gw.engine.cache.num_free == SLOTS)

    def test_parked_deadline_still_expires(self, models, shutdown):
        gw = _gateway(models[1], None, shutdown)
        st = gw.submit(GenerationRequest(**_kw(80, max_new_tokens=60,
                                               timeout_s=0.05)))
        gw._admit_intake()
        seq = st.seq
        assert gw.engine.scheduler.remove(seq)
        seq.status = "queued"
        gw._parked.append(seq)
        time.sleep(0.06)
        gw.start()
        ids, reason = st.result()
        assert reason == "timeout" and len(ids) == 0


class TestHealthAndMetrics:
    def test_fault_series_strict_parse(self, models, shutdown):
        clk = VirtualClock()
        plan = (FaultPlan(clock=clk)
                .at_step(2, "transient").at_step(4, "pool")
                .at_step(7, "fatal").at_step(11, "hung", stall_s=99.0))
        gw = _gateway(models[1], plan, shutdown, watchdog_deadline_s=5.0,
                      clock=clk)
        streams = [gw.submit(GenerationRequest(**r)) for r in _traffic()]
        gw.start()
        for st in streams:
            st.result()
        fams = parse_prometheus(gw.registry.render())
        got = {lab[0][1]: v for (_, lab), v in
               fams["serving_faults_total"]["samples"].items()}
        assert got == {"transient": 1, "fatal": 1, "hung": 1}
        assert fams["serving_engine_restarts_total"]["samples"][
            ("serving_engine_restarts_total", ())] == 2
        assert fams["serving_preemptions_total"]["samples"][
            ("serving_preemptions_total", ())] == 1
        assert fams["serving_recovered_requests_total"]["samples"][
            ("serving_recovered_requests_total", ())] >= 2
        assert fams["serving_watchdog_last_step_age_seconds"]["type"] == \
            "gauge"
        assert gw._counter_state[0]["preemptions"] == 1

    def test_healthz_and_terminal_error_response(self, models):
        plan = FaultPlan().poison(lambda s: s.prompt_len == 13)
        srv = serve(models[1], port=0, num_slots=SLOTS, max_seq_len=S_MAX,
                    prefix_block_size=BS, prefill_chunk=CHUNK,
                    max_restarts=16, model_name="chaos-test",
                    fault_hook=plan)
        try:
            body = json.dumps({"prompt": _prompt(70, 13).tolist(),
                               "max_tokens": 40}).encode()
            req = urllib.request.Request(
                srv.url + "/v1/completions", data=body,
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=60)
            assert e.value.code == 500
            doc = json.load(e.value)
            assert doc["choices"][0]["finish_reason"] == "error"
            assert doc["error"]["type"] == "server_error"
            with urllib.request.urlopen(srv.url + "/healthz",
                                        timeout=10) as r:
                doc = json.load(r)
            assert doc["status"] in ("ok", "degraded", "recovering")
            assert doc["engine_restarts"] >= 1
            assert isinstance(doc["last_step_age_s"], float)
        finally:
            srv.shutdown(drain=False, timeout=30)
