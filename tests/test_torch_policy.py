"""The port's multi-tenant SLO policy (``serving/policy``) against the JAX
package, on the CPU, on ``llama_tiny`` (GQA, ``decode_attention="jnp"``)
with the JAX model's weights carried across.

- the class table parses the CLI spec, resolves unknown names to the
  ValueError the HTTP layer answers 400, and the single-class table is
  inactive (the engine keeps the FIFO scheduler);
- victim selection and the policy scheduler (class rank, TTFT slack,
  FIFO tick; aging; reserved headroom; urgency) on stand-ins, and a random
  schedule through both packages' schedulers with the same admissions;
- the engine under a virtual clock: an urgent latency request preempts a
  running batch one by recompute, equals never displace equals, a mixed
  chaos schedule replays — each with the streams, finish reasons and
  policy/preemption stats of the JAX engine on the same schedule, and
  every stream equal to its policy-off run;
- HTTP: the ``priority_class`` body field and the ``X-Priority-Class``
  header, the 400 for an unknown class, the class-labelled series and
  ``/debug/requests`` columns, and the unlabelled shape with policy off.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.serving import ClassTable as JClassTable
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving import PolicyScheduler as JPolicyScheduler
from paddle_tpu.serving import VirtualClock as JVirtualClock
from paddle_tpu.serving import decode as jdec
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           load_decode_params)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      FIFOScheduler, GenerationRequest,
                                      VirtualClock)
from paddle_tpu_torch.serving.policy import (ClassTable, PolicyScheduler,
                                             PriorityClass, select_victims,
                                             victim_key)
from paddle_tpu_torch.serving.server import serve

from test_metrics_prom import parse_prometheus
from torch_threads import one_torch_thread  # noqa: F401

BS = 8       # KV block size
CHUNK = 16   # chunked-prefill budget
SLOTS = 2
S_MAX = 96

#: the canonical three-way split the reference documents
SPEC = dict(classes="latency:1,standard,batch*",
            slo_ttft_ms="80,400,0", slo_tpot_ms="50,0,0")
#: the same tiers without reserved headroom: the preemption cases want
#: batch work able to fill every slot first
SPEC_NO_RESERVE = dict(SPEC, classes="latency,standard,batch*")
STATS = ("policy_preemptions", "preemptions", "restores", "prefills",
         "tokens_generated", "decode_calls")


@pytest.fixture(scope="module")
def models():
    paddle.seed(33)
    jm = JLlama(j_tiny(decode_attention="jnp"))
    p, tied = jdec.llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


def _prompt(seed, n=12):
    return np.random.RandomState(seed).randint(0, 256, (n,)).astype(np.int32)


def _req(ps, n=12, **kw):
    kw.setdefault("max_new_tokens", 8)
    return GenerationRequest(prompt=_prompt(ps, n), **kw)


def _rq(ps, n=12, **kw):
    """A request as a dict, for either package."""
    kw.setdefault("max_new_tokens", 8)
    return dict(prompt=_prompt(ps, n), **kw)


#: per side: (engine class, request class, clock class, class-table class)
SIDES = {"port": (ContinuousBatchingEngine, GenerationRequest,
                  VirtualClock, ClassTable),
         "jax": (JEngine, JRequest, JVirtualClock, JClassTable)}


def _engine(models, side, **kw):
    jm, tm = models
    E = SIDES[side][0]
    m = tm if side == "port" else jm
    if side == "jax":
        kw.setdefault("jit_cache", jm.__dict__.setdefault("_pol_jit", {}))
    for k, v in dict(num_slots=SLOTS, max_seq_len=S_MAX, decode_chunk=1,
                     prefix_cache=True, prefix_block_size=BS,
                     prefill_chunk=CHUNK, headroom_mult=None).items():
        kw.setdefault(k, v)
    return E(m, **kw)


def _baseline(models, reqs):
    """Policy-off port streams for the same requests, one at a time."""
    return [_engine(models, "port").generate(
        [GenerationRequest(**dict(r, priority_class=None))])[0].tolist()
        for r in reqs]


def _drive(eng, clk, dt=0.001):
    while eng.has_work():
        eng.step()
        clk.advance(dt)


# ------------------------------------------------------- class table units
class TestClassTable:
    def test_parse_canonical_three_way_spec(self):
        t = ClassTable.parse(**SPEC)
        assert [c.name for c in t] == ["latency", "standard", "batch"]
        assert [c.rank for c in t] == [2, 1, 0]
        lat, std, bat = t.classes
        assert lat.reserved_slots == 1 and std.reserved_slots == 0
        assert lat.ttft_slo_s == pytest.approx(0.08)
        assert std.ttft_slo_s == pytest.approx(0.4)
        assert bat.ttft_slo_s is None
        assert lat.tpot_slo_s == pytest.approx(0.05)
        assert t.default == "batch"
        assert t.active
        assert t.doc() == JClassTable.parse(**SPEC).doc()

    def test_parse_default_falls_to_last_and_rejects_bad_specs(self):
        assert ClassTable.parse("gold,best-effort").default == "best-effort"
        with pytest.raises(ValueError, match="two defaults"):
            ClassTable.parse("a*,b*")
        with pytest.raises(ValueError, match="bad class name"):
            ClassTable.parse("a,!b")
        with pytest.raises(ValueError, match="duplicate"):
            ClassTable.parse("a,a")
        with pytest.raises(ValueError, match="targets"):
            ClassTable.parse("a,b", slo_ttft_ms="1,2,3")
        with pytest.raises(ValueError, match=">= 0"):
            ClassTable.parse("a,b", slo_ttft_ms="-5")

    def test_resolve_unknown_is_the_400_valueerror(self):
        t = ClassTable.parse(**SPEC)
        assert t.resolve(None).name == "batch"
        assert t.resolve("latency").rank == 2
        with pytest.raises(ValueError, match="unknown priority_class"):
            t.resolve("gold")
        with pytest.raises(ValueError, match="batch.*latency.*standard"):
            t.resolve("gold")

    def test_neutral_single_table_is_inactive(self):
        assert not ClassTable.single().active
        assert not ClassTable.coerce(None).active
        assert not ClassTable.parse("standard").active
        assert ClassTable.parse("standard", slo_ttft_ms="100").active
        assert ClassTable.parse("standard:1").active
        assert ClassTable.parse("a,b").active


# ----------------------------------------------------- victim choice units
class _Slot:
    def __init__(self, rid, rank, t_admitted, ntok, done=False):
        self.request_id = rid
        self.pclass = PriorityClass(f"c{rank}", rank=rank)
        self.t_admitted = t_admitted
        self.tokens = [0] * ntok
        self.done = done


class TestVictimSelection:
    def test_lowest_class_then_most_recent_then_least_work(self):
        slots = [
            _Slot(1, rank=1, t_admitted=1.0, ntok=2),
            _Slot(2, rank=0, t_admitted=5.0, ntok=9),
            _Slot(3, rank=0, t_admitted=9.0, ntok=4),
            _Slot(4, rank=0, t_admitted=9.0, ntok=2),
            None,
            _Slot(5, rank=0, t_admitted=99.0, ntok=0, done=True),
        ]
        got = select_victims(slots, 3, below_rank=2)
        assert [s.request_id for s in got] == [4, 3, 2]
        assert select_victims(slots, 1, below_rank=1)[0].request_id == 4
        assert select_victims(slots, 9, below_rank=0) == []

    def test_victim_key_total_order_is_deterministic(self):
        a = _Slot(7, rank=0, t_admitted=3.0, ntok=5)
        b = _Slot(8, rank=0, t_admitted=3.0, ntok=5)
        assert victim_key(a) != victim_key(b)
        assert sorted([b, a], key=victim_key)[0].request_id == 8


# ------------------------------------------------- policy scheduler units
class _Q:
    _next_id = 0

    def __init__(self, pclass, t_submit, work_len=12):
        _Q._next_id += 1
        self.request_id = _Q._next_id
        self.pclass = pclass
        self.t_submit = t_submit
        self.work_len = work_len
        self.prefix_hit_tokens = 0
        self.done = False


def _sched(table, clk, **kw):
    return PolicyScheduler(decode_chunk=1, table=table, clock=clk, **kw)


class TestPolicyScheduler:
    def test_admission_orders_by_class_then_slack_then_fifo(self):
        t = ClassTable.parse(**SPEC_NO_RESERVE)
        clk = VirtualClock()
        s = _sched(t, clk)
        lat, std, bat = t.classes
        old_std = _Q(std, t_submit=0.0)
        new_std = _Q(std, t_submit=0.2)
        b1, b2 = _Q(bat, t_submit=0.0), _Q(bat, t_submit=0.1)
        late_lat = _Q(lat, t_submit=0.3)
        for q in (b1, b2, old_std, new_std, late_lat):
            s.submit(q)
        clk.advance(0.35)
        assert s.admissions(5) == [late_lat, old_std, new_std, b1, b2]
        assert s.num_queued == 0

    def test_single_class_collapses_to_exact_fifo(self):
        clk = VirtualClock()
        s = _sched(ClassTable.single(), clk)
        f = FIFOScheduler(decode_chunk=1)
        std = ClassTable.single().classes[0]
        qs = [_Q(std, t_submit=0.01 * i) for i in range(6)]
        for q in qs:
            s.submit(q)
            f.submit(q)
        clk.advance(1.0)
        assert s.admissions(4) == f.admissions(4)
        assert s.admissions(4) == f.admissions(4)

    def test_aging_promotes_starved_batch_one_rank_per_quantum(self):
        t = ClassTable.parse("latency,batch*", slo_ttft_ms="500,0",
                             aging_s=10.0)
        clk = VirtualClock()
        s = _sched(t, clk)
        lat, bat = t.classes
        starved = _Q(bat, t_submit=0.0)
        s.submit(starved)
        s.submit(_Q(lat, t_submit=0.0))
        clk.advance(5.0)
        assert s.effective_rank(starved, clk()) == 0
        assert [q.pclass.name for q in s.admissions(1)] == ["latency"]
        s.submit(_Q(lat, t_submit=clk()))
        clk.advance(7.0)
        assert s.effective_rank(starved, clk()) == 1
        assert [q.pclass.name for q in s.admissions(1)] == ["latency"]
        s.submit(_Q(lat, t_submit=clk()))
        clk.advance(9.0)
        assert s.effective_rank(starved, clk()) == 2
        assert s.admissions(1) == [starved]

    def test_reserved_headroom_holds_slots_for_the_reserving_class(self):
        t = ClassTable.parse("latency:1,batch*")
        clk = VirtualClock()
        running = {"latency": 0}
        s = _sched(t, clk, slot_usage=lambda: dict(running))
        lat, bat = t.classes
        flood = [_Q(bat, t_submit=0.0) for _ in range(3)]
        for q in flood:
            s.submit(q)
        assert s.admissions(2) == flood[:1]
        assert s.num_queued == 2
        hot = _Q(lat, t_submit=0.0)
        s.submit(hot)
        assert s.admissions(1) == [hot]
        running["latency"] = 1
        assert s.admissions(2) == flood[1:]

    def test_urgent_names_only_ttft_classes_past_the_fraction(self):
        t = ClassTable.parse(**SPEC)
        clk = VirtualClock()
        s = _sched(t, clk)
        lat, std, bat = t.classes
        hot = _Q(lat, t_submit=0.0)
        warm = _Q(lat, t_submit=0.05)
        never = _Q(bat, t_submit=0.0)
        for q in (hot, warm, never):
            s.submit(q)
        clk.advance(0.041)
        assert s.urgent() == [hot]
        clk.advance(0.05)
        assert s.urgent() == [hot, warm]
        with pytest.raises(ValueError, match="urgency_frac"):
            _sched(t, clk, urgency_frac=0.0)

    def test_queue_object_identity_survives_admission(self):
        t = ClassTable.parse("a,b*")
        s = _sched(t, VirtualClock())
        q0 = s.queue
        for q in [_Q(t.classes[1], 0.0) for _ in range(3)]:
            s.submit(q)
        s.admissions(2)
        assert s.queue is q0 and len(s.queue) == 1

    def test_random_schedule_admits_as_jax(self):
        """One random schedule of submissions, clock advances, admissions
        (with a running-count ledger) and urgency probes through both
        packages' schedulers: the same sequences in the same order at
        every call."""
        r = np.random.RandomState(8)
        spec = dict(classes="latency:1,standard,batch*",
                    slo_ttft_ms="80,400,0", aging_s=0.5)
        tables = {"port": ClassTable.parse(**spec),
                  "jax": JClassTable.parse(**spec)}
        clocks = {"port": VirtualClock(), "jax": JVirtualClock()}
        running = {}
        scheds = {side: (PolicyScheduler if side == "port"
                         else JPolicyScheduler)(
            decode_chunk=1, table=tables[side], clock=clocks[side],
            slot_usage=lambda: dict(running)) for side in tables}
        made = {"port": [], "jax": []}
        for step in range(300):
            roll = r.rand()
            if roll < 0.45:
                name = ("latency", "standard", "batch")[int(r.randint(3))]
                for side in scheds:
                    q = _Q(tables[side].resolve(name), clocks[side]())
                    q.request_id = step
                    made[side].append(q)
                    scheds[side].submit(q)
            elif roll < 0.75:
                n = int(r.randint(0, 3))
                got = [q.request_id for q in scheds["port"].admissions(n)]
                want = [q.request_id for q in scheds["jax"].admissions(n)]
                assert got == want, step
                for rid in got:
                    c = next(q for q in made["port"]
                             if q.request_id == rid).pclass.name
                    running[c] = running.get(c, 0) + 1
            elif roll < 0.85:
                assert [q.request_id for q in scheds["port"].urgent()] == \
                    [q.request_id for q in scheds["jax"].urgent()], step
            else:
                dt = float(r.choice([0.001, 0.02, 0.1, 0.6]))
                for clk in clocks.values():
                    clk.advance(dt)
                if running and r.rand() < 0.5:
                    c = list(running)[int(r.randint(len(running)))]
                    running[c] = max(running[c] - 1, 0)


# -------------------------------------------------- engine-level behavior
def _engine_urgent_case(models, side):
    """Two batch rows running mid-decode, then a latency request that
    burns past half its TTFT budget: one batch row is displaced."""
    E, R, Clock, Table = SIDES[side]
    clk = Clock()
    reqs = [_rq(6, max_new_tokens=16, priority_class="batch"),
            _rq(7, max_new_tokens=16, temperature=0.9, top_k=5, seed=123,
                priority_class="batch"),
            _rq(8, n=8, max_new_tokens=4, priority_class="latency")]
    eng = _engine(models, side, step_clock=clk,
                  priority_classes=Table.parse(**SPEC_NO_RESERVE))
    b1, b2 = eng.submit(R(**reqs[0])), eng.submit(R(**reqs[1]))
    for _ in range(3):
        eng.step()
        clk.advance(0.001)
    running = (b1.status, b2.status)
    lat = eng.submit(R(**reqs[2]))
    before = eng.stats["policy_preemptions"]
    clk.advance(0.05)           # 50 ms >= 80 ms * 0.5: urgent now
    eng.step()
    after = eng.stats["policy_preemptions"]
    victims = [s.status for s in (b1, b2)].count("queued")
    admitted = lat.slot is not None
    _drive(eng, clk)
    return dict(reqs=reqs, running=running, before=before, after=after,
                victims=victims, admitted=admitted,
                tokens=[list(map(int, s.tokens)) for s in (b1, b2, lat)],
                reasons=[s.finish_reason for s in (b1, b2, lat)],
                stats={k: eng.stats[k] for k in STATS},
                decode=eng.decode_compilations(),
                free=eng.cache.num_free == eng.num_slots)


def _equals_case(models, side):
    E, R, Clock, Table = SIDES[side]
    clk = Clock()
    eng = _engine(models, side, step_clock=clk,
                  priority_classes=Table.parse(**SPEC))
    hogs = [eng.submit(R(**_rq(10 + i, max_new_tokens=10,
                                priority_class="latency")))
            for i in range(SLOTS)]
    eng.step()
    clk.advance(0.001)
    waiter = eng.submit(R(**_rq(15, priority_class="latency")))
    clk.advance(1.0)
    eng.step()
    mid = (eng.stats["policy_preemptions"], [h.status for h in hogs])
    _drive(eng, clk)
    return dict(mid=mid, reason=waiter.finish_reason,
                tokens=[list(map(int, s.tokens)) for s in hogs + [waiter]],
                stats={k: eng.stats[k] for k in STATS})


def _chaos_case(models, side):
    E, R, Clock, Table = SIDES[side]
    clk = Clock()
    eng = _engine(models, side, step_clock=clk,
                  priority_classes=Table.parse(**SPEC_NO_RESERVE))
    seqs = [eng.submit(R(**_rq(20 + i, max_new_tokens=12,
                                priority_class="batch")))
            for i in range(3)]
    for _ in range(2):
        eng.step()
        clk.advance(0.002)
    seqs.append(eng.submit(R(**_rq(30, max_new_tokens=6, temperature=0.8,
                                    top_k=7, seed=11,
                                    priority_class="standard"))))
    seqs.append(eng.submit(R(**_rq(31, n=8, max_new_tokens=4,
                                    priority_class="latency"))))
    clk.advance(0.06)
    for _ in range(4):
        eng.step()
        clk.advance(0.02)
    seqs.append(eng.submit(R(**_rq(32, n=8, max_new_tokens=4,
                                    priority_class="latency"))))
    _drive(eng, clk, dt=0.02)
    return ([list(map(int, s.tokens)) for s in seqs],
            [s.finish_reason for s in seqs],
            {k: eng.stats[k] for k in STATS})


_JAX = {}


def _jax_case(models, fn):
    if fn.__name__ not in _JAX:
        _JAX[fn.__name__] = fn(models, "jax")
    return _JAX[fn.__name__]


class TestEnginePolicy:
    def test_default_engine_keeps_fifo_and_streams_byte_identical(
            self, models):
        reqs = [_rq(1), _rq(2, temperature=0.9, top_k=5, seed=123)]
        want = _baseline(models, reqs)
        eng = _engine(models, "port", priority_classes="standard")
        assert type(eng.scheduler) is FIFOScheduler
        assert not eng.classes.active
        got = [eng.generate([GenerationRequest(**r)])[0].tolist()
               for r in reqs]
        assert got == want
        assert eng.stats["policy_preemptions"] == 0

    def test_labeled_requests_resolve_and_unknown_is_valueerror(
            self, models):
        eng = _engine(models, "port",
                      priority_classes=ClassTable.parse(**SPEC))
        assert isinstance(eng.scheduler, PolicyScheduler)
        seq = eng.submit(_req(3, priority_class="latency"))
        assert seq.pclass.name == "latency" and seq.pclass.rank == 2
        unlabeled = eng.submit(_req(4))
        assert unlabeled.pclass.name == "batch"
        with pytest.raises(ValueError, match="unknown priority_class"):
            eng.submit(_req(5, priority_class="gold"))
        _drive(eng, VirtualClock())

    def test_slo_urgent_latency_preempts_batch_byte_identically(
            self, models):
        """An urgent latency request displaces running batch work by
        recompute; all three streams (greedy batch, seeded batch,
        latency) equal their policy-off runs and the JAX engine's on the
        same schedule, with JAX's policy and preemption stats."""
        got = _engine_urgent_case(models, "port")
        want = _jax_case(models, _engine_urgent_case)
        assert got["running"] == ("running", "running")
        assert got["before"] == 0 and got["after"] == 1
        assert got["victims"] == 1 and got["admitted"]
        assert got["tokens"] == [_baseline(models, [r])[0]
                                 for r in got["reqs"]]
        for k in ("running", "before", "after", "victims", "admitted",
                  "tokens", "reasons", "stats", "decode"):
            assert got[k] == want[k], k
        assert got["stats"]["restores"] >= 1
        assert got["decode"] == 1 and got["free"]

    def test_equals_never_displace_equals(self, models):
        got = _equals_case(models, "port")
        want = _jax_case(models, _equals_case)
        assert got["mid"] == (0, ["running"] * SLOTS)
        assert got["reason"] == "length"
        assert got == want

    def test_mixed_class_chaos_matrix_replays_deterministically(
            self, models):
        first, second = _chaos_case(models, "port"), \
            _chaos_case(models, "port")
        assert first == second
        assert first == _jax_case(models, _chaos_case)
        toks, reasons, stats = first
        assert all(r in ("length", "stop") for r in reasons)
        assert stats["policy_preemptions"] >= 1
        assert stats["restores"] >= stats["policy_preemptions"]


# ------------------------------------------------------ HTTP + metrics
def _post(server, payload, headers=(), timeout=120):
    body = json.dumps(payload).encode()
    req = urllib.request.Request(
        server.url + "/v1/completions", data=body,
        headers={"Content-Type": "application/json", **dict(headers)})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _get(server, path, timeout=10):
    with urllib.request.urlopen(server.url + path, timeout=timeout) as r:
        return r.read().decode()


@pytest.fixture(scope="module")
def policy_server(models):
    srv = serve(models[1], port=0, num_slots=SLOTS, max_seq_len=S_MAX,
                max_queue=8, model_name="slo-test", **SPEC)
    yield srv
    srv.shutdown(drain=False, timeout=30)


class TestPolicyHTTP:
    def test_unknown_priority_class_is_a_400_not_a_crash(
            self, policy_server):
        status, doc = _post(policy_server, {
            "prompt": _prompt(40).tolist(), "max_tokens": 2,
            "priority_class": "gold"})
        assert status == 400
        assert doc["error"]["type"] == "invalid_request"
        assert "unknown priority_class" in doc["error"]["message"]
        status, doc = _post(policy_server, {
            "prompt": _prompt(40).tolist(), "max_tokens": 2})
        assert status == 200

    def test_body_field_and_header_both_select_the_class(
            self, policy_server):
        for extra in ({"priority_class": "latency"}, {}):
            headers = () if extra else (("X-Priority-Class", "latency"),)
            status, doc = _post(policy_server, {
                "prompt": _prompt(41).tolist(), "max_tokens": 3, **extra},
                headers=headers)
            assert status == 200
            assert len(doc["choices"][0]["token_ids"]) == 3

    def test_metrics_scrape_carries_class_labels_and_policy_series(
            self, policy_server):
        _post(policy_server, {"prompt": _prompt(42).tolist(),
                              "max_tokens": 3, "priority_class": "latency"})
        fams = parse_prometheus(_get(policy_server, "/metrics"))
        miss = fams["serving_slo_misses_total"]
        assert miss["type"] == "counter"
        labels = {lab for (_, lab) in miss["samples"]}
        for cls in ("latency", "standard", "batch"):
            for slo in ("ttft", "tpot"):
                assert (("class", cls), ("slo", slo)) in labels
        pre = fams["serving_policy_preemptions_total"]["samples"]
        assert (("serving_policy_preemptions_total",
                 (("victim_class", "batch"),)) in pre)
        ttft = fams["serving_ttft_seconds"]["samples"]
        assert any(name == "serving_ttft_seconds_count"
                   and ("class", "latency") in lab
                   for (name, lab) in ttft)

    def test_policy_off_scrape_keeps_the_unlabeled_shape(self, models):
        srv = serve(models[1], port=0, num_slots=SLOTS, max_seq_len=S_MAX,
                    max_queue=8, model_name="plain")
        try:
            _post(srv, {"prompt": _prompt(43).tolist(), "max_tokens": 2})
            fams = parse_prometheus(_get(srv, "/metrics"))
            assert "serving_slo_misses_total" not in fams
            assert "serving_policy_preemptions_total" not in fams
            ttft = fams["serving_ttft_seconds"]["samples"]
            assert ttft[("serving_ttft_seconds_count", ())] > 0
        finally:
            srv.shutdown(drain=False, timeout=30)

    def test_debug_requests_gains_class_and_slack_columns(
            self, policy_server):
        gw = policy_server.gateway
        hogs = [gw.submit(_req(50 + i, max_new_tokens=40,
                               priority_class="batch"))
                for i in range(SLOTS)]
        waiter = gw.submit(_req(55, max_new_tokens=2,
                                priority_class="latency"))
        deadline = time.monotonic() + 10
        rows = []
        while time.monotonic() < deadline:
            rows = json.loads(_get(policy_server,
                                   "/debug/requests"))["requests"]
            if len(rows) >= 2:
                break
            time.sleep(0.01)
        by_class = {}
        for row in rows:
            assert "class" in row and "slo_slack_s" in row
            by_class.setdefault(row["class"], []).append(row)
        assert "batch" in by_class
        for row in by_class["batch"]:
            assert row["slo_slack_s"] is None
        for s in hogs + [waiter]:
            s.result()
