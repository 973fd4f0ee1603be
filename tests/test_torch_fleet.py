"""The port's engine fleet (``paddle_tpu_torch/serving/fleet``) against the
JAX package, on the CPU, on ``llama_tiny`` with the JAX model's weights
carried across: the cases of tests/test_fleet.py, with
tests/test_tier_cache.py's ``TestFleetCachePlane`` and
tests/test_policy.py's ``TestClassHeadroomRouter``.

- the routers on stub replicas: the reference's orders and tie-breaks;
- routing on a virtual clock replays identically; a full waiting room
  sheds sideways, then 429s;
- program records per pool geometry: same-geometry replicas share one
  dict and each reports the JAX engine's ``decode_compilations()``;
  mixed geometries (``num_slots``, ``prefix_blocks``) keep their own;
  heterogeneous ``max_seq_len`` routes by capacity, and failover skips a
  sibling too small for a request;
- a replica killed mid-decode loses nothing and its streams equal the
  JAX engine's; the kill replays identically; a replica with restart
  budget recovers itself; the last replica's death strands with errors;
- live migration, drain and cordon, and a refused migration that
  recovers locally, streams equal the JAX engine's;
- replica-labelled metrics, monotonic across a rebuild, and the fleet
  table;
- the fleet cache plane: a chain spilled on one replica moves to the
  replica that needs it, streams equal the JAX engine's;
- the class-headroom router and the replicas' class signals;
- the HTTP surface and the CLI (``--replicas 2`` starts and prints its
  banner).

Every stream is held against the JAX engine's stream for the same
requests and weights, each JAX run once per file (``_JAX``). The
fleets run with ``headroom_mult=None``: the adaptive chunk grant reads a
wall clock.
"""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

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
from paddle_tpu_torch.serving import (FaultPlan, GenerationRequest,
                                      PolicyScheduler, VirtualClock)
from paddle_tpu_torch.serving.fleet import (ClassHeadroomRouter,
                                            EngineFleet, LeastLoadedRouter,
                                            PrefixAffinityRouter,
                                            RoundRobinRouter, make_router)
from paddle_tpu_torch.serving.policy import ClassTable
from paddle_tpu_torch.serving.server import QueueFullError, serve_fleet

from test_metrics_prom import parse_prometheus
from torch_threads import one_torch_thread  # noqa: F401

BS = 8       # KV block size
CHUNK = 16   # chunked-prefill budget (2 blocks)
SLOTS = 2    # per replica
S_MAX = 96
TIER = 1 << 24   # a host budget the LRU never trims here
#: tests/test_policy.py's three-way class split
SPEC = dict(classes="latency:1,standard,batch*",
            slo_ttft_ms="80,400,0", slo_tpot_ms="50,0,0")


@pytest.fixture(scope="module")
def models():
    paddle.seed(33)
    jm = JLlama(j_tiny(decode_attention="jnp"))
    p, tied = llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


def _prompt(seed, n=12):
    return np.random.RandomState(seed).randint(0, 256, (n,)).astype(np.int32)


def _req(ps, n=12, **kw):
    """A request as keywords (either package's GenerationRequest)."""
    kw.setdefault("max_new_tokens", 8)
    return dict(prompt=_prompt(ps, n), **kw)


def _R(r):
    return GenerationRequest(**r)


#: the standard mixed workload: greedy shorts, one seeded-sampled row,
#: one long prompt that chunks (60 > CHUNK)
def _traffic():
    return [_req(1), _req(2, n=10),
            _req(3, temperature=0.9, top_k=5, seed=123),
            _req(4, n=60, max_new_tokens=5)]


_JAX = {}


def _key(reqs, **kw):
    return (tuple((r["prompt"].tobytes(), tuple(sorted(
        (k, v) for k, v in r.items() if k != "prompt"))) for r in reqs),
        tuple(sorted(kw.items())))


def _jax(models, reqs, serial=False, **kw):
    """The JAX engine's streams for ``reqs`` (one engine, the fleet's
    replica geometry), each request matrix and knob set run once per
    file. ``serial``: one request at a time."""
    key = _key(reqs, serial=serial, **kw)
    if key not in _JAX:
        jm = models[0]
        g = dict(num_slots=SLOTS, max_seq_len=S_MAX, decode_chunk=1,
                 prefix_cache=True, prefix_block_size=BS,
                 prefill_chunk=CHUNK, headroom_mult=None,
                 jit_cache=jm.__dict__.setdefault("_fleet_jit", {}))
        g.update(kw)
        eng = JEngine(jm, **g)
        if serial:
            outs = [eng.generate([JRequest(**r)])[0] for r in reqs]
        else:
            outs = eng.generate([JRequest(**r) for r in reqs])
        _JAX[key] = ([o.tolist() for o in outs],
                     [o.finish_reason for o in outs],
                     eng.decode_compilations())
    return _JAX[key]


def _fleet(models, **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("router", "round-robin")
    kw.setdefault("num_slots", SLOTS)
    kw.setdefault("max_seq_len", S_MAX)
    kw.setdefault("prefix_block_size", BS)
    kw.setdefault("prefill_chunk", CHUNK)
    kw.setdefault("max_queue", 32)
    kw.setdefault("retry_backoff_s", 0.0)
    kw.setdefault("headroom_mult", None)
    kw.setdefault("start", False)
    return EngineFleet(models[1], **kw)


def _await(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert pred(), "condition not reached before timeout"


def _run(fleet, reqs):
    """Submit ``reqs`` in order, start the drivers, return the streams
    and finish reasons."""
    streams = [fleet.submit(_R(r)) for r in reqs]
    fleet.start()
    outs = [st.result() for st in streams]
    return [ids.tolist() for ids, _ in outs], [r for _, r in outs]


# ----------------------------------------------------------- router units
class _StubReplica:
    """Router-facing stand-in: fixed load, per-prompt match table and
    class pressure."""

    def __init__(self, index, load, matches=(), pressure=0):
        self.index = index
        self._load = load
        self._matches = dict(matches)
        self._pressure = pressure
        self.routable = True
        self.alive = True

    def load(self):
        return self._load

    def prefix_match_tokens(self, prompt):
        return self._matches.get(bytes(np.asarray(prompt)), 0)

    def class_pressure(self, request):
        return self._pressure


class TestRouterPolicies:
    def test_least_loaded_ties_break_to_lowest_index(self):
        reps = [_StubReplica(2, 5), _StubReplica(0, 5), _StubReplica(1, 3)]
        r = LeastLoadedRouter()
        assert [x.index for x in r.rank(_R(_req(1)), reps)] == [1, 0, 2]
        reps = [_StubReplica(i, 7) for i in (2, 1, 0)]
        assert [x.index for x in r.rank(_R(_req(1)), reps)] == [0, 1, 2]

    def test_affinity_wins_only_within_the_load_band(self):
        req = _R(_req(5))
        key = bytes(np.asarray(req.prompt))
        warm_near = _StubReplica(1, load=4, matches={key: 32})
        cold_min = _StubReplica(0, load=0)
        warm_far = _StubReplica(2, load=40, matches={key: 64})
        order = PrefixAffinityRouter(band=16).rank(
            req, [cold_min, warm_near, warm_far])
        assert [x.index for x in order] == [1, 0, 2]
        r0 = PrefixAffinityRouter(band=0)
        assert [x.index for x in r0.rank(
            req, [cold_min, warm_near, warm_far])][0] == 0

    def test_affinity_ties_break_by_load_then_index(self):
        req = _R(_req(6))
        key = bytes(np.asarray(req.prompt))
        a = _StubReplica(0, load=2, matches={key: 16})
        b = _StubReplica(1, load=1, matches={key: 16})
        c = _StubReplica(2, load=1, matches={key: 16})
        order = PrefixAffinityRouter(band=16).rank(req, [a, b, c])
        assert [x.index for x in order] == [1, 2, 0]

    def test_round_robin_rotates(self):
        reps = [_StubReplica(i, 0) for i in range(3)]
        r = RoundRobinRouter()
        heads = [r.rank(_R(_req(1)), reps)[0].index for _ in range(6)]
        assert heads == [0, 1, 2, 0, 1, 2]

    def test_make_router(self):
        assert isinstance(make_router("least-loaded"), LeastLoadedRouter)
        assert make_router("affinity", band=3).band == 3
        custom = RoundRobinRouter()
        assert make_router(custom) is custom
        with pytest.raises(ValueError, match="unknown router"):
            make_router("random")
        with pytest.raises(ValueError, match="band"):
            PrefixAffinityRouter(band=-1)


# ------------------------------------------------- routing determinism
class TestRoutingDeterminism:
    def test_virtual_clock_replay_routes_identically(self, models):
        """Policies read replica state only: the same submission order
        over a VirtualClock fleet gives the same decision log and the
        same streams twice — the JAX engine's."""
        reqs = _traffic()
        want, reasons, _ = _jax(models, reqs)
        runs = []
        for _ in range(2):
            fleet = _fleet(models, router="least-loaded",
                           clock=VirtualClock())
            got = _run(fleet, reqs)
            runs.append(([i for _, i in fleet.decisions], got))
            fleet.shutdown(drain=True, timeout=30)
        assert runs[0] == runs[1]
        assert runs[0][1] == (want, reasons)

    def test_full_waiting_room_sheds_sideways_then_429s(self, models):
        fleet = _fleet(models, router="least-loaded", max_queue=1)
        fleet.submit(_R(_req(1)))           # r0 full (driver stopped)
        st2 = fleet.submit(_R(_req(2)))     # sheds to r1
        assert fleet.decisions[1][1] != fleet.decisions[0][1]
        with pytest.raises(QueueFullError):
            fleet.submit(_R(_req(3)))       # every replica full: 429
        assert st2.gateway is fleet.replicas[
            fleet.decisions[1][1]].gateway
        fleet.start()
        fleet.shutdown(drain=True, timeout=30)


# ------------------------------------------ program records per geometry
class TestFleetCompileDiscipline:
    def test_same_geometry_shares_one_program_dict(self, models):
        """Same-geometry replicas share one program-record dict, and each
        engine reports the JAX engine's decode_compilations() (1) after
        serving the traffic."""
        reqs = _traffic()
        want, reasons, j_compiles = _jax(models, reqs)
        fleet = _fleet(models)
        e0 = fleet.replicas[0].gateway.engine
        e1 = fleet.replicas[1].gateway.engine
        assert e0._jit is e1._jit
        assert _run(fleet, reqs) == (want, reasons)
        assert e0.decode_compilations() == j_compiles == 1
        assert e1.decode_compilations() == 1
        fleet.shutdown(drain=True, timeout=30)

    @pytest.mark.parametrize("knob", [
        dict(num_slots=[SLOTS, SLOTS + 1]),
        dict(prefix_blocks=[8, 16])], ids=["num_slots", "prefix_blocks"])
    def test_mixed_geometry_keeps_dicts_apart(self, models, knob):
        """A geometry knob that differs between replicas (slots, or the
        trie budget that sizes the pool) gives each its own dict, and
        each engine still reports one decode program."""
        reqs = _traffic()
        want, reasons, _ = _jax(models, reqs)
        fleet = _fleet(models, **knob)
        e0 = fleet.replicas[0].gateway.engine
        e1 = fleet.replicas[1].gateway.engine
        assert e0._jit is not e1._jit
        assert _run(fleet, reqs) == (want, reasons)
        assert e0.decode_compilations() == 1
        assert e1.decode_compilations() == 1
        fleet.shutdown(drain=True, timeout=30)

    def test_heterogeneous_max_seq_len_routes_by_capacity(self, models):
        """A request only one replica can hold routes there (not a 400
        off the small replica)."""
        big = _req(41, n=40, max_new_tokens=20)    # 60 rows
        small = _req(42, n=8, max_new_tokens=4)
        want, reasons, _ = _jax(models, [big, small])
        fleet = _fleet(models, max_seq_len=[S_MAX, 32],
                       router="least-loaded")
        st_big = fleet.submit(_R(big))
        st_small = fleet.submit(_R(small))
        assert st_big.gateway is fleet.replicas[0].gateway  # the only fit
        fleet.start()
        outs = [st.result() for st in (st_big, st_small)]
        assert [ids.tolist() for ids, _ in outs] == want
        assert [r for _, r in outs] == reasons
        fleet.shutdown(drain=True, timeout=30)

    def test_failover_skips_too_small_sibling(self, models):
        """A dying replica's oversized request ends with an error (no
        sibling can hold it) while its holdable bystander fails over —
        never a crash loop on the sibling."""
        big = _req(43, n=40, max_new_tokens=20)    # 60 rows > 32
        ok = _req(44, n=8, max_new_tokens=4)
        fleet = _fleet(models, max_seq_len=[S_MAX, 32],
                       router="least-loaded", max_restarts=0,
                       fault_hooks=[FaultPlan().at_step(3, "fatal"), None])
        st_big = fleet.submit(_R(big))
        st_ok = fleet.submit(_R(ok))
        assert st_big.gateway is fleet.replicas[0].gateway
        fleet.start()
        with pytest.raises(RuntimeError):
            st_big.result()
        assert st_big.finish_reason == "error"
        _, reason = st_ok.result()
        assert reason in ("length", "stop")
        assert fleet.replicas[1].state in ("ok", "degraded")
        assert fleet.replicas[1].gateway.restarts == 0
        fleet.shutdown(drain=True, timeout=30)


# --------------------------------------------------- failover to a sibling
class TestFailoverToSibling:
    def test_replica_kill_mid_decode_zero_lost(self, models):
        """A replica whose supervision is exhausted mid-decode loses no
        request: its streams (greedy and seeded-sampled, the chunked long
        prompt too) fail over and finish as the JAX engine's do."""
        reqs = _traffic()
        want, reasons, _ = _jax(models, reqs)
        fleet = _fleet(models, max_restarts=0,
                       fault_hooks=[FaultPlan().at_step(3, "fatal"), None])
        assert _run(fleet, reqs) == (want, reasons)
        assert fleet.replicas[0].state == "dead"
        assert fleet.replicas[1].state in ("ok", "degraded")
        assert fleet._m_failovers.value() == 1
        assert fleet._m_migrated.value(cause="failover") >= 1
        assert fleet.health_state == "degraded"
        fleet.shutdown(drain=True, timeout=30)

    def test_kill_replay_is_deterministic(self, models):
        """The same kill plan over the same submission order gives the
        same decisions, fault log and streams (the JAX engine's)."""
        reqs = _traffic()
        want, reasons, _ = _jax(models, reqs)
        runs = []
        for _ in range(2):
            plan = FaultPlan().at_step(3, "fatal")
            fleet = _fleet(models, max_restarts=0, fault_hooks=[plan, None])
            got = _run(fleet, reqs)
            runs.append(([i for _, i in fleet.decisions], plan.log, got))
            fleet.shutdown(drain=True, timeout=30)
        assert runs[0] == runs[1]
        assert runs[0][2] == (want, reasons)

    def test_intra_replica_recovery_never_escalates(self, models):
        """With restart budget the replica recovers itself: no failover,
        streams equal, one decode program on the rebuilt engine."""
        reqs = _traffic()
        want, reasons, _ = _jax(models, reqs)
        fleet = _fleet(models, max_restarts=8,
                       fault_hooks=[FaultPlan().at_step(3, "fatal"), None])
        assert _run(fleet, reqs) == (want, reasons)
        rep0 = fleet.replicas[0]
        assert rep0.state != "dead"
        assert rep0.gateway.restarts == 1
        assert rep0.gateway.engine.decode_compilations() == 1
        assert fleet._m_failovers.value() == 0
        fleet.shutdown(drain=True, timeout=30)

    def test_last_replica_death_strands_with_errors_not_hangs(self, models):
        fleet = _fleet(models, replicas=1, max_restarts=0,
                       fault_hooks=[FaultPlan().at_step(2, "fatal")])
        streams = [fleet.submit(_R(r)) for r in _traffic()]
        fleet.start()
        for st in streams:
            with pytest.raises(RuntimeError):
                st.result()
        assert all(st.finish_reason == "error" for st in streams)
        assert fleet.health_state == "draining"


# ----------------------------------------------------- live migration
class TestLiveMigration:
    def test_migrate_mid_decode(self, models):
        req = _req(7, max_new_tokens=40)
        (want,), (reason,), _ = _jax(models, [req])
        fleet = _fleet(models, router="least-loaded", start=True)
        st = fleet.submit(_R(req))
        _await(lambda: st.seq is not None and len(st.seq.tokens) >= 8)
        source = st.gateway
        fleet.migrate(st, target=1)
        ids, got_reason = st.result()
        assert ids.tolist() == want and got_reason == reason == "length"
        assert st.gateway is fleet.replicas[1].gateway
        assert st.gateway is not source
        assert fleet._m_migrated.value(cause="migration") == 1
        eng = fleet.replicas[0].gateway.engine
        _await(lambda: eng.cache.num_free == SLOTS)
        fleet.shutdown(drain=True, timeout=30)

    def test_drain_replica_migrates_and_cordons(self, models):
        reqs = [_req(i, max_new_tokens=30) for i in (11, 12, 13, 14)]
        want, reasons, _ = _jax(models, reqs)
        fleet = _fleet(models, router="round-robin", start=True)
        streams = [fleet.submit(_R(r)) for r in reqs]
        _await(lambda: any(st.seq is not None and st.seq.tokens
                           for st in streams))
        moved = fleet.drain_replica(0)
        assert not fleet.replicas[0].accepting
        assert fleet.replicas[0].state == "draining"
        outs = [st.result() for st in streams]
        assert [ids.tolist() for ids, _ in outs] == want
        assert [r for _, r in outs] == reasons
        assert moved >= 1
        st = fleet.submit(_R(_req(15)))
        assert st.gateway is fleet.replicas[1].gateway
        fleet.undrain_replica(0)
        assert fleet.replicas[0].routable
        st.result()
        fleet.shutdown(drain=True, timeout=30)

    def test_migration_refused_recovers_locally(self, models):
        req = _req(9, max_new_tokens=30)
        (want,), _, _ = _jax(models, [req])
        fleet = _fleet(models, replicas=1, start=True)
        st = fleet.submit(_R(req))
        _await(lambda: st.seq is not None and len(st.seq.tokens) >= 4)
        fleet.migrate(st)               # nowhere to go
        ids, reason = st.result()
        assert ids.tolist() == want and reason == "length"
        fleet.shutdown(drain=True, timeout=30)


# ------------------------------------------------------- fleet metrics
class TestFleetMetrics:
    def test_replica_labels_and_monotonic_across_rebuild(self, models):
        """One shared registry, every per-replica series labelled by
        replica; one replica's rebuild keeps its counters monotonic (its
        own carried base) while the sibling's never move."""
        reqs = _traffic()
        fleet = _fleet(models, max_restarts=8,
                       fault_hooks=[FaultPlan().at_step(3, "fatal"), None])
        _run(fleet, reqs)
        gw0 = fleet.replicas[0].gateway
        gw1 = fleet.replicas[1].gateway
        assert gw0.restarts == 1 and gw1.restarts == 0
        assert gw0._stat_base["tokens_generated"] > 0
        fams = parse_prometheus(fleet.registry.render())
        restarts = fams["serving_engine_restarts_total"]["samples"]
        assert restarts[("serving_engine_restarts_total",
                         (("replica", "0"),))] == 1
        assert restarts[("serving_engine_restarts_total",
                         (("replica", "1"),))] == 0
        chunks = fams["serving_prefill_chunks_total"]["samples"]
        assert chunks[("serving_prefill_chunks_total",
                       (("replica", "0"),))] == \
            gw0._stat("prefill_chunks") >= \
            gw0._stat_base["prefill_chunks"]
        requests = fams["serving_requests_total"]["samples"]
        assert sum(requests[("serving_requests_total",
                             (("replica", i),))] for i in "01") == len(reqs)
        assert fams["serving_fleet_replicas"]["samples"][
            ("serving_fleet_replicas", ())] == 2
        decided = fams["serving_fleet_router_decisions_total"]["samples"]
        assert sum(decided.values()) == len(reqs)
        fleet.shutdown(drain=True, timeout=30)

    def test_fleet_table_reads_like_the_scrape(self, models):
        fleet = _fleet(models)
        _run(fleet, _traffic())
        rows = fleet.fleet_table()
        assert [r["replica"] for r in rows] == [0, 1]
        for rep, row in zip(fleet.replicas, rows):
            gw = rep.gateway
            assert row["state"] in ("ok", "degraded", "recovering")
            assert row["tokens_generated"] == gw._stat("tokens_generated")
            assert row["dispatches_per_decoded_token"] == round(
                gw.cost.totals["dispatches"]
                / max(gw._stat("tokens_generated"), 1), 4)
            assert row["restarts"] == 0
            assert row["last_rebuild_age_s"] is None
        assert sum(r["tokens_generated"] for r in rows) > 0
        fleet.shutdown(drain=True, timeout=30)


# ------------------------------------------------------ fleet cache plane
#: two 2-block system-prompt families (tests/test_tier_cache.py's)
_FAMS = [np.random.RandomState(200 + f).randint(
    0, 256, (2 * BS,)).astype(np.int32) for f in range(2)]


def _fam_req(fam, tail_seed):
    tail = np.random.RandomState(tail_seed).randint(
        0, 256, (6,)).astype(np.int32)
    return dict(prompt=np.concatenate([_FAMS[fam], tail]), max_new_tokens=6)


class TestFleetCachePlane:
    def test_miss_on_a_hits_siblings_tier(self, models):
        """Round-robin sends family A back to replica 1 after replica 0
        spilled A's chain: the plane moves the chain host-to-host at
        submit, replica 1's admission readmits it as a local tier hit,
        and the streams equal the JAX engine's, one request at a time."""
        reqs = [_fam_req(0, 50), _fam_req(1, 60), _fam_req(1, 61),
                _fam_req(0, 51)]
        want, _, _ = _jax(models, reqs, serial=True, prefix_blocks=2)
        fl = _fleet(models, prefix_blocks=2, max_queue=8,
                    host_tier_bytes=TIER, start=True)
        try:
            got = [fl.submit(_R(r)).result()[0].tolist() for r in reqs]
            assert got == want
            doc = fl.cache_plane_doc()
            assert doc["transfers_total"] >= 2
            assert doc["transfer_bytes_total"] > 0
            rows = {r["replica"]: r for r in doc["replicas"]}
            assert rows[0]["enabled"] and rows[1]["enabled"]
            assert rows[0]["spilled_blocks"] >= 2
            assert rows[1]["tier_transfers_in"] >= 2
            assert rows[1]["tier_hits"] >= 1
            assert rows[1]["readmitted_blocks"] >= 2
            frow = [r for r in fl.fleet_table() if r["replica"] == 1][0]
            assert frow["tier_transfers_in"] >= 2
            fams = parse_prometheus(fl.registry.render())
            s = fams["serving_fleet_tier_transfers_total"]["samples"]
            assert s[("serving_fleet_tier_transfers_total", ())] \
                == doc["transfers_total"]
            s = fams["serving_fleet_tier_transfer_bytes_total"]["samples"]
            assert s[("serving_fleet_tier_transfer_bytes_total", ())] \
                == doc["transfer_bytes_total"]
            co = fl.replicas[1].gateway.cost
            assert co.tier_bytes("peer") == doc["transfer_bytes_total"]
        finally:
            fl.shutdown(drain=True, timeout=60)

    def test_plane_disabled_rows_when_tier_off(self, models):
        fl = _fleet(models, max_queue=8)
        try:
            doc = fl.cache_plane_doc()
            assert doc["transfers_total"] == 0
            assert all(not r["enabled"] for r in doc["replicas"])
            fl.start()
            fl.submit(_R(_fam_req(0, 70))).result()
            assert fl.cache_plane_doc()["transfers_total"] == 0
        finally:
            fl.shutdown(drain=True, timeout=60)


# ------------------------------------------------- class-headroom router
class TestClassHeadroomRouter:
    def test_ranks_by_pressure_then_load_then_index(self):
        r = make_router("class-headroom")
        assert isinstance(r, ClassHeadroomRouter)
        reps = [_StubReplica(0, load=9, pressure=4),
                _StubReplica(1, load=2, pressure=4),
                _StubReplica(2, load=50, pressure=0),
                _StubReplica(3, load=2, pressure=4)]
        assert [x.index for x in r.rank(_R(_req(60)), reps)] == [2, 1, 3, 0]

    def test_fleet_replica_pressure_and_debug_row(self, models):
        """A replica whose slots hold batch work shows no pressure to a
        latency request and full pressure to a batch one; the fleet
        table's rows carry the class columns with the policy on."""
        fleet = _fleet(models, router="class-headroom", max_queue=8,
                       priority_classes=ClassTable.parse(**SPEC))
        try:
            assert fleet.classes.active
            rep = fleet.replicas[0]
            eng = rep.gateway.engine
            assert isinstance(eng.scheduler, PolicyScheduler)
            assert all(r.gateway.engine.classes is fleet.classes
                       for r in fleet.replicas)
            b = eng.submit(_R(_req(61, max_new_tokens=6,
                                   priority_class="batch")))
            eng.step()
            assert rep.class_counts() == {"batch": 1}
            assert rep.class_pressure(
                _R(_req(62, priority_class="latency"))) == 0
            assert rep.class_pressure(
                _R(_req(63, priority_class="batch"))) == 1
            row = rep.row()
            assert row["classes"] == {"batch": 1}
            assert row["policy_preemptions"] == 0
            while eng.has_work():
                eng.step()
            assert b.finish_reason == "length"
        finally:
            fleet.shutdown(drain=False, timeout=30)


# ------------------------------------------------------------ HTTP surface
class TestFleetHTTP:
    @pytest.fixture(scope="class")
    def server(self, models):
        srv = serve_fleet(models[1], replicas=2, port=0, num_slots=SLOTS,
                          max_seq_len=S_MAX, prefix_block_size=BS,
                          prefill_chunk=CHUNK, headroom_mult=None,
                          model_name="fleet-test")
        yield srv
        srv.shutdown(drain=False, timeout=30)

    def _get(self, srv, path):
        with urllib.request.urlopen(srv.url + path, timeout=30) as r:
            return r.status, json.load(r)

    def _post(self, srv, path, obj):
        req = urllib.request.Request(
            srv.url + path, data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)

    def test_routed_completion_and_debug_fleet(self, models, server):
        req = _req(21, max_new_tokens=6)
        (want,), _, _ = _jax(models, [req])
        status, doc = self._post(server, "/v1/completions", {
            "prompt": [int(t) for t in req["prompt"]], "max_tokens": 6})
        assert status == 200
        assert doc["choices"][0]["finish_reason"] == "length"
        assert doc["choices"][0]["token_ids"] == want
        assert doc["id"].startswith("cmpl-r")     # fleet-unique ids
        status, doc = self._get(server, "/debug/fleet")
        assert status == 200
        assert [r["replica"] for r in doc["replicas"]] == [0, 1]
        assert doc["router"] == "affinity"
        for row in doc["replicas"]:
            assert {"state", "live_kv_blocks", "free_kv_blocks",
                    "queue_depth", "dispatches_per_decoded_token",
                    "last_rebuild_age_s", "restarts"} <= set(row)
        status, doc = self._get(server, "/fleet/cacheplane")
        assert status == 200 and len(doc["replicas"]) == 2
        assert doc["transfers_total"] == 0

    def test_healthz_metrics_and_requests_aggregate(self, server):
        status, doc = self._get(server, "/healthz")
        assert status == 200
        assert doc["status"] == "ok"
        assert doc["num_replicas"] == 2 and doc["routable_replicas"] == 2
        assert len(doc["replicas"]) == 2
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=30) as r:
            fams = parse_prometheus(r.read().decode())
        for i in "01":
            assert ("serving_num_slots", (("replica", i),)) in \
                fams["serving_num_slots"]["samples"]
        assert "serving_fleet_replicas" in fams
        status, doc = self._get(server, "/debug/requests")
        assert status == 200 and doc["num_replicas"] == 2
        status, doc = self._get(server, "/debug/profile")
        assert status == 200 and set(doc["replicas"]) == {"0", "1"}
        status, doc = self._get(server, "/debug/trace")
        assert status == 200 and "traceEvents" in doc

    def test_drain_rebalance_endpoints(self, server):
        status, doc = self._post(server, "/fleet/drain", {"replica": 0})
        assert status == 200 and doc["state"] == "draining"
        status, doc = self._get(server, "/healthz")
        assert doc["status"] == "degraded"
        status, doc = self._post(server, "/fleet/drain",
                                 {"replica": 0, "undrain": True})
        assert status == 200 and doc["state"] == "accepting"
        status, doc = self._post(server, "/fleet/rebalance", {})
        assert status == 200 and "migrations_requested" in doc
        with pytest.raises(urllib.error.HTTPError) as ei:
            self._post(server, "/fleet/drain", {"replica": 9})
        assert ei.value.code == 400


# --------------------------------------------------------------- CLI args
class TestFleetCLIArgs:
    def test_bad_num_slots_is_an_argparse_error(self):
        from paddle_tpu_torch.serving.server.__main__ import main
        for argv in (["--num-slots", "abc"],
                     ["--num-slots", ","],
                     ["--num-slots", "8,4"],                 # replicas=1
                     ["--replicas", "3", "--num-slots", "8,4"]):
            with pytest.raises(SystemExit) as ei:
                main(["--device", "cpu"] + argv)
            assert ei.value.code == 2

    def test_replicas_cli_starts_serves_and_drains(self):
        """``--replicas 2`` starts a fleet: its banner names both
        replicas and the router, one completion is served, and SIGTERM
        drains with exit 0."""
        p = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.server",
             "--preset", "tiny", "--port", "0", "--quiet", "--device",
             "cpu", "--replicas", "2", "--num-slots", "2,3"],
            cwd=str(Path(__file__).resolve().parents[1]),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        try:
            banner = json.loads(p.stdout.readline())
            assert banner["replicas"] == 2
            assert banner["router"] == "affinity"
            assert banner["num_slots"] == [2, 3]
            assert "/debug/fleet" in banner["endpoints"]
            body = json.dumps({"prompt": [1, 2, 3],
                               "max_tokens": 4}).encode()
            req = urllib.request.Request(
                banner["listening"] + "/v1/completions", data=body)
            with urllib.request.urlopen(req, timeout=60) as r:
                doc = json.load(r)
            assert len(doc["choices"][0]["token_ids"]) == 4
            p.send_signal(signal.SIGTERM)
            assert p.wait(timeout=60) == 0
        finally:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        assert "# draining fleet" in p.stderr.read()
