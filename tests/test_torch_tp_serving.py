"""The port's tensor-parallel engine as a serving surface, on the CPU,
against the JAX package (``llama_tiny``, the JAX model's weights carried
across, every shard on the CPU):

- the collective ledger: the reference's closed-form pin (one cold
  prefill plus four single-tick steps, ``2L`` reductions each, bytes by
  the wire model to the byte), the JAX engine's ``collectives`` (ops and
  bytes) for the same traffic, the ``tp=1`` run's h2d/d2h totals, and the
  int8/fp byte ratio >= 3 in float32; the launch census counts the
  reductions' wire operations;
- the surfaces: ``serving_collective_bytes_total`` (fp > 0, int8 an
  explicit 0), ``/debug/profile``'s ``collectives`` block, the fleet's
  geometry tail ``(2, "int8", False, False)`` and the CLI banner of
  ``--preset tiny --tp 2 --collective-dtype int8`` (the JAX CLI's but for
  the address and the shards' devices);
- the lifecycle: evict/restore on a sharded engine and the chaos matrix
  (transient → fatal → nan, the nan poisoning the sharded pool), 0
  requests lost, streams equal the uninterrupted run; the host tier
  spilling and readmitting every shard's planes;
- the refusals: the reference's ``test_rejects_bad_configs`` and
  ``test_tp1_int8_collectives_are_inert``, a degree that does not divide
  the MLP's features, and the three knob values the port refused before
  it served them (``collective_dtype="int8"``, ``tp=2``,
  ``collective_overlap=True``) serving the matrix.
"""
import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

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
from paddle_tpu_torch.quantization import collective_wire_bytes
from paddle_tpu_torch.serving import (ContinuousBatchingEngine, FaultPlan,
                                      GenerationRequest)
from paddle_tpu_torch.serving.fleet import EngineFleet
from paddle_tpu_torch.serving.server import ServingGateway

from test_metrics_prom import parse_prometheus
from torch_threads import one_torch_thread  # noqa: F401

BS = 8
CHUNK = 16
SLOTS = 2
S_MAX = 96


@pytest.fixture(scope="module")
def models():
    paddle.seed(33)
    jm = JLlama(j_tiny(decode_attention="jnp"))
    p, tied = jdec.llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu", seed=0)
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


def _engine(model, **kw):
    kw.setdefault("num_slots", SLOTS)
    kw.setdefault("max_seq_len", S_MAX)
    kw.setdefault("decode_chunk", 1)
    kw.setdefault("prefix_block_size", BS)
    kw.setdefault("prefill_chunk", CHUNK)
    kw.setdefault("headroom_mult", None)
    if isinstance(model, JLlama):
        kw.setdefault("jit_cache", model.__dict__.setdefault(
            f"_jit_{sorted((k, str(v)) for k, v in kw.items())}", {}))
        return JEngine(model, **kw)
    return ContinuousBatchingEngine(model, **kw)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n,)).astype(np.int32)


def _traffic():
    return [dict(prompt=_prompt(1, 12), max_new_tokens=5),
            dict(prompt=_prompt(2, 10), max_new_tokens=5),
            dict(prompt=_prompt(3, 12), max_new_tokens=5, temperature=0.9,
                 top_k=5, seed=123),
            dict(prompt=_prompt(4, 40), max_new_tokens=4)]


def _generate(eng, reqs=None):
    return [o.tolist() for o in eng.generate(
        [GenerationRequest(**r) for r in (reqs or _traffic())])]


_BASE = {}


def _base(tm):
    """The tp=1 engine's streams of the traffic (computed once)."""
    if "base" not in _BASE:
        _BASE["base"] = _generate(_engine(tm, prefix_cache=True))
    return _BASE["base"]


# ----------------------------------------------------------------- ledger
def _one_req_run(model, tp, collective_dtype="fp"):
    """One 14-token prompt (one cold prefill, bucket 16) and 5 greedy
    tokens (four single-tick steps), the observatory on."""
    side_jax = isinstance(model, JLlama)
    co = (JCost if side_jax else CostObservatory)()
    eng = _engine(model, tp=tp, collective_dtype=collective_dtype)
    eng.cost = co
    Request = JRequest if side_jax else GenerationRequest
    eng.generate([Request(prompt=np.arange(14, dtype=np.int32) % 100,
                          max_new_tokens=5)])
    return co, eng


@pytest.mark.parametrize("dtype", ["fp", "int8"])
def test_ledger_is_exact_and_the_reference_s(models, dtype):
    """The reference's closed-form pin, the JAX engine's ledger for the
    same traffic (ops and bytes), and the tp=1 run's h2d/d2h totals: the
    shards' arguments and results count once, logically."""
    jm, tm = models
    c = tm.config
    L, hm = c.num_hidden_layers, c.hidden_size
    co1, _ = _one_req_run(tm, 1)
    co2, e2 = _one_req_run(tm, 2, dtype)
    assert co1.collectives == {} and co1.collective_bytes("fp") == 0
    want = 2 * L * collective_wire_bytes(16, hm, 2, dtype)
    want += 4 * 2 * L * collective_wire_bytes(e2._token_budget, hm, 2,
                                              dtype)
    assert co2.collective_bytes(dtype) == want
    assert co2.collectives[dtype]["ops"] == 2 * L * 5
    assert co2.totals["h2d_bytes"] == co1.totals["h2d_bytes"]
    assert co2.totals["d2h_bytes"] == co1.totals["d2h_bytes"]
    jco, _ = _one_req_run(jm, 2, dtype)
    assert co2.collectives == jco.collectives
    # the census of each sharded program counts its reductions' wire
    # operations: the ragged step's 2L reductions a call
    ops = {"fp": 1, "int8": 4}[dtype]
    ragged = [c for lbl, c in co2.censuses.items()
              if lbl.startswith("ragged")]
    assert ragged and all(c["collectives"] == 2 * L * ops for c in ragged)


def test_int8_wire_cuts_bytes_3x(models):
    _, tm = models
    co_fp, _ = _one_req_run(tm, 2, "fp")
    co_q, _ = _one_req_run(tm, 2, "int8")
    assert co_q.collectives["int8"]["ops"] == co_fp.collectives["fp"]["ops"]
    assert co_fp.collective_bytes("fp") / co_q.collective_bytes("int8") \
        >= 3.0


# --------------------------------------------------------------- surfaces
def test_metrics_and_profile_surface(models):
    """``serving_collective_bytes_total{dtype}`` scrapes from a sharded
    gateway (fp > 0, int8 an explicit 0) and ``/debug/profile`` carries
    the collectives block."""
    _, tm = models
    jit = tm.__dict__.setdefault("_tp_serving_jit", {})

    def factory():
        return _engine(tm, tp=2, jit_cache=jit)

    gw = ServingGateway(factory(), engine_factory=factory, max_queue=8,
                        start=False)
    try:
        st = gw.submit(GenerationRequest(**_traffic()[0]))
        gw.start()
        st.result()
        fams = parse_prometheus(gw.registry.render())
        s = fams["serving_collective_bytes_total"]["samples"]
        assert s[("serving_collective_bytes_total",
                  (("dtype", "fp"),))] > 0
        assert s[("serving_collective_bytes_total",
                  (("dtype", "int8"),))] == 0
        doc = gw.profile_doc()
        assert doc["collectives"]["tp"] == 2
        fp = doc["collectives"]["per_dtype"]["fp"]
        assert fp["bytes"] > 0 and fp["bytes_per_layer"] > 0
        assert fp["bytes"] == pytest.approx(
            fp["bytes_per_layer"] * tm.config.num_hidden_layers)
    finally:
        gw.shutdown(drain=True, timeout=30)


def test_fleet_geometry_grows_tp(models):
    """Replicas take tp through the fleet's geometry tuple, whose tail is
    (tp, collective_dtype, fused_tick, collective_overlap)."""
    _, tm = models
    tm.__dict__.pop("_serving_jit_fleet", None)
    fleet = EngineFleet(tm, replicas=1, num_slots=SLOTS, max_seq_len=S_MAX,
                        prefill_chunk=CHUNK, prefix_block_size=BS, tp=2,
                        collective_dtype="int8", start=False)
    try:
        (geom,) = tm.__dict__["_serving_jit_fleet"].keys()
        assert geom[-4:] == (2, "int8", False, False)
        assert fleet.replicas[0].gateway.engine.tp == 2
    finally:
        fleet.shutdown(drain=False, timeout=5)


def _start_cli(module, env):
    cmd = [sys.executable, "-m", module, "--preset", "tiny", "--port", "0",
           "--quiet", "--tp", "2", "--collective-dtype", "int8"]
    if module.startswith("paddle_tpu_torch"):
        cmd += ["--device", "cpu"]
    return subprocess.Popen(cmd, cwd=str(Path(__file__).resolve().parents[1]),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=dict(os.environ, **env))


def test_cli_banner_reports_tp():
    """``--preset tiny --tp 2 --collective-dtype int8``: the banner is the
    JAX CLI's (but for the address and the port's ``tp_devices``),
    reporting ``"tp": 2, "mesh_shape": {"tp": 2}, "collective_dtype":
    "int8"``; one completion is served; SIGTERM drains with exit 0."""
    procs = [_start_cli("paddle_tpu_torch.serving.server", {}),
             _start_cli("paddle_tpu.serving.server",
                        {"JAX_PLATFORMS": "cpu", "XLA_FLAGS":
                         "--xla_force_host_platform_device_count=2"})]
    try:
        banners = [json.loads(p.stdout.readline()) for p in procs]
        body = json.dumps({"prompt": [1, 2, 3], "max_tokens": 4}).encode()
        req = urllib.request.Request(banners[0]["listening"]
                                     + "/v1/completions", data=body)
        with urllib.request.urlopen(req, timeout=120) as r:
            doc = json.load(r)
        assert len(doc["choices"][0]["token_ids"]) == 4
        for p in procs:
            p.send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert rcs[0] == 0
    assert banners[0].pop("tp_devices") == ["cpu", "cpu"]
    for b in banners:
        b.pop("listening")
    assert banners[0] == banners[1]
    assert (banners[0]["tp"], banners[0]["mesh_shape"],
            banners[0]["collective_dtype"]) == (2, {"tp": 2}, "int8")


# -------------------------------------------------------------- lifecycle
def test_evict_restore_carries_the_sharded_pool(models):
    """Mid-decode evict + restore on a tp=2 engine: the chain donates to
    the trie (every shard's blocks), the recompute readmits it as a hit,
    and the streams equal the uninterrupted tp=1 run."""
    _, tm = models
    eng = _engine(tm, tp=2, prefix_cache=True)
    seqs = [eng.submit(GenerationRequest(**r)) for r in _traffic()]
    for _ in range(3):
        eng.step()
    victim = next(s for s in seqs if s.status == "running")
    assert eng.evict(victim)
    eng.restore(victim)
    while eng.has_work():
        eng.step()
    assert [list(map(int, s.output_ids())) for s in seqs] == _base(tm)
    assert eng.decode_compilations() == 1


def test_chaos_matrix_loses_nothing_on_a_sharded_engine(models):
    """transient → fatal → nan against a tp=2 supervised gateway (the nan
    fault poisons the sharded pool before it crashes): the rebuilt
    engines recompute every shard's KV from the host token state, the
    streams equal the uninterrupted run, 0 requests lost."""
    _, tm = models
    jit = tm.__dict__.setdefault("_tp_chaos_jit", {})

    def factory():
        return _engine(tm, tp=2, prefix_cache=True, jit_cache=jit)

    plan = FaultPlan().at_step(1, "transient").at_step(3, "fatal") \
        .at_step(6, "nan")
    gw = ServingGateway(factory(), engine_factory=factory, fault_hook=plan,
                        max_queue=16, start=False)
    try:
        streams = [gw.submit(GenerationRequest(**r)) for r in _traffic()]
        gw.start()
        outs = [st.result() for st in streams]
        assert [ids.tolist() for ids, _ in outs] == _base(tm)
        assert gw.restarts == 2
        assert gw.engine.decode_compilations() == 1
    finally:
        gw.shutdown(drain=True, timeout=30)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_host_tier_carries_every_shard(models, kv):
    """The host tier under tp=2: two 2-block system prompts in turn under
    a 2-block trie budget spill and readmit every shard's planes (``k.0``,
    ``k.1``, ... and the scale planes), the streams equal the tp=1 tiered
    engine's, and the tier holds the tp=1 run's bytes: the shards' planes
    add up to a block's once."""
    _, tm = models
    fams = [np.random.RandomState(200 + f).randint(0, 256, (2 * BS,))
            .astype(np.int32) for f in range(2)]
    reqs = [dict(prompt=np.concatenate([
        fams[fam], np.random.RandomState(10 * fam + i).randint(
            0, 256, (6,)).astype(np.int32)]), max_new_tokens=6)
        for i in range(3) for fam in (0, 1)]
    runs = []
    for tp in (1, 2):
        eng = _engine(tm, tp=tp, kv_dtype=kv, prefix_cache=True,
                      prefix_blocks=2, host_tier_bytes=1 << 22)
        streams = [_generate(eng, [r])[0] for r in reqs]
        runs.append((streams, eng.prefix_cache))
    (s1, pc1), (s2, pc2) = runs
    assert s2 == s1
    assert pc2.stats["spilled_blocks"] > 0
    assert pc2.stats["readmitted_blocks"] > 0
    assert pc2.tier.bytes_used == pc1.tier.bytes_used
    with pc2.tier._lock:
        bufs = next(iter(pc2.tier._entries.values()))[0]
    names = ("k", "v") + (("k_scale", "v_scale") if kv else ())
    assert set(bufs) == {f"{n}.{s}" if s else n for n in names
                         for s in range(2)}


# --------------------------------------------------------------- refusals
def test_rejects_bad_configs(models):
    _, tm = models
    with pytest.raises(ValueError, match="tp must be >= 1"):
        _engine(tm, tp=0)
    with pytest.raises(ValueError, match="collective_dtype"):
        _engine(tm, tp=2, collective_dtype="fp8")
    with pytest.raises(ValueError, match="unified ragged paged"):
        _engine(tm, tp=2, paged_attn=False)
    with pytest.raises(ValueError, match="unified ragged paged"):
        _engine(tm, tp=2, ragged_step=False)
    with pytest.raises(ValueError, match="must divide"):
        _engine(tm, tp=3)       # nh=4, nkv=2: 3 divides neither
    with pytest.raises(ValueError, match="requires tp > 1"):
        _engine(tm, collective_overlap=True)


def test_shared_pool_of_another_partition_raises(models):
    """A shared PrefixCache's pool is partitioned for one degree: a tp=2
    engine refuses a tp=1 engine's pool, as the reference does."""
    _, tm = models
    eng = _engine(tm, prefix_cache=True)
    with pytest.raises(ValueError, match="partitioned for tp=1"):
        _engine(tm, tp=2, prefix_cache=eng.prefix_cache)


def test_tp1_int8_collectives_are_inert(models):
    """tp=1 has no shards and no wire: the effective collective dtype is
    fp (banners and geometry report what runs)."""
    _, tm = models
    eng = _engine(tm, tp=1, collective_dtype="int8")
    assert eng.collective_dtype == "fp" and len(eng.tp_devices) == 1


def test_tp_must_divide_the_mlp_features():
    """A degree that divides the heads but not ``intermediate_size`` is
    refused at construction, as the reference's placement refuses an
    axis its mesh does not divide: cutting ``w_gate``/``w_up``/``w_down``
    to ``intermediate // tp`` features a shard would drop the last ones
    and serve wrong tokens."""
    paddle.seed(1)
    jm = JLlama(j_tiny(intermediate_size=129, decode_attention="jnp"))
    with pytest.raises(ValueError, match="divisible by 2"):
        _engine(jm, tp=2)
    tm = LlamaForCausalLM(llama_tiny(intermediate_size=129), device="cpu",
                          seed=0)
    with pytest.raises(ValueError, match="must divide intermediate_size"):
        _engine(tm, tp=2)
    assert _engine(tm).tp == 1


@pytest.mark.parametrize("knob", [dict(collective_dtype="int8"), dict(tp=2),
                                  dict(tp=2, collective_overlap=True)],
                         ids=["collective_dtype", "tp", "collective_overlap"])
def test_once_refused_knobs_serve(models, knob):
    """The three values the port refused until tensor parallelism was
    ported now serve the matrix with the default engine's streams."""
    _, tm = models
    assert _generate(_engine(tm, prefix_cache=True, **knob)) == _base(tm)
