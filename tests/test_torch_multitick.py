"""Multi-tick decode (engine ``decode_ticks > 1``) of the port against the
JAX package, on the CPU, on ``llama_tiny`` (2 layers) with the JAX model's
weights carried across.

- the program: ``serving/decode.py``'s ``_multitick_step_impl`` against
  JAX's on the same numpy-made inputs — the pools within 1e-5, the token
  block, the key walk and ``ticks_run`` equal — with rows retiring on
  the device by EOS and by budget, and all rows retiring early (the
  port replays every tick; its ``ticks_run`` is the while_loop's count);
- the engine: greedy and seeded-sampled streams, finish reasons and the
  stats ``mtick_ticks``, ``mtick_syncs`` and ``decode_compilations()``
  equal the JAX engine's with the same arguments, scanned and fused (the
  port's fused tail is its scanned tail on the CPU); EOS at tick 0, on a
  block's last tick and mid-block, a budget cut, staggered retirement
  and a cancellation at a sync boundary, each equal to
  ``decode_ticks=1`` with the pool handed back whole;
- ``choose_decode_ticks``'s four cases, against the JAX scheduler;
- ``serving/graphs.py`` on the CPU: the trash coordinate never meets an
  append, and the launch counters across capture and replay.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import FIFOScheduler as JScheduler
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving import decode as jdec
from paddle_tpu_torch import kernels
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           llama_decode_params,
                                           load_decode_params)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)
from paddle_tpu_torch.serving import decode as tdec
from paddle_tpu_torch.serving import graphs
from paddle_tpu_torch.serving.scheduler import FIFOScheduler
from torch_threads import one_torch_thread  # noqa: F401

BS, CHUNK, TICKS = 8, 16, 8
GEOMETRY = dict(num_slots=2, max_seq_len=96, decode_chunk=1,
                prefix_block_size=BS, prefill_chunk=CHUNK,
                headroom_mult=None)
CONSTS = dict(nh=4, nkv=2, hd=16, eps=1e-5, theta=10000.0, tied=False)
ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    paddle.seed(33)
    jm = JLlama(j_tiny(num_hidden_layers=2, decode_attention="jnp"))
    p, tied = jdec.llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(num_hidden_layers=2), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, p, tm


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


def _engines(models, **kw):
    """A JAX and a port engine with the same arguments; the JAX engines
    of one geometry share a jit cache, so they compile once."""
    jm, _, tm = models
    jit = jm.__dict__.setdefault(
        f"_mtick_jit_{sorted(kw.items())}", {})
    return (JEngine(jm, jit_cache=jit, **dict(GEOMETRY, **kw)),
            ContinuousBatchingEngine(tm, **dict(GEOMETRY, **kw)))


def _run(engine, Request, reqs, cancel_at=None):
    seqs = [engine.submit(Request(**r)) for r in reqs]
    steps = 0
    while engine.has_work():
        engine.step()
        steps += 1
        if cancel_at is not None and steps == cancel_at[0]:
            engine.cancel(seqs[cancel_at[1]])
    return [(list(map(int, s.tokens)), s.finish_reason) for s in seqs]


def _stats(engine):
    st = engine.stats
    return (st["mtick_ticks"], st["mtick_syncs"], st["decode_steps"],
            engine.decode_compilations())


def _ref(models, n=24):
    """A greedy stream of request seed 5 (10 tokens), to plant EOS ids at
    known output indices."""
    _, port = _engines(models)
    return _run(port, GenerationRequest,
                [dict(prompt=_prompt(5, 10), max_new_tokens=n)])[0][0]


# ------------------------------------------------------------ the program
def _mtick_inputs(seed=6):
    """Slot 0 decodes at length 10, slot 1 prefills a 6-token chunk at
    8..13, slot 2 decodes at length 5 (sampled); bs=8, 4 blocks a table,
    8 pool blocks (sentinel 8), a 2-token dead tail."""
    r = np.random.RandomState(seed)
    L, nb, bs, Hkv, D = 2, 8, 8, 2, 16
    pk = r.randn(L, nb, bs, Hkv, D).astype(np.float32)
    pv = r.randn(L, nb, bs, Hkv, D).astype(np.float32)
    tables = np.full((3, 4), nb, np.int32)
    tables[0, :2] = [4, 1]
    tables[1, :2] = [0, 3]
    tables[2, :2] = [5, 2]
    T = 10
    ids = np.zeros(T, np.int32)
    seg = np.full(T, 3, np.int32)
    pos = np.zeros(T, np.int32)
    ids[0], seg[0], pos[0] = 17, 0, 10
    ids[1:7] = r.randint(0, 256, 6)
    seg[1:7] = 1
    pos[1:7] = np.arange(8, 14)
    ids[7], seg[7], pos[7] = 99, 2, 5
    qstart = np.array([0, 1, 7], np.int32)
    qlen = np.array([1, 6, 1], np.int32)
    kvlen = np.array([11, 14, 6], np.int32)
    dec_mask = np.array([1, 0, 1], np.int32)
    keys = r.randint(0, 2 ** 31, (3, 2)).astype(np.int64)
    temps = np.array([0.0, 0.0, 0.9], np.float32)
    topks = np.array([0, 0, 5], np.int32)
    return [pk, pv, tables, ids, seg, pos, qstart, qlen, kvlen, dec_mask,
            keys, temps, topks]


def _pure_decode(args):
    """The same step without its chunk row: every span a decode row."""
    args = [a.copy() for a in args]
    args[4][1:7] = 3                    # seg: the chunk's rows are dead
    args[7][1] = 0                      # qlen
    args[8][1] = 0                      # kvlen
    return args


def _jax(p, args, eos, budgets, n, max_ticks, **kw):
    return jdec._multitick_step_impl(
        p, *[jnp.asarray(a) for a in args[:10]],
        jnp.asarray(args[10], jnp.uint32), jnp.asarray(args[11]),
        jnp.asarray(args[12]), jnp.asarray(eos), jnp.asarray(budgets),
        jnp.int32(n), max_ticks=max_ticks, decode_attn="jnp", **kw,
        **CONSTS)


def _both(p, tm, args, eos, budgets, n, max_ticks, fused=False):
    jout = _jax(p, args, eos, budgets, n, max_ticks, fused=fused)
    tp, _ = llama_decode_params(tm)
    tpk = torch.from_numpy(args[0].copy())
    tpv = torch.from_numpy(args[1].copy())
    tout = tdec._multitick_step_impl(
        [tp], [tpk], [tpv], *args[2:], eos, budgets, n, max_ticks=max_ticks,
        fused=fused, **CONSTS)
    return jout, tout, tpk, tpv


def _assert_same(jout, tout):
    assert float(np.abs(tout[0][0].numpy() - np.asarray(jout[0])).max()) \
        <= ATOL
    assert float(np.abs(tout[1][0].numpy() - np.asarray(jout[1])).max()) \
        <= ATOL
    assert tout[2].tolist() == np.asarray(jout[2]).tolist()
    assert (tout[3].numpy() == np.asarray(jout[3]).astype(np.int64)).all()
    assert tout[4] == int(jout[4])


class TestProgram:
    @pytest.mark.parametrize("n", [1, 4])
    def test_matches_jax(self, models, n):
        _, p, tm = models
        args = _mtick_inputs()
        eos = np.full(3, -1, np.int32)
        budgets = np.array([9, 0, 9], np.int32)
        jout, tout, tpk, _ = _both(p, tm, args, eos, budgets, n, 6)
        _assert_same(jout, tout)
        assert tout[0][0] is tpk                    # written in place
        assert tout[4] == n

    def test_device_retirement_by_eos_and_budget(self, models):
        """Row 0 retires on the EOS it samples at tick 2, row 2 when its
        budget of 3 is spent: both cut where JAX's alive mask cuts."""
        _, p, tm = models
        args = _mtick_inputs()
        free = np.full(3, -1, np.int32)
        budgets = np.array([9, 0, 3], np.int32)
        jfree = _jax(p, args, free, budgets, 5, 6)
        row0 = np.asarray(jfree[2])[:, 0].tolist()
        if row0[2] in row0[:2]:
            pytest.skip("row 0's stream repeats before tick 2")
        eos = np.array([row0[2], -1, -1], np.int32)
        jout, tout, _, _ = _both(p, tm, args, eos, budgets, 5, 6)
        _assert_same(jout, tout)
        # both rows retired before the last tick: the loop stopped early
        assert tout[4] == 3 and tout[2][3:].abs().sum() == 0

    def test_fused_tick_zero_and_tail_match_jax(self, models):
        """With ``fused`` and every span a decode row, tick 0 is the fused
        tick (the scanned tick with the plain attention on the CPU, JAX's
        jnp oracle), not the packed forward."""
        _, p, tm = models
        args = _pure_decode(_mtick_inputs())
        eos = np.full(3, -1, np.int32)
        budgets = np.array([9, 0, 9], np.int32)
        jout, tout, _, _ = _both(p, tm, args, eos, budgets, 4, 4,
                                 fused=True)
        _assert_same(jout, tout)


# ------------------------------------------------------------- the engine
def _matrix(eos):
    return [dict(prompt=_prompt(1, 40), max_new_tokens=9),
            dict(prompt=_prompt(2, 12), max_new_tokens=13),
            dict(prompt=_prompt(3, 12), max_new_tokens=10,
                 temperature=0.9, top_k=5, seed=123),
            dict(prompt=_prompt(5, 10), max_new_tokens=24,
                 eos_token_id=eos),
            dict(prompt=_prompt(4, 7), max_new_tokens=1)]


class TestEngineAgainstJax:
    @pytest.mark.parametrize("fused", [False, True],
                             ids=["scanned", "fused"])
    def test_streams_and_stats_equal_jax(self, models, fused):
        ref = _ref(models)
        jeng, _ = _engines(models, decode_ticks=TICKS)
        _, port = _engines(models, decode_ticks=TICKS, fused_tick=fused)
        matrix = _matrix(ref[6])
        want = _run(jeng, JRequest, matrix)
        assert _run(port, GenerationRequest, matrix) == want
        assert _stats(port) == _stats(jeng)
        assert port.decode_compilations() == 1
        assert port.stats["mtick_pure_syncs"] == jeng.stats[
            "mtick_pure_syncs"]
        _, single = _engines(models)
        assert _run(single, GenerationRequest, matrix) == want

    def test_invalid_configs_raise(self, models):
        _, _, tm = models
        for kw, err in ((dict(decode_ticks=0), ValueError),
                        (dict(decode_ticks=4, ragged_step=False),
                         ValueError),
                        (dict(decode_ticks=4, paged_attn=False),
                         ValueError),
                        (dict(decode_ticks=4, spec_decode=True),
                         ValueError)):
            with pytest.raises(err):
                ContinuousBatchingEngine(tm, **dict(GEOMETRY, **kw))
        assert ContinuousBatchingEngine(
            tm, **GEOMETRY, decode_ticks=4).decode_ticks == 4


class TestFinishMasking:
    def _eos_case(self, models, cut, max_new=24):
        """One request whose greedy stream hits EOS at output ``cut``:
        the port at decode_ticks 1 and 8, and JAX at 8."""
        ref = _ref(models)
        eos = ref[cut]
        if eos in ref[:cut]:
            pytest.skip("ambiguous EOS plant")
        req = [dict(prompt=_prompt(5, 10), max_new_tokens=max_new,
                    eos_token_id=eos)]
        outs = []
        for ticks in (1, TICKS):
            _, eng = _engines(models, decode_ticks=ticks)
            outs.append((_run(eng, GenerationRequest, req), eng))
            assert eng.cache.pool.num_free == eng.cache.pool.num_blocks
        jeng, _ = _engines(models, decode_ticks=TICKS)
        assert _run(jeng, JRequest, req) == outs[1][0]
        assert _stats(outs[1][1]) == _stats(jeng)
        assert outs[0][0] == outs[1][0]
        assert outs[1][0][0][1] == "stop"
        return outs[1][1].stats

    def test_eos_on_tick0(self, models):
        st = self._eos_case(models, 1)
        assert st["mtick_syncs"] == 1 and st["mtick_ticks"] == 1

    def test_eos_on_last_tick_of_block(self, models):
        st = self._eos_case(models, TICKS)
        assert st["mtick_syncs"] == 1 and st["mtick_ticks"] == TICKS

    def test_eos_mid_block_returns_with_ticks_to_spare(self, models):
        ref = _ref(models)
        cut = next(c for c in range(3, TICKS - 1) if ref[c] not in ref[:c])
        st = self._eos_case(models, cut)
        assert st["last_decode_ticks"] < TICKS
        assert st["mtick_ticks"] == cut

    def test_budget_cut_mid_block(self, models):
        req = [dict(prompt=_prompt(5, 10), max_new_tokens=11)]
        outs = []
        for ticks in (1, TICKS):
            _, eng = _engines(models, decode_ticks=ticks)
            outs.append(_run(eng, GenerationRequest, req))
            assert eng.cache.pool.num_free == eng.cache.pool.num_blocks
        assert outs[0] == outs[1]
        assert outs[1][0][1] == "length" and len(outs[1][0][0]) == 11

    def test_staggered_eos_rows_retire_independently(self, models):
        ref = _ref(models)
        reqs = [dict(prompt=_prompt(5, 10), max_new_tokens=24,
                     eos_token_id=ref[2]),
                dict(prompt=_prompt(21, 14), max_new_tokens=15)]
        outs = []
        for ticks in (1, TICKS):
            _, eng = _engines(models, decode_ticks=ticks)
            outs.append(_run(eng, GenerationRequest, reqs))
            assert eng.cache.pool.num_free == eng.cache.pool.num_blocks
        assert outs[0] == outs[1]

    def test_cancellation_at_a_sync_boundary(self, models):
        """cancel() runs between steps, so it lands on a sync boundary:
        the cancelled stream is a prefix of its uncancelled self, the
        bystander's is untouched, the pool comes back whole."""
        reqs = [dict(prompt=_prompt(31, 12), max_new_tokens=30),
                dict(prompt=_prompt(32, 12), max_new_tokens=30)]
        _, eng8 = _engines(models, decode_ticks=TICKS)
        (k8, _), (v8, r8) = _run(eng8, GenerationRequest, reqs,
                                 cancel_at=(2, 1))
        _, eng1 = _engines(models)
        (k1, _), (v1, _) = _run(eng1, GenerationRequest, reqs)
        assert r8 == "cancelled" and k8 == k1
        assert v8 == v1[:len(v8)] and 0 < len(v8) < 30
        assert eng8.cache.pool.num_free == eng8.cache.pool.num_blocks


# ------------------------------------------------------- adaptive ticks
class _FakeSeq:
    def __init__(self, remaining):
        self.remaining = remaining


@pytest.mark.parametrize("case", ["mixed", "queue", "idle", "degenerate"])
def test_choose_decode_ticks_matches_jax(case):
    got, want = [], []
    for sched, out in ((FIFOScheduler(1), got), (JScheduler(1), want)):
        active = [_FakeSeq(3), _FakeSeq(40)]
        if case == "mixed":
            sched.enter_prefill(_FakeSeq(9))
            out.append(sched.choose_decode_ticks([_FakeSeq(50)], 8))
        elif case == "queue":
            sched.submit(_FakeSeq(9))
            out.append(sched.choose_decode_ticks(active, 8))
        elif case == "idle":
            out += [sched.choose_decode_ticks(active, 8),
                    sched.choose_decode_ticks([_FakeSeq(5)], 8)]
        else:
            out += [sched.choose_decode_ticks([], 8),
                    sched.choose_decode_ticks([_FakeSeq(50)], 1)]
    assert got == want
    assert got == {"mixed": [1], "queue": [3], "idle": [8, 5],
                   "degenerate": [1, 1]}[case]


# ------------------------------------------------------------- graphs.py
def test_trash_coordinate_misses_every_append():
    tables = np.array([[3, 4, 9], [1, 2, 9]], np.int32)
    lens0 = np.array([6, 15])
    for n in (1, 4, 8):
        b, p = graphs.trash_coord(tables, 5, 8, lens0, [1, 1], n)
        targets = {(int(tables[r, q // 8]), q % 8) for r in (0, 1)
                   for q in range(lens0[r], lens0[r] + n)}
        assert (b, p) not in targets and 0 <= b < 5
    # a pool whose top rows are all appended to still yields a free row
    tables = np.array([[0, 1]], np.int32)
    assert graphs.trash_coord(tables, 2, 2, np.array([0]), [1], 3) == (1, 1)


def test_capture_counts_take_back_and_replays_add():
    kernels.reset_launches()
    kernels.count_launch("paged_decode")
    rec = {}
    with kernels.capture_counts(rec):
        kernels.count_launch("paged_decode")
        kernels.count_launch("paged_decode")
    assert kernels.LAUNCHES["paged_decode"] == 1
    assert rec["paged_decode"] == 2 and rec["flash"] == 0
    for _ in range(3):
        kernels.count_replay(rec)
    assert kernels.LAUNCHES["paged_decode"] == 7
    kernels.reset_launches()


def test_launches_sum_the_threads_tallies():
    """Each thread counts its own launches (an engine fleet's replicas
    drive their engines from threads of their own); LAUNCHES sums them,
    a capture on one thread leaves the others counting, and a reset
    clears every tally."""
    import threading
    kernels.reset_launches()
    kernels.count_launch("flash")
    rec, inside, done = {}, threading.Event(), threading.Event()

    def other():
        inside.wait()
        for _ in range(3):
            kernels.count_launch("flash")
        done.set()
    th = threading.Thread(target=other)
    th.start()
    with kernels.capture_counts(rec):
        inside.set()
        done.wait()
        kernels.count_launch("flash")
    th.join()
    assert rec["flash"] == 1
    assert kernels.thread_launches()["flash"] == 1
    assert kernels.thread_launches(th.ident)["flash"] == 3
    assert kernels.LAUNCHES["flash"] == dict(kernels.LAUNCHES)["flash"] == 4
    kernels.reset_launches()
    assert sum(kernels.LAUNCHES.values()) == 0
    assert kernels.thread_launches(th.ident)["flash"] == 0


def test_eager_tail_counts_ticks(models):
    """On the CPU the engine's tail runs eagerly through its TailGraphs,
    which counts the tail ticks run: the step's ticks less its tick 0."""
    _, eng = _engines(models, decode_ticks=TICKS)
    _run(eng, GenerationRequest,
         [dict(prompt=_prompt(5, 10), max_new_tokens=12)])
    assert eng._tail.captures == 0
    assert eng._tail.ticks >= eng.stats["mtick_ticks"] - eng.stats[
        "mtick_syncs"]
