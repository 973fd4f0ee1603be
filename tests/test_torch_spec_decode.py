"""The port's speculative decode against the JAX package, on the CPU, on
``llama_tiny`` (GQA, ``decode_attention="jnp"``) with the JAX model's
weights carried across.

- the drafters: the n-gram drafter's proposals (the reference's unit
  cases, then random histories against JAX's ``NgramDrafter``);
- ``FIFOScheduler.spec_grants`` and ``PagedKVCache.truncate``: the
  reference's cases, and a random mix of growth, prefix installs,
  truncation and frees run through both caches, ``num_free``, refcounts
  and tables equal after every operation;
- the verify program alone: ``_spec_verify_impl`` against JAX's on one
  packed buffer (verify spans, a chunk, an idle row, sampled rows):
  tokens and key walk equal, logits within 1e-5;
- the engine: ``spec_decode=True`` with the n-gram drafter, the model
  drafter (the target itself: the always-accept oracle) and an
  always-wrong drafter — streams and finish reasons equal speculation off
  AND the JAX engine with the same knobs, ``spec_*`` stats equal JAX's;
  after full rejection the pool equals a never-speculating engine's step
  for step; cancel, donation, a fatal fault mid-speculation and a
  restore recompute from accepted tokens only; the gateway's spec series
  parse strictly.

Each JAX engine run is held in a module cache keyed by its knobs and its
request matrix, so each knob set runs once in this file.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.serving import BlockManager as JBlockManager
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving import ModelDrafter as JModelDrafter
from paddle_tpu.serving import NgramDrafter as JNgramDrafter
from paddle_tpu.serving import PagedKVCache as JPagedKVCache
from paddle_tpu.serving import FIFOScheduler as JFIFOScheduler
from paddle_tpu.serving import decode as jdec
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           llama_decode_params,
                                           load_decode_params)
from paddle_tpu_torch.serving import (BlockManager,
                                      ContinuousBatchingEngine, FaultPlan,
                                      FIFOScheduler, GenerationRequest,
                                      PagedKVCache)
from paddle_tpu_torch.serving import decode as tdec
from paddle_tpu_torch.serving.drafter import (Drafter, ModelDrafter,
                                              NgramDrafter)

from test_metrics_prom import parse_prometheus
from torch_threads import one_torch_thread  # noqa: F401

BS = 8       # KV block size
CHUNK = 16   # chunked-prefill budget (2 blocks)
SPEC_K = 3
STATS = ("spec_steps", "spec_proposed", "spec_accepted", "spec_tokens",
         "decode_calls", "prefill_chunks", "tokens_generated",
         "preemptions", "restores")


@pytest.fixture(scope="module")
def models():
    paddle.seed(33)
    jm = JLlama(j_tiny(decode_attention="jnp"))
    p, tied = jdec.llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


def _geo(**kw):
    # the chunk grant pinned at its cap: the adaptive grant reads a wall
    # clock, which two engines cannot share
    g = dict(num_slots=2, max_seq_len=96, decode_chunk=1,
             prefix_block_size=BS, prefill_chunk=CHUNK, headroom_mult=None)
    g.update(kw)
    return g


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n,)).astype(np.int32)


def _req(ps, n=20, **kw):
    kw.setdefault("max_new_tokens", 8)
    return dict(prompt=_prompt(ps, n), **kw)


class _Junk:
    """Always proposes the same (almost surely wrong) tokens: the
    full-rejection instrument, one class for both packages."""

    def propose(self, seq, k):
        return np.full(int(k), 7, np.int32)


class _JunkDrafter(_Junk, Drafter):
    pass


def _drafter(kind, side, models):
    jm, tm = models
    if kind is None:
        return None
    if kind == "ngram":
        return NgramDrafter() if side == "port" else JNgramDrafter()
    if kind == "junk":
        return _JunkDrafter() if side == "port" else _Junk()
    if side == "port":
        return ModelDrafter(tm)
    return JModelDrafter(jm, jit_cache=jm.__dict__.setdefault(
        "_draft_jit", {}))


def _engine(models, side, **kw):
    """An engine of either package. ``spec=True`` turns speculation on
    with ``drafter`` naming the drafter kind (built for that package);
    without it every knob passes through as given."""
    jm, tm = models
    if kw.pop("spec", False):
        kind = kw.pop("drafter", None)
        kw.update(spec_decode=True, spec_k=kw.get("spec_k", SPEC_K),
                  drafter=_drafter(kind, side, models))
    if side == "jax":
        # one jit cache a geometry: each program traces once in the file
        geo = sorted((k, str(v)) for k, v in kw.items() if k != "drafter")
        kw.setdefault("jit_cache", jm.__dict__.setdefault(f"_jit_{geo}", {}))
        return JEngine(jm, **_geo(**kw))
    return ContinuousBatchingEngine(tm, **_geo(**kw))


def _drive(engine, side, waves, cancel_at=None):
    """Submit each wave, step to completion; ``cancel_at = (wave, index)``
    cancels that request after the first step that leaves it mid-chunked
    prefill. Returns (streams, finish reasons, engine)."""
    Request = JRequest if side == "jax" else GenerationRequest
    streams, reasons = [], []
    for w, wave in enumerate(waves):
        seqs = [engine.submit(Request(**r)) for r in wave]
        while engine.has_work():
            engine.step()
            if cancel_at is not None and cancel_at[0] == w:
                victim = seqs[cancel_at[1]]
                if victim.status == "prefilling":
                    engine.cancel(victim)
        streams += [list(map(int, s.tokens)) for s in seqs]
        reasons += [s.finish_reason for s in seqs]
    return streams, reasons, engine


_JAX = {}


def _jax_run(models, key, waves, cancel_at=None, **kw):
    """The JAX engine's streams, reasons and stats for a knob set and a
    request matrix, run once per file."""
    if key not in _JAX:
        streams, reasons, eng = _drive(_engine(models, "jax", **kw), "jax",
                                       waves, cancel_at)
        pc = eng.prefix_cache
        _JAX[key] = (streams, reasons,
                     {k: eng.stats[k] for k in STATS},
                     dict(pc.stats) if pc is not None else None,
                     eng.decode_compilations())
    return _JAX[key]


def _stats(eng):
    return {k: eng.stats[k] for k in STATS}


# ------------------------------------------------------------- drafters
class _Seq:
    """Host-only stand-in for drafter unit tests."""

    def __init__(self, prompt, tokens=()):
        self.prompt = np.asarray(prompt, np.int32)
        self.tokens = list(tokens)


class TestNgramDrafter:
    def test_matches_most_recent_ngram_continuation(self):
        d = NgramDrafter(max_ngram=3, min_ngram=1)
        s = _Seq([9, 8, 2, 3, 5, 6, 2, 3])
        assert d.propose(s, 2).tolist() == [5, 6]
        assert d.propose(s, 1).tolist() == [5]

    def test_generated_tokens_extend_the_history(self):
        d = NgramDrafter()
        s = _Seq([1, 2, 3, 4], tokens=[1, 2])
        assert d.propose(s, 4).tolist() == [3, 4, 1, 2]

    def test_most_recent_occurrence_wins(self):
        d = NgramDrafter(max_ngram=1)
        assert d.propose(_Seq([5, 1, 5, 2, 5]), 1).tolist() == [2]

    def test_no_match_and_short_history_edges(self):
        d = NgramDrafter()
        assert d.propose(_Seq([1, 2, 3, 4]), 4).size == 0
        assert d.propose(_Seq([1]), 4).size == 0
        assert d.propose(_Seq([1, 1]), 0).size == 0
        assert d.propose(_Seq([1, 1]), 4).tolist() == [1]

    def test_validation(self):
        with pytest.raises(ValueError, match="max_ngram"):
            NgramDrafter(max_ngram=0)
        with pytest.raises(ValueError, match="max_ngram"):
            NgramDrafter(max_ngram=1, min_ngram=2)

    def test_proposals_equal_jax_on_random_histories(self):
        r = np.random.RandomState(5)
        for trial in range(200):
            n = int(r.randint(1, 40))
            hist = r.randint(0, 6, n).astype(np.int32)
            cut = int(r.randint(0, n + 1))
            s = _Seq(hist[:cut], hist[cut:].tolist())
            mx = int(r.randint(1, 5))
            mn = int(r.randint(1, mx + 1))
            k = int(r.randint(0, 6))
            got = NgramDrafter(mx, mn).propose(s, k)
            want = JNgramDrafter(mx, mn).propose(s, k)
            assert got.dtype == np.int32
            assert got.tolist() == np.asarray(want).tolist(), trial


class TestSpecGrants:
    def test_greedy_in_order_with_budget(self):
        for s in (FIFOScheduler(), JFIFOScheduler()):
            assert s.spec_grants([3, 3, 3], 5) == [3, 2, 0]
            assert s.spec_grants([2, 2], 10) == [2, 2]
            assert s.spec_grants([4], 0) == [0]
            assert s.spec_grants([4], -3) == [0]
            assert s.spec_grants([], 7) == []


# ------------------------------------------------------------- truncate
class TestTruncate:
    def _cache(self, blocks=12):
        pool = BlockManager(1, blocks, BS, 1, 4, device="cpu")
        return PagedKVCache(1, 2, 6 * BS, 1, 4, block_size=BS, pool=pool,
                            device="cpu"), pool

    def test_frees_exactly_the_private_tail(self):
        cache, pool = self._cache()
        slot = cache.alloc()
        cache.ensure_capacity(slot, 4 * BS)
        assert pool.num_free == 12 - 4
        cache.lengths[slot] = 2 * BS + 3
        cache.truncate(slot, BS + 2)              # keep ceil(10/8) = 2
        assert pool.num_free == 12 - 2
        assert int(cache._n_blocks[slot]) == 2
        assert int(cache.lengths[slot]) == BS + 2
        assert all(int(b) == cache.sentinel for b in cache.tables[slot, 2:])
        cache.truncate(slot, BS + 2)              # covering rows: no-op
        assert pool.num_free == 12 - 2
        cache.ensure_capacity(slot, 4 * BS)       # regrowth reuses the heap
        assert pool.num_free == 12 - 4

    def test_never_touches_shared_prefix_blocks(self):
        cache, pool = self._cache()
        shared = [pool.alloc(), pool.alloc()]
        for b in shared:
            pool.ref(b)
        slot = cache.alloc()
        cache.install_prefix(slot, shared)
        cache.ensure_capacity(slot, 3 * BS)
        refs_before = [pool.refcount(b) for b in shared]
        free_before = pool.num_free
        cache.truncate(slot, 0)                   # clamped at the prefix
        assert [pool.refcount(b) for b in shared] == refs_before
        assert int(cache._n_blocks[slot]) == 2
        assert pool.num_free == free_before + 1
        for j, b in enumerate(shared):
            assert int(cache.tables[slot, j]) == b

    def test_random_growth_and_truncation_against_jax(self):
        """The same random mix of prefix installs, growth, truncation and
        frees through both caches: num_free, every refcount, the tables
        and the lengths agree after every operation, and a free returns
        the pool to its shared blocks alone."""
        r = np.random.RandomState(11)
        nb, slots, mb = 40, 3, 6
        tpool = BlockManager(1, nb, BS, 1, 4, device="cpu")
        jpool = JBlockManager(1, nb, BS, 1, 4)
        tc = PagedKVCache(1, slots, mb * BS, 1, 4, block_size=BS,
                          pool=tpool, device="cpu")
        jc = JPagedKVCache(1, slots, mb * BS, 1, 4, block_size=BS,
                           pool=jpool)
        shared = []
        for _ in range(4):
            b = tpool.alloc()
            assert jpool.alloc() == b
            tpool.ref(b)
            jpool.ref(b)
            shared.append(b)
        live = {}
        for op in range(400):
            if not live or (len(live) < slots and r.rand() < 0.2):
                s, js = tc.alloc(), jc.alloc()
                assert s == js
                k = int(r.randint(0, 3))
                for c in (tc, jc):
                    c.install_prefix(s, shared[:k])
                live[s] = k
            s = list(live)[int(r.randint(len(live)))]
            roll = r.rand()
            if roll < 0.45:
                rows = int(r.randint(0, mb * BS + 1))
                for c in (tc, jc):
                    c.ensure_capacity(s, rows)
                    c.lengths[s] = max(int(c.lengths[s]), rows)
            elif roll < 0.9:
                rows = int(r.randint(0, mb * BS + 1))
                for c in (tc, jc):
                    c.truncate(s, rows)
            else:
                for c in (tc, jc):
                    c.free(s)
                del live[s]
            assert tpool.num_free == jpool.num_free, op
            assert np.array_equal(tpool._ref, jpool._ref), op
            assert np.array_equal(tc.tables, jc.tables), op
            assert np.array_equal(tc.lengths, jc.lengths), op
            assert np.array_equal(tc._n_blocks, jc._n_blocks), op
        for s in list(live):
            tc.free(s)
        assert tpool.num_free == nb - len(shared)
        assert [tpool.refcount(b) for b in shared] == [1] * len(shared)


class TestValidation:
    def test_spec_requires_paged(self, models):
        with pytest.raises(ValueError, match="paged"):
            _engine(models, "port", paged_attn=False, spec_decode=True)

    def test_spec_k_validated(self, models):
        with pytest.raises(ValueError, match="spec_k"):
            _engine(models, "port", spec_decode=True, spec_k=0)

    def test_incompatible_step_shapes(self, models):
        for kw in (dict(decode_ticks=4), dict(fused_tick=True)):
            with pytest.raises(ValueError, match="spec_decode"):
                _engine(models, "port", spec_decode=True, **kw)
        eng = _engine(models, "port", spec_decode=True, spec_k=2)
        assert eng.spec_decode and eng.spec_k == 2
        assert isinstance(eng.drafter, NgramDrafter)
        off = _engine(models, "port", drafter=NgramDrafter())
        assert not off.spec_decode and off.spec_k == 0
        assert off.drafter is None


# --------------------------------------------------------- verify program
class TestVerifyProgram:
    def test_verify_program_against_jax(self, models, monkeypatch):
        """One packed buffer — two verify spans (one crossing a block
        edge, one sampled), a non-final chunk, a final chunk and an idle
        row — through both verify programs: tokens and the key walk
        equal, logits within 1e-5, the appended K/V within 1e-5."""
        import jax.numpy as jnp
        import torch
        jm, tm = models
        c = tm.config
        R, mb, S = 5, 6, SPEC_K + 1
        nb = R * mb
        r = np.random.RandomState(3)
        tables = np.full((R, mb), nb, np.int32)
        perm = r.permutation(nb)
        for i in range(R):
            tables[i, :4] = perm[4 * i:4 * i + 4]
        # (L0, q, sample start is span start) for verify rows; chunk rows
        # (off, n) sample at their span end
        spans = [("verify", 6, 4), ("verify", 13, 3), ("chunk", 16, 8),
                 ("chunk", 8, 5), ("idle", 0, 0)]
        T = R + R * SPEC_K + 4
        ids = np.zeros(T, np.int32)
        seg = np.full(T, R, np.int32)
        pos = np.zeros(T, np.int32)
        qstart = np.zeros(R, np.int32)
        qlen = np.zeros(R, np.int32)
        kvlen = np.zeros(R, np.int32)
        sstart = np.zeros(R, np.int32)
        cur = 0
        for i, (kind, off, q) in enumerate(spans):
            if kind == "idle":
                continue
            qstart[i], qlen[i], kvlen[i] = cur, q, off + q
            sstart[i] = cur if kind == "verify" else cur + q - 1
            ids[cur:cur + q] = r.randint(0, c.vocab_size, q)
            seg[cur:cur + q] = i
            pos[cur:cur + q] = np.arange(off, off + q)
            cur += q
        keys = r.randint(0, 2 ** 32, (R, 2), dtype=np.uint64)
        temps = np.array([0.0, 0.9, 0.0, 0.7, 0.0], np.float32)
        topks = np.array([0, 5, 0, 0, 0], np.int32)
        pk = r.randn(c.num_hidden_layers, nb, BS, c.num_key_value_heads,
                     c.head_dim).astype(np.float32)
        pv = r.randn(*pk.shape).astype(np.float32)
        consts = dict(nh=c.num_attention_heads, nkv=c.num_key_value_heads,
                      hd=c.head_dim, eps=float(c.rms_norm_eps),
                      theta=float(c.rope_theta), tied=False,
                      decode_attn="jnp")
        seen = {}

        def rec(mod, tag):
            fn = mod._head_logits

            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                seen[tag] = np.asarray(out.detach().cpu() if isinstance(
                    out, torch.Tensor) else out, np.float32)
                return out
            monkeypatch.setattr(mod, "_head_logits", wrapped)
        rec(tdec, "port")
        rec(jdec, "jax")
        jp, _ = jdec.llama_decode_params(jm)
        jout = jdec._spec_verify_impl(
            jp, jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
            jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos),
            jnp.asarray(qstart), jnp.asarray(qlen), jnp.asarray(kvlen),
            jnp.asarray(sstart), jnp.asarray(keys.astype(np.uint32)),
            jnp.asarray(temps), jnp.asarray(topks), spec_len=S, **consts)
        tp, _ = llama_decode_params(tm)
        tpk, tpv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
        tout = tdec._spec_verify_impl(
            [tp], [tpk], [tpv], tables, ids, seg, pos, qstart, qlen, kvlen,
            sstart, keys.astype(np.int64), temps, topks, spec_len=S,
            **consts)
        assert tout[0][0] is tpk and tout[1][0] is tpv   # in place
        assert np.array_equal(tout[2].numpy(), np.asarray(jout[2]))
        assert np.array_equal(tout[3].numpy(),
                              np.asarray(jout[3]).astype(np.int64))
        assert tout[3].shape == (S, R, 2)
        np.testing.assert_allclose(seen["port"], seen["jax"], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(tpk.numpy(), np.asarray(jout[0]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tpv.numpy(), np.asarray(jout[1]),
                                   atol=1e-5, rtol=1e-5)
        assert seen["port"].shape == (R * S, c.vocab_size)


# ------------------------------------------------------------- transparency
_SYSP = _prompt(90, 32)


def _mixed_waves():
    wave = [_req(1, n=40), _req(2, n=21),
            dict(prompt=np.concatenate([_SYSP, _prompt(3, 9)]),
                 max_new_tokens=6),
            dict(prompt=np.concatenate([_SYSP, _prompt(4, 15)]),
                 max_new_tokens=5, temperature=0.8, top_k=4, seed=7),
            _req(5, n=33, temperature=0.9, top_k=5, seed=123),
            _req(7, n=70)]
    return [wave, [dict(r) for r in wave]]


#: the mixed matrix's cancellation: wave 0's 70-token prompt, mid-prefill
_CANCEL = (0, 5)
_MIXED = dict(prefix_cache=True, prefix_blocks=32)


class TestTransparency:
    def test_spec_equals_baseline_mixed_matrix(self, models):
        """A hit/miss/chunked/cancel matrix — shared system prompt, greedy
        and seeded-sampled rows, a prompt that chunks, a mid-prefill
        cancellation, two waves: the speculative engine's streams equal
        speculation off and the JAX speculative engine's, its spec and
        prefix stats equal JAX's, ONE verify-program signature."""
        waves = _mixed_waves()
        want, want_r, _ = _drive(_engine(models, "port", **_MIXED), "port",
                                 waves, _CANCEL)
        got, got_r, eng = _drive(_engine(models, "port", spec=True,
                                         drafter="ngram", **_MIXED),
                                 "port", waves, _CANCEL)
        j_streams, j_reasons, j_stats, j_pc, j_dc = _jax_run(
            models, "mixed_ngram", waves, _CANCEL, spec=True,
            drafter="ngram", **_MIXED)
        assert got == want == j_streams
        assert got_r == want_r == j_reasons
        assert "cancelled" in got_r
        assert _stats(eng) == j_stats
        assert eng.prefix_cache.stats == j_pc
        assert eng.decode_compilations() == 1 == j_dc
        assert eng.stats["spec_steps"] > 0
        assert eng.stats["spec_proposed"] > 0
        assert eng.prefix_cache.stats["hits"] >= 1
        assert eng.stats["prefill_chunks"] >= 1

    def test_decode_compilations_isolates_spec_k_variants(self, models):
        cache = {}
        a = _engine(models, "port", spec_decode=True, spec_k=2,
                    jit_cache=cache)
        b = _engine(models, "port", spec_decode=True, spec_k=3,
                    jit_cache=cache)
        assert a._spec_budget == b._spec_budget
        a.generate([GenerationRequest(**_req(91, max_new_tokens=3))])
        b.generate([GenerationRequest(**_req(92, max_new_tokens=3))])
        assert a.decode_compilations() == 1
        assert b.decode_compilations() == 1
        assert len([k for k in cache if k[0] == "spec"]) == 2

    def test_accepting_drafter_fewer_launches_than_tokens(self, models):
        """The target drafting for itself accepts every draft: fewer
        verify launches than tokens, streams equal speculation off and
        the JAX engine's, stats equal JAX's; the draft program, in the
        engine's own program cache, is no prefill program of the
        engine."""
        waves = [[_req(11, max_new_tokens=12), _req(12, max_new_tokens=12)]]
        want, _, base = _drive(_engine(models, "port", jit_cache={}),
                               "port", waves)
        cache = {}
        eng = _engine(models, "port", spec_decode=True, spec_k=SPEC_K,
                      drafter=ModelDrafter(models[1], jit_cache=cache),
                      jit_cache=cache)
        launches = {"n": 0}
        orig = eng._spec_fn
        eng._spec_fn = lambda: (launches.__setitem__(
            "n", launches["n"] + 1) or orig())
        got, _, eng = _drive(eng, "port", waves)
        j_streams, _, j_stats, _, _ = _jax_run(
            models, "oracle", waves, spec=True, drafter="model")
        assert got == want == j_streams
        assert _stats(eng) == j_stats
        assert eng.stats["spec_accepted"] > 0
        assert launches["n"] < eng.stats["spec_tokens"]
        assert eng.stats["spec_tokens"] > 2 * launches["n"]
        assert cache[("draft",)]._cache_size() >= 1
        assert eng.prefill_compilations() == base.prefill_compilations()

    def test_eos_mid_acceptance_stops_the_stream(self, models):
        waves = [[_req(21, max_new_tokens=24, eos_token_id=3)]]
        want, want_r, _ = _drive(_engine(models, "port"), "port", waves)
        got, got_r, eng = _drive(_engine(models, "port", spec=True,
                                         drafter="model"), "port", waves)
        j_streams, j_reasons, j_stats, _, _ = _jax_run(
            models, "eos", waves, spec=True, drafter="model")
        assert got == want == j_streams
        assert got_r == want_r == j_reasons
        assert _stats(eng) == j_stats


# ---------------------------------------------------- rollback accounting
def _pool_state(eng):
    """Free blocks, the refcounts as a multiset (a rolled-back draft block
    returns to the heap, so later growth may take other block ids) and
    each slot's table length."""
    p = eng.cache.pool
    return p.num_free, sorted(p._ref.tolist()), eng.cache._n_blocks.tolist()


class TestRollbackAccounting:
    def test_full_rejection_restores_pool_exactly(self, models):
        """An always-wrong drafter: every verify writes its draft rows and
        truncates them all back. Streams equal speculation off and JAX;
        stats equal JAX's; while nothing is accepted the pool's free count
        and the refcounts equal a never-speculating engine's after each
        step; after retirement the pool is whole."""
        reqs = [_req(31), _req(32, n=33)]
        spec = _engine(models, "port", spec=True, drafter="junk")
        base = _engine(models, "port")
        nfree0 = spec.cache.pool.num_free
        Request = GenerationRequest
        s_seqs = [spec.submit(Request(**r)) for r in reqs]
        b_seqs = [base.submit(Request(**r)) for r in reqs]
        lockstep = 0
        while spec.has_work() or base.has_work():
            if spec.has_work():
                spec.step()
            if base.has_work():
                base.step()
            if spec.stats["spec_accepted"] == 0:
                assert _pool_state(spec) == _pool_state(base)
                lockstep += 1
        assert lockstep >= 8
        got = [s.tokens for s in s_seqs]
        assert got == [s.tokens for s in b_seqs]
        j_streams, _, j_stats, _, _ = _jax_run(
            models, "junk", [reqs], spec=True, drafter="junk")
        assert got == j_streams
        assert _stats(spec) == j_stats
        assert spec.stats["spec_proposed"] > 0
        assert spec.stats["spec_accepted"] <= spec.stats["spec_proposed"] / 2
        assert spec.cache.pool.num_free == nfree0
        assert int((spec.cache.pool._ref > 0).sum()) == 0

    def test_cancel_mid_verify_restores_pool(self, models):
        eng = _engine(models, "port", spec=True, drafter="model")
        pool = eng.cache.pool
        nfree0 = pool.num_free
        seq = eng.submit(GenerationRequest(**_req(41, max_new_tokens=40)))
        other = eng.submit(GenerationRequest(**_req(42, max_new_tokens=6)))
        for _ in range(3):
            eng.step()
        assert seq.status == "running"
        eng.cancel(seq)
        while eng.has_work():
            eng.step()
        assert other.done and seq.finish_reason == "cancelled"
        assert pool.num_free == nfree0
        assert int((pool._ref > 0).sum()) == 0

    def test_donated_blocks_survive_rollback_traffic(self, models):
        reqs = [_req(51, n=24, max_new_tokens=10),
                _req(51, n=24, max_new_tokens=10),
                _req(52, n=17, max_new_tokens=10)]
        waves = [[r] for r in reqs]
        kw = dict(spec=True, drafter="junk", prefix_cache=True,
                  prefix_blocks=16)
        got, _, eng = _drive(_engine(models, "port", **kw), "port", waves)
        j_streams, _, j_stats, j_pc, _ = _jax_run(models, "donate", waves,
                                                  **kw)
        assert got == j_streams
        assert _stats(eng) == j_stats
        assert eng.prefix_cache.stats == j_pc
        pool = eng.cache.pool
        assert pool.num_used == eng.prefix_cache.num_cached_blocks
        assert int((pool._ref > 0).sum()) == 0
        assert eng.prefix_cache.stats["hits"] >= 1


# --------------------------------------------------------- fault interplay
class TestFaultInterplay:
    def test_fatal_mid_speculation_recovers_byte_identical(self, models):
        """A NaN-corrupting fatal fault while drafts are in flight: the
        supervisor rebuilds, restore() recomputes from accepted tokens
        only, every stream continues as speculation off would."""
        from paddle_tpu_torch.serving.server import ServingGateway
        reqs = [_req(61, max_new_tokens=10),
                _req(62, n=26, max_new_tokens=10),
                _req(63, temperature=0.9, top_k=5, seed=9, max_new_tokens=8)]
        want, _, _ = _drive(_engine(models, "port"), "port", [reqs])
        cache = {}
        drafter = ModelDrafter(models[1])

        def factory():
            return _engine(models, "port", spec_decode=True, spec_k=SPEC_K,
                           drafter=drafter, jit_cache=cache)

        plan = FaultPlan().at_step(4, "nan")
        gw = ServingGateway(factory(), engine_factory=factory,
                            fault_hook=plan, max_restarts=4,
                            retry_backoff_s=0.0, start=False)
        streams = [gw.submit(GenerationRequest(**r)) for r in reqs]
        gw.start()
        outs = [st.result() for st in streams]
        gw.shutdown(drain=True, timeout=60)
        assert [list(ids) for ids, _ in outs] == want
        assert gw.restarts == 1
        assert plan.log == [(4, "nan")]
        assert gw.engine.decode_compilations() == 1

    def test_restore_recomputes_from_accepted_tokens_only(self, models):
        want, _, _ = _drive(_engine(models, "port"), "port",
                            [[_req(71, max_new_tokens=14)]])
        eng = _engine(models, "port", spec=True, drafter="model")
        seq = eng.submit(GenerationRequest(**_req(71, max_new_tokens=14)))
        for _ in range(3):
            eng.step()
        assert 0 < len(seq.tokens) < 14
        eng._preempt(seq)
        assert seq.status == "queued"
        assert len(seq.work) == seq.prompt_len + len(seq.tokens) - 1
        while eng.has_work():
            eng.step()
        assert seq.tokens == want[0]


class TestMetricsSurface:
    def test_spec_metrics_strict_parsed(self, models):
        from paddle_tpu_torch.profiler.metrics import SPEC_ACCEPT_BUCKETS
        from paddle_tpu_torch.serving.server import ServingGateway
        cache = {}
        drafter = ModelDrafter(models[1])

        def factory():
            return _engine(models, "port", spec_decode=True, spec_k=SPEC_K,
                           drafter=drafter, jit_cache=cache)

        gw = ServingGateway(factory(), engine_factory=factory, start=False)
        streams = [gw.submit(GenerationRequest(**_req(81,
                                                      max_new_tokens=10))),
                   gw.submit(GenerationRequest(**_req(82,
                                                      max_new_tokens=8)))]
        gw.start()
        for st in streams:
            st.result()
        eng = gw.engine
        gw.shutdown(drain=True, timeout=60)
        fams = parse_prometheus(gw.registry.render())
        assert fams["serving_spec_proposed_total"]["samples"][
            ("serving_spec_proposed_total", ())] == \
            eng.stats["spec_proposed"]
        assert fams["serving_spec_accepted_total"]["samples"][
            ("serving_spec_accepted_total", ())] == \
            eng.stats["spec_accepted"]
        name = "serving_spec_accept_length"
        assert fams[name]["type"] == "histogram"
        le = [k for k in fams[name]["samples"] if k[0] == name + "_bucket"]
        bounds = {lbl[1] for _, lbls in le for lbl in lbls
                  if lbl[0] == "le"}
        assert len(bounds) == len(SPEC_ACCEPT_BUCKETS) + 1
        assert fams[name]["samples"][(name + "_sum", ())] == \
            eng.stats["spec_tokens"]
        assert fams[name]["samples"][(name + "_count", ())] > 0
        assert eng.stats["spec_last_accept"] == []
        g = "serving_spec_launches_per_accepted_token"
        assert fams[g]["samples"][(g, ())] == pytest.approx(
            eng.stats["decode_calls"] / max(eng.stats["spec_tokens"], 1))
