"""The port's prefix cache against the JAX package, on the CPU, on
``llama_tiny`` (2 layers) with the JAX model's weights carried across.

- the trie: random interleavings of lookup/acquire, release, publish
  (dense), donation (paged) and eviction run the SAME op sequence through
  both ``PrefixCache``s over both ``BlockManager``s: matched chains,
  adopted block ids, stats, residency and every refcount agree at every
  step, and the trie's invariants hold (no orphan, no aliased block);
- the suffix programs: ``_paged_suffix_prefill_impl`` and
  ``_suffix_prefill_impl`` against JAX's within 1e-5, tokens and keys
  equal, padding rows writing nothing;
- the engines, paged and dense: a wave that publishes, then a wave that
  hits — greedy and seeded-sampled streams equal the JAX engine's and the
  port's own without the cache; ``prefill_tokens_saved``,
  ``prefill_copy_dispatches``, the trie's stats and both compile counts
  equal JAX's; a full-block prompt leaves its final token uncovered; COW
  divergence never aliases; eviction under pressure keeps streams exact;
  pinned blocks never evict and the dense publish degrades;
- the gateway's prefix series parse strictly, with the JAX gateway's
  names and types.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving import decode as jdec
from paddle_tpu.serving.block_manager import BlockManager as JBlockManager
from paddle_tpu.serving.prefix_cache import PrefixCache as JPrefixCache
from paddle_tpu.serving.server import ServingGateway as JGateway
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           llama_decode_params,
                                           load_decode_params)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)
from paddle_tpu_torch.serving import decode as tdec
from paddle_tpu_torch.serving.block_manager import BlockManager
from paddle_tpu_torch.serving.prefix_cache import PrefixCache
from paddle_tpu_torch.serving.server import ServingGateway

from test_metrics_prom import parse_prometheus
from torch_threads import one_torch_thread  # noqa: F401


BS = 8
CONSTS = dict(nh=4, nkv=2, hd=16, eps=1e-5, theta=10000.0, tied=False)
ATOL = 1e-5
_SYS = np.random.RandomState(7).randint(0, 256, 20).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    paddle.seed(21)
    jm = JLlama(j_tiny(num_hidden_layers=2, decode_attention="jnp"))
    p, tied = jdec.llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(num_hidden_layers=2), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, p, tm


def _geo(paged, **kw):
    g = dict(num_slots=2, max_seq_len=64, decode_chunk=1,
             prefix_block_size=BS, paged_attn=paged, prefill_chunk=16,
             headroom_mult=None)
    g.update(kw)
    return g


def _engines(models, paged, **kw):
    jm, _, tm = models
    jit = jm.__dict__.setdefault(f"_pc_jit_{paged}_{sorted(kw.items())}",
                                 {})
    return (JEngine(jm, jit_cache=jit, prefix_cache=True,
                    **_geo(paged, **kw)),
            ContinuousBatchingEngine(tm, prefix_cache=True,
                                     **_geo(paged, **kw)))


def _req(tail_seed, n_tail=6, sys_prompt=_SYS, **kw):
    tail = np.random.RandomState(tail_seed).randint(
        0, 256, n_tail).astype(np.int32)
    kw.setdefault("max_new_tokens", 6)
    return dict(prompt=np.concatenate([sys_prompt, tail]), **kw)


def _gen(engine, Request, reqs):
    return [o.tolist() for o in engine.generate([Request(**r)
                                                 for r in reqs])]


# ------------------------------------------------------------------ trie
class _FakeKV:
    """``publish``'s copy target: records the copies, moves no bytes."""

    def __init__(self):
        self.copies = []

    def copy_block_out(self, slot, row0, pool, block):
        self.copies.append((slot, row0, block))


def _trie_state(pc):
    nodes, stack = [], [(None, pc._root)]
    while stack:
        parent, children = stack.pop()
        for key, node in children.items():
            assert node.tokens == key and node.parent is parent
            nodes.append(node)
            stack.append((node, node.children))
    ids = sorted(n.block_id for n in nodes)
    assert len(set(ids)) == len(ids) == pc._nodes
    return ids


class TestTrieAgainstJax:
    NB, BSU = 8, 4

    def test_random_interleavings_run_the_same_ops(self):
        rng = np.random.RandomState(17)
        pools = (JBlockManager(1, self.NB, self.BSU, 1, 2),
                 BlockManager(1, self.NB, self.BSU, 1, 2, device="cpu"))
        caches = (JPrefixCache(pools[0], max_blocks=5),
                  PrefixCache(pools[1], max_blocks=5))
        kvs = (_FakeKV(), _FakeKV())
        prompts = [rng.randint(0, 3, int(n)).astype(np.int32)
                   for n in rng.randint(4, 18, size=12)]
        held = ([], [])
        for step in range(200):
            op = rng.rand()
            prompt = prompts[rng.randint(len(prompts))]
            pick = rng.randint(1 << 30)
            outs = []
            for pc, pool, kv, h in zip(caches, pools, kvs, held):
                if op < 0.25:
                    pc.publish(prompt, 0, kv)
                    outs.append(len(kv.copies))
                elif op < 0.45:
                    # a retiring paged slot: private blocks donated, the
                    # rest dropped (PagedKVCache.free(keep=...))
                    blocks = []
                    for _ in range(len(prompt) // self.BSU):
                        b = pool.alloc()
                        while b is None and pc._evict_one():
                            b = pool.alloc()
                        if b is None:
                            break
                        pool.ref(b)
                        blocks.append(b)
                    kept = pc.publish_donate(prompt, blocks)
                    for b in blocks:
                        if b in kept:
                            pool.unref(b)
                        else:
                            pool.drop(b)
                    outs.append((blocks, sorted(kept)))
                elif op < 0.7:
                    m = pc.lookup(prompt)
                    if m:
                        pc.acquire(m)
                        h.append(m)
                    outs.append([n.block_id for n in m])
                elif op < 0.9 and h:
                    pc.release(h.pop(pick % len(h)))
                    outs.append(None)
                else:
                    outs.append(pc._evict_one())
            assert outs[0] == outs[1], step
            ids = [_trie_state(pc) for pc in caches]
            assert ids[0] == ids[1]
            assert caches[0].stats == caches[1].stats
            for b in range(self.NB):
                assert pools[0].refcount(b) == pools[1].refcount(b)
            assert pools[0].num_free == pools[1].num_free
            assert pools[0].peak_used == pools[1].peak_used
            want = collections.Counter(n.block_id for m in held[1]
                                       for n in m)
            assert all(pools[1].refcount(b) == want.get(b, 0)
                       for b in range(self.NB))
        st = caches[1].stats
        assert st["evictions"] and st["donated_blocks"] and st["hits"]
        assert caches[1].hit_rate() == caches[0].hit_rate()
        for m in held[1]:
            caches[1].release(m)
        while caches[1]._evict_one():
            pass
        assert caches[1].num_cached_blocks == 0 and pools[1].num_used == 0

    def test_pinned_blocks_never_evict_and_publish_degrades(self):
        """A dense trie whose whole pool is pinned by readers skips the
        next publish instead of failing, as JAX's does."""
        for Pool, Cache, kw in ((JBlockManager, JPrefixCache, {}),
                                (BlockManager, PrefixCache,
                                 dict(device="cpu"))):
            pool = Pool(1, 2, 4, 1, 2, **kw)
            pc, kv = Cache(pool), _FakeKV()
            a = np.arange(9, dtype=np.int32)
            pc.publish(a, 0, kv)
            held = pc.lookup(a)
            pc.acquire(held)
            assert len(held) == 2 and not pc._evict_one()
            pc.publish(a + 50, 0, kv)
            assert pc.stats["skipped_publishes"] == 1
            assert pc.num_cached_blocks == 2 and len(kv.copies) == 2

    def test_host_tier_names_its_step(self):
        """Refused until the host tier was ported (it named its ROADMAP
        step); a budget now builds the tier, wired to the pool's staging
        recycler, and a negative one is refused as the reference does."""
        pool = BlockManager(1, 2, 4, 1, 2, device="cpu")
        pc = PrefixCache(pool, host_tier_bytes=1 << 20)
        assert pc.tier is not None and pc.host_tier_bytes == 1 << 20
        assert pc.tier.on_recycle == pool.recycle_staging
        with pytest.raises(ValueError, match="host_tier_bytes"):
            PrefixCache(pool, host_tier_bytes=-1)


# -------------------------------------------------------- suffix programs
class TestSuffixPrograms:
    def _inputs(self, r, G=4, S=8):
        ids = r.randint(0, 256, (G, S)).astype(np.int32)
        keys = r.randint(0, 2 ** 31, (G, 2)).astype(np.int64)
        temps = np.array([0.0, 0.7, 0.0, 0.0], np.float32)
        topks = np.array([0, 4, 0, 0], np.int32)
        return ids, keys, temps, topks

    def _check(self, tout, jout, pools):
        for got, want in zip(pools, jout[:2]):
            assert float(np.abs(got.numpy() - np.asarray(want)).max()) \
                <= ATOL
        assert tout[2].tolist()[:3] == np.asarray(jout[2]).tolist()[:3]
        assert (tout[3].numpy()[:3]
                == np.asarray(jout[3]).astype(np.int64)[:3]).all()

    def test_paged_suffix_matches_jax(self, models):
        """Row 0 resumes at 16 over a shared 2-block prefix, row 1 at 8
        over one, row 2 from 0 (a cold chunk); row 3 is padding (sentinel
        table, fully covered prefix)."""
        _, p, tm = models
        r = np.random.RandomState(2)
        nb, mb = 12, 4
        pk = r.randn(2, nb, BS, 2, 16).astype(np.float32)
        pv = r.randn(2, nb, BS, 2, 16).astype(np.float32)
        tables = np.full((4, mb), nb, np.int32)
        tables[0, :3] = [3, 5, 0]
        tables[1, :2] = [3, 7]
        tables[2, :1] = [9]
        prefix = np.array([16, 8, 0, mb * BS], np.int32)
        suffix = np.array([6, 8, 5, 1], np.int32)
        ids, keys, temps, topks = self._inputs(r)
        jout = jdec._paged_suffix_prefill_impl(
            p, jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
            jnp.asarray(prefix), jnp.asarray(ids), jnp.asarray(suffix),
            jnp.asarray(keys, jnp.uint32), jnp.asarray(temps),
            jnp.asarray(topks), **CONSTS)
        tp, _ = llama_decode_params(tm)
        tpk, tpv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
        tout = tdec._paged_suffix_prefill_impl(
            [tp], [tpk], [tpv], tables, prefix, ids, suffix, keys, temps,
            topks, **CONSTS)
        assert tout[0][0] is tpk and tout[1][0] is tpv
        self._check(tout, jout, (tpk, tpv))
        # the shared prefix blocks and the padding row were not written
        changed = (tpk.numpy() != pk).any(axis=(0, 3, 4))
        assert not changed[[3, 5]].any() and changed[0, :6].all()

    def test_dense_suffix_matches_jax(self, models):
        _, p, tm = models
        r = np.random.RandomState(3)
        ck = r.randn(2, 3, 64, 2, 16).astype(np.float32)
        cv = r.randn(2, 3, 64, 2, 16).astype(np.float32)
        slots = np.array([2, 0, 1, 3], np.int32)        # 3: padding row
        prefix = np.array([16, 8, 0, 64], np.int32)
        suffix = np.array([6, 8, 5, 1], np.int32)
        ids, keys, temps, topks = self._inputs(r)
        jout = jdec._suffix_prefill_impl(
            p, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(slots),
            jnp.asarray(prefix), jnp.asarray(ids), jnp.asarray(suffix),
            jnp.asarray(keys, jnp.uint32), jnp.asarray(temps),
            jnp.asarray(topks), **CONSTS)
        tp, _ = llama_decode_params(tm)
        tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        tout = tdec._suffix_prefill_impl(
            [tp], tck, tcv, slots, prefix, ids, suffix, keys, temps, topks,
            **CONSTS)
        self._check(tout, jout, (tck, tcv))


# ---------------------------------------------------------------- engines
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_hit_streams_and_stats_equal_jax(models, paged):
    """A first wave publishes the shared system prompt, a second wave
    (greedy and seeded-sampled) hits it."""
    jeng, port = _engines(models, paged)
    wave1 = [_req(1), _req(2, n_tail=9)]
    wave2 = [_req(3), _req(4, temperature=0.8, top_k=5, seed=11),
             _req(5, n_tail=3)]
    for wave in (wave1, wave2):
        assert _gen(port, GenerationRequest, wave) \
            == _gen(jeng, JRequest, wave)
    for key in ("prefill_tokens_saved", "prefill_copy_dispatches",
                "prefill_tokens", "prefills"):
        assert port.stats[key] == jeng.stats[key], key
    assert port.stats["prefill_tokens_saved"] == 3 * 16
    assert port.prefix_cache.stats == jeng.prefix_cache.stats
    assert port.prefix_cache.num_cached_blocks \
        == jeng.prefix_cache.num_cached_blocks
    assert (port.decode_compilations(), port.prefill_compilations()) \
        == (jeng.decode_compilations(), jeng.prefill_compilations())
    cold = ContinuousBatchingEngine(models[2], **_geo(paged))
    assert _gen(cold, GenerationRequest, wave1 + wave2) \
        == _gen(port, GenerationRequest, wave1 + wave2)


def test_full_block_prompt_leaves_final_token_uncovered(models):
    """A prompt of exactly three blocks hits only two of them: the suffix
    prefill needs at least one token to sample from."""
    jeng, port = _engines(models, True)
    prompt = np.arange(3 * BS, dtype=np.int32) + 5
    req = [dict(prompt=prompt, max_new_tokens=4)]
    for eng, Request in ((port, GenerationRequest), (jeng, JRequest)):
        first = _gen(eng, Request, req)
        assert _gen(eng, Request, req) == first
    assert port.stats["prefill_tokens_saved"] == 2 * BS \
        == jeng.stats["prefill_tokens_saved"]
    assert port.prefix_cache.stats["hit_blocks"] == 2


def test_cow_divergence_never_aliases(models):
    """Two sequences share a cached prefix and decode side by side: each
    stream equals its own solo run (no write lands in a shared block), and
    the shared blocks carried a refcount of 2 while both ran."""
    _, port = _engines(models, True)
    _gen(port, GenerationRequest, [_req(1)])
    a, b = _req(6, n_tail=5), _req(7, n_tail=11)
    seqs = [port.submit(GenerationRequest(**r)) for r in (a, b)]
    shared = 0
    while port.has_work():
        port.step()
        shared = max(shared, port.cache.pool.num_shared)
    assert shared >= 2
    solo = [_gen(ContinuousBatchingEngine(models[2], **_geo(True)),
                 GenerationRequest, [r])[0] for r in (a, b)]
    assert [list(s.tokens) for s in seqs] == solo


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_eviction_under_pressure_keeps_streams_exact(models, paged):
    jeng, port = _engines(models, paged, prefix_blocks=3)
    reqs = [_req(i, sys_prompt=np.random.RandomState(40 + i).randint(
        0, 256, 2 * BS).astype(np.int32), max_new_tokens=3)
        for i in range(5)] + [_req(9, max_new_tokens=3)]
    for r in reqs:
        assert _gen(port, GenerationRequest, [r]) == _gen(jeng, JRequest,
                                                          [r])
    assert port.prefix_cache.stats == jeng.prefix_cache.stats
    assert port.prefix_cache.stats["evictions"] > 0
    assert port.cache.num_free == 2


def test_chunked_hit_resumes_past_the_covered_prefix(models):
    """A hit whose uncovered tail is longer than the chunk installs the
    chain and prefills the rest in chunks (unified and two-program)."""
    sys_prompt = np.random.RandomState(5).randint(0, 256, 24).astype(
        np.int32)
    reqs = [_req(1, sys_prompt=sys_prompt, n_tail=4),
            _req(2, sys_prompt=sys_prompt, n_tail=30)]
    for kw in ({}, dict(ragged_step=False)):
        jeng, port = _engines(models, True, **kw)
        for r in reqs:
            assert _gen(port, GenerationRequest, [r]) \
                == _gen(jeng, JRequest, [r])
        assert port.stats["prefill_tokens_saved"] == 24 \
            == jeng.stats["prefill_tokens_saved"]
        assert port.stats["prefill_chunks"] == jeng.stats["prefill_chunks"]


def test_gateway_prefix_series_parse_strictly(models):
    """``registry.render()`` IS the scrape body: the prefix series carry
    the trie's and the engine's counts and parse under the strict v0.0.4
    parser, with the JAX gateway's names and types."""
    jeng, port = _engines(models, False, prefix_blocks=3)
    fams = {}
    for eng, Gw, Request in ((port, ServingGateway, GenerationRequest),
                             (jeng, JGateway, JRequest)):
        gw = Gw(eng, start=False)
        try:
            for i in range(3):
                eng.generate([Request(**_req(70 + i))])
            for i in range(4):      # distinct prompts: force evictions
                eng.generate([Request(prompt=np.random.RandomState(
                    80 + i).randint(0, 256, 2 * BS).astype(np.int32),
                    max_new_tokens=2)])
            fams[Gw] = parse_prometheus(gw.registry.render())
        finally:
            gw.shutdown(drain=False, timeout=10)
    got = fams[ServingGateway]

    def val(name):
        return got[name]["samples"][(name, ())]

    prefix = {n: f["type"] for n, f in fams[JGateway].items()
              if "prefix" in n or n == "serving_prefill_tokens_saved_total"}
    assert {n: got[n]["type"] for n in prefix} == prefix
    assert val("serving_prefix_cache_hits_total") \
        == port.prefix_cache.stats["hits"] >= 2
    assert val("serving_prefix_cache_misses_total") >= 1
    assert val("serving_prefix_cache_evictions_total") \
        == port.prefix_cache.stats["evictions"] >= 1
    assert val("serving_prefill_tokens_saved_total") \
        == port.stats["prefill_tokens_saved"] > 0
    assert val("kv_prefix_blocks") == port.prefix_cache.pool.num_used
    assert val("kv_prefix_blocks_capacity") == 3
    for name in prefix:
        assert val(name) == fams[JGateway][name]["samples"][(name, ())]


def test_shared_cache_carries_hits_and_geometry_is_checked(models):
    """A PrefixCache instance carries its trie and pool from one engine to
    the next (paged: its pool backs the live grid too); a pool whose
    geometry differs from the engine's is refused, as in JAX."""
    tm = models[2]
    pool = BlockManager(2, 2 * 8 + 6, BS, 2, 16, device="cpu")
    pc = PrefixCache(pool)
    first = ContinuousBatchingEngine(tm, prefix_cache=pc, **_geo(True))
    assert pc.max_blocks == 6 and first.cache.pool is pool
    _gen(first, GenerationRequest, [_req(1)])
    first.release()                         # the shared pool stays
    second = ContinuousBatchingEngine(tm, prefix_cache=pc, **_geo(True))
    _gen(second, GenerationRequest, [_req(2)])
    assert second.stats["prefill_tokens_saved"] == 16 and pool.k is not None
    for bad in (BlockManager(2, 40, BS, 2, 32, device="cpu"),
                BlockManager(2, 2 * 8, BS, 2, 16, device="cpu")):
        with pytest.raises(ValueError, match="pool"):
            ContinuousBatchingEngine(tm, prefix_cache=PrefixCache(bad),
                                     **_geo(True))
    with pytest.raises(ValueError, match="geometry"):
        ContinuousBatchingEngine(
            tm, prefix_cache=PrefixCache(BlockManager(
                2, 8, BS, 2, 32, device="cpu")), **_geo(False))
