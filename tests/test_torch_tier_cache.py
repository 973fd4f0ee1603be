"""The port's host-RAM spill tier behind the prefix trie against the JAX
package, on the CPU, on ``llama_tiny`` (GQA, ``decode_attention="jnp"``)
with the JAX model's weights carried across.

- transparency: two alternating 2-block system-prompt families under a
  2-block trie budget thrash the trie, so every family switch spills the
  other family's chain and every return readmits it — on the dense
  engine, the paged engine and int8 and fp8 pools (scale planes spilled
  and readmitted with their blocks). Streams equal the tier-off engine,
  the cache-off engine and the JAX engine with the same knobs; the trie's
  stats (spills, tier hits, readmitted blocks) equal JAX's; the tier's
  bytes equal JAX's;
- default off: no tier, no bytes, every tier stat 0; negative budgets
  refused;
- the transfer signatures stay bounded by the geometry, not the traffic;
- staging reuse: one host buffer a plane per (shape, dtype), however many
  spills; shared entries are never recycled;
- ``HostTier`` itself: digests, LRU with the descendant cascade, the
  budget;
- the cost observatory's tier ledger and the gateway's tier series
  against the JAX gateway's for the same traffic.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving import HostTier as JHostTier
from paddle_tpu.serving import decode as jdec
from paddle_tpu.serving.server import ServingGateway as JGateway
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           load_decode_params)
from paddle_tpu_torch.serving import (BlockManager,
                                      ContinuousBatchingEngine,
                                      GenerationRequest, PrefixCache)
from paddle_tpu_torch.serving.block_manager import tier_compilations
from paddle_tpu_torch.serving.prefix_cache import HostTier
from paddle_tpu_torch.serving.server import ServingGateway

from test_metrics_prom import parse_prometheus
from torch_threads import one_torch_thread  # noqa: F401

BS = 8       # KV block size
CHUNK = 16   # chunked-prefill budget (2 blocks)
TIER = 1 << 24   # a generous host budget: the LRU never trims in the legs
TIER_STATS = ("hits", "misses", "evictions", "spilled_blocks", "tier_hits",
              "readmitted_blocks", "tier_evictions", "tier_transfers")


@pytest.fixture(scope="module")
def models():
    paddle.seed(29)
    jm = JLlama(j_tiny(decode_attention="jnp"))
    p, tied = jdec.llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


def _geo(**kw):
    g = dict(num_slots=2, max_seq_len=96, decode_chunk=1, prefix_cache=True,
             prefix_block_size=BS, prefill_chunk=CHUNK, headroom_mult=None)
    g.update(kw)
    return g


def _engine(models, side, **kw):
    jm, tm = models
    if side == "jax":
        kw.setdefault("jit_cache", jm.__dict__.setdefault("_tier_jit", {}))
        return JEngine(jm, **_geo(**kw))
    return ContinuousBatchingEngine(tm, **_geo(**kw))


#: two 2-block system-prompt families; under a 2-block trie budget one is
#: resident at a time, so alternating them thrashes the trie
_FAMS = [np.random.RandomState(200 + f).randint(
    0, 256, (2 * BS,)).astype(np.int32) for f in range(2)]


def _req(fam, tail_seed, **kw):
    tail = np.random.RandomState(tail_seed).randint(
        0, 256, (6,)).astype(np.int32)
    kw.setdefault("max_new_tokens", 6)
    return dict(prompt=np.concatenate([_FAMS[fam], tail]), **kw)


def _thrash(rounds=3):
    """A/B/A/B...: one request per family per round, round 2 sampled."""
    reqs = []
    for i in range(rounds):
        for fam in (0, 1):
            kw = {}
            if i == 1:
                kw = dict(temperature=0.8, top_k=5, seed=700 + 10 * fam + i)
            reqs.append(_req(fam, 10 * fam + i, **kw))
    return reqs


def _serial(eng, side, reqs):
    """One request at a time: trie pressure peaks per publish and the
    spill/readmit order is deterministic."""
    Request = JRequest if side == "jax" else GenerationRequest
    return [eng.generate([Request(**r)])[0].tolist() for r in reqs]


def _pc_stats(pc):
    return {k: pc.stats[k] for k in TIER_STATS}


_JAX = {}


def _jax_run(models, key, reqs, **kw):
    """The JAX engine's streams and trie stats for a knob set and request
    list, run once per file."""
    if key not in _JAX:
        eng = _engine(models, "jax", **kw)
        streams = _serial(eng, "jax", reqs)
        pc = eng.prefix_cache
        _JAX[key] = (streams, _pc_stats(pc),
                     pc.tier.bytes_used if pc.tier is not None else 0,
                     pc.tier.num_blocks if pc.tier is not None else 0)
    return _JAX[key]


# --------------------------------------------------------- transparency
class TestTierTransparency:
    def test_dense_thrash_streams_identical_and_hits_recovered(
            self, models):
        """A 2-block dense pool thrashed by two alternating families: the
        trie without a tier forgets each evicted family, the tier readmits
        them — both stream the cache-off engine's tokens and the JAX
        tiered engine's, with JAX's spill and readmit counts."""
        reqs = _thrash()
        want = _serial(_engine(models, "port", prefix_cache=False,
                               paged_attn=False), "port", reqs)
        hbm = _engine(models, "port", paged_attn=False, prefix_blocks=2)
        assert _serial(hbm, "port", reqs) == want
        assert hbm.prefix_cache.stats["tier_hits"] == 0
        eng = _engine(models, "port", paged_attn=False, prefix_blocks=2,
                      host_tier_bytes=TIER)
        pc = eng.prefix_cache
        got = _serial(eng, "port", reqs)
        j_streams, j_stats, j_bytes, j_blocks = _jax_run(
            models, "dense", reqs, paged_attn=False, prefix_blocks=2,
            host_tier_bytes=TIER)
        assert got == want == j_streams
        assert _pc_stats(pc) == j_stats
        assert pc.tier.bytes_used == j_bytes
        assert pc.tier.num_blocks == j_blocks
        assert pc.stats["spilled_blocks"] > 0
        assert pc.stats["tier_hits"] > 0
        assert pc.stats["readmitted_blocks"] >= 2 * pc.stats["tier_hits"]
        assert pc.stats["hits"] > hbm.prefix_cache.stats["hits"]
        assert pc.pool.num_used <= pc.pool.num_blocks
        assert not pc.pool._ref.any()
        assert eng.decode_compilations() == 1

    def test_paged_thrash_streams_identical(self, models):
        reqs = _thrash()
        off = _engine(models, "port", prefix_blocks=2)
        want = _serial(off, "port", reqs)
        eng = _engine(models, "port", prefix_blocks=2, host_tier_bytes=TIER)
        pc = eng.prefix_cache
        got = _serial(eng, "port", reqs)
        j_streams, j_stats, j_bytes, _ = _jax_run(
            models, "paged", reqs, prefix_blocks=2, host_tier_bytes=TIER)
        assert got == want == j_streams
        assert _pc_stats(pc) == j_stats
        assert pc.tier.bytes_used == j_bytes
        assert pc.stats["spilled_blocks"] > 0
        assert pc.stats["readmitted_blocks"] > 0
        assert pc.stats["hits"] > off.prefix_cache.stats["hits"]
        assert eng.decode_compilations() == 1
        # every slot retired: the pool holds trie blocks only, unpinned
        assert eng.cache.pool.num_used == pc.num_cached_blocks
        assert not eng.cache.pool._ref.any()

    @pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
    def test_int8_kv_tier_roundtrips_scale_planes(self, models, kv_dtype):
        """A quantized pool's scale planes spill and readmit with their
        blocks (one tier entry, four planes), streams equal the tier-off
        quantized engine's and JAX's."""
        import torch
        reqs = _thrash()
        want = _serial(_engine(models, "port", kv_dtype=kv_dtype,
                               prefix_blocks=2), "port", reqs)
        eng = _engine(models, "port", kv_dtype=kv_dtype, prefix_blocks=2,
                      host_tier_bytes=TIER)
        pc = eng.prefix_cache
        got = _serial(eng, "port", reqs)
        j_streams, j_stats, j_bytes, _ = _jax_run(
            models, kv_dtype, reqs, kv_dtype=kv_dtype, prefix_blocks=2,
            host_tier_bytes=TIER)
        assert got == want == j_streams
        assert _pc_stats(pc) == j_stats
        assert pc.tier.bytes_used == j_bytes
        assert pc.stats["spilled_blocks"] > 0
        assert pc.stats["readmitted_blocks"] > 0
        with pc.tier._lock:
            bufs = next(iter(pc.tier._entries.values()))[0]
        assert set(bufs) == {"k", "v", "k_scale", "v_scale"}
        assert bufs["k"].dtype == (torch.int8 if kv_dtype == "int8"
                                   else torch.float8_e4m3fn)
        assert bufs["k_scale"].dtype == torch.float32
        assert eng.decode_compilations() == 1


# ----------------------------------------------------------- default off
class TestTierDefaultOff:
    def test_zero_budget_constructs_no_tier_and_moves_no_bytes(
            self, models):
        eng = _engine(models, "port", paged_attn=False, prefix_blocks=2)
        pc = eng.prefix_cache
        assert pc.tier is None and pc.host_tier_bytes == 0
        _serial(eng, "port", _thrash(rounds=2))
        assert pc.stats["evictions"] > 0
        for key in ("spilled_blocks", "tier_hits", "readmitted_blocks",
                    "tier_evictions", "tier_transfers"):
            assert pc.stats[key] == 0, key

    def test_negative_budget_rejected(self, models):
        with pytest.raises(ValueError, match="host_tier_bytes"):
            PrefixCache(BlockManager(1, 2, 4, 1, 2, device="cpu"),
                        host_tier_bytes=-1)
        with pytest.raises(ValueError, match="host_tier_bytes"):
            _engine(models, "port", host_tier_bytes=-5)


# -------------------------------------------------------- compile budget
class TestTierCompileDiscipline:
    def test_transfer_programs_bounded_by_geometry_not_traffic(
            self, models):
        """A repeat thrash wave moves more blocks but adds no transfer
        signature (the block id is a runtime index), and the engine's
        decode program count stays 1."""
        eng = _engine(models, "port", paged_attn=False, prefix_blocks=2,
                      host_tier_bytes=TIER)
        reqs = _thrash(rounds=2)
        _serial(eng, "port", reqs)
        n0 = tier_compilations()
        assert n0 >= 2          # >= one fetch + one inject signature
        spilled0 = eng.prefix_cache.stats["spilled_blocks"]
        _serial(eng, "port", reqs)
        assert eng.prefix_cache.stats["spilled_blocks"] > spilled0
        assert tier_compilations() == n0
        assert eng.decode_compilations() == 1


# ------------------------------------------------------- staging reuse
class TestStagingReuse:
    def test_unit_one_allocation_per_shape_across_spill_cycles(self):
        pool = BlockManager(2, 4, 4, 1, 2, device="cpu")
        for cycle in range(5):
            for b in range(pool.num_blocks):
                bufs = pool.read_block(b)
                assert set(bufs) == {"k", "v"}
                assert tuple(bufs["k"].shape) == (2, 1, 4, 1, 2)
                pool.recycle_staging(bufs)
        alloc = pool.staging.allocations
        assert alloc and all(n == 1 for n in alloc.values()), alloc

    def test_read_write_roundtrip_in_place(self):
        """A block read out and written into another block lands bit for
        bit, scale planes included, and the pool tensors keep their
        storage (the captured tail and the fused tick hold them)."""
        import torch
        for kv in (None, "int8", "fp8"):
            pool = BlockManager(2, 5, 4, 2, 8, kv_dtype=kv, device="cpu")
            g = torch.Generator().manual_seed(1)
            for name in ("k", "v", "k_scale", "v_scale"):
                if getattr(pool, name) is None:
                    continue
                t = getattr(pool, name)[0]              # the one shard
                src = torch.randn(t.shape, generator=g) * 3
                t.copy_(src.to(t.dtype) if t.dtype != torch.int8
                        else src.clamp(-127, 127).to(torch.int8))
            ptrs = {n: getattr(pool, n)[0].data_ptr() for n in ("k", "v")}
            bufs = pool.read_block(1)
            pool.write_block(3, bufs)
            pool.recycle_staging(bufs)
            for name in bufs:
                t = getattr(pool, name)[0]
                a, b = t[:, 1], t[:, 3]
                if t.dtype == torch.float8_e4m3fn:
                    a, b = a.view(torch.uint8), b.view(torch.uint8)
                assert torch.equal(a, b), (kv, name)
            assert {n: getattr(pool, n)[0].data_ptr()
                    for n in ("k", "v")} == ptrs

    def test_engine_thrash_allocates_once_per_shape(self, models):
        """A one-block tier budget under the thrash: every spill replaces
        (recycles) the previous entry and every readmission
        writes-then-recycles, so at most two buffers a plane are ever
        allocated, and a repeat wave allocates none."""
        probe = _engine(models, "port", prefix_blocks=2)
        per_block = (probe.cache.pool.block_nbytes
                     + probe.cache.pool.scale_block_nbytes)
        eng = _engine(models, "port", prefix_blocks=2,
                      host_tier_bytes=per_block)
        pc = eng.prefix_cache
        reqs = _thrash(rounds=3)
        _serial(eng, "port", reqs)
        warm = dict(pc.pool.staging.allocations)
        spilled = pc.stats["spilled_blocks"]
        assert warm and all(n <= 2 for n in warm.values()), warm
        _serial(eng, "port", reqs)
        assert pc.stats["spilled_blocks"] > spilled
        assert pc.pool.staging.allocations == warm

    def test_shared_entries_are_never_recycled(self):
        t = HostTier(capacity_bytes=64)
        recycled = []
        t.on_recycle = recycled.append
        t.put(((1,),), {"k": np.full((64,), 1, np.uint8)})
        assert t.export_digest(HostTier.chain_digests(((1,),))[-1])
        t.put(((1,),), {"k": np.full((64,), 2, np.uint8)})
        assert recycled == []
        t.put(((1,),), {"k": np.full((64,), 3, np.uint8)})
        assert len(recycled) == 1 and recycled[0]["k"][0] == 2


# ---------------------------------------------------------- HostTier unit
class TestHostTierUnit:
    def _bufs(self, fill, nbytes=64):
        return {"k": np.full((nbytes // 2,), fill, np.uint8),
                "v": np.full((nbytes // 2,), fill, np.uint8)}

    def test_chain_digests_content_only_and_incremental(self):
        a = [(1, 2, 3), (4, 5, 6), (7, 8, 9)]
        d = HostTier.chain_digests(a)
        assert len(d) == 3 and len(set(d)) == 3
        assert HostTier.chain_digests(list(a)) == d
        assert HostTier.chain_digests(a[:2]) == d[:2]
        assert HostTier.chain_digests([(9, 9, 9)] + a[1:])[0] != d[0]
        assert d == JHostTier.chain_digests(a)    # the reference's digests

    def test_put_pop_lru_and_descendant_cascade(self):
        t = HostTier(capacity_bytes=192)
        pa, pb, pc_ = ((1,),), ((1,), (2,)), ((3,),)
        assert t.put(pa, self._bufs(1)) == 0
        assert t.put(pb, self._bufs(2)) == 0
        assert t.put(pc_, self._bufs(3)) == 0
        assert t.num_blocks == 3 and t.bytes_used == 192
        t.export_digest(HostTier.chain_digests(pc_)[-1])
        dropped = t.put(((4,),), self._bufs(4))
        assert dropped == 2
        assert not t.has(pa) and not t.has(pb)
        assert t.has(pc_) and t.has(((4,),))
        assert t.bytes_used == 128
        bufs, shared = t.pop(pc_)
        assert bufs["k"][0] == 3 and shared is True
        assert t.pop(pc_) is None
        assert t.export_digest("no-such-digest") is None

    def test_oversize_entry_degrades_to_empty_never_over_budget(self):
        t = HostTier(capacity_bytes=32)
        t.put(((1,),), self._bufs(1, nbytes=64))
        assert t.num_blocks == 0 and t.bytes_used == 0

    def test_replace_refreshes_bytes_not_duplicates(self):
        t = HostTier(capacity_bytes=1024)
        p = ((1,), (2,))
        t.put(p, self._bufs(1, nbytes=64))
        t.put(p, self._bufs(2, nbytes=128))
        assert t.num_blocks == 1 and t.bytes_used == 128
        assert t.pop(p)[0]["k"][0] == 2

    def test_random_ops_against_jax(self):
        """The same random put/pop/export sequence through both tiers:
        every return value, the byte count, the entry set and the digest
        table agree."""
        r = np.random.RandomState(4)
        t, j = HostTier(400), JHostTier(400)
        paths = [tuple((i,) for i in range(n)) for n in range(1, 5)] + \
            [((9,),), ((9,), (8,))]
        for op in range(300):
            p = paths[int(r.randint(len(paths)))]
            roll = r.rand()
            if roll < 0.5:
                n = int(r.randint(1, 5)) * 16
                got = t.put(p, {"k": np.zeros(n, np.uint8)})
                want = j.put(p, {"k": np.zeros(n, np.uint8)})
                assert got == want, op
            elif roll < 0.8:
                a, b = t.pop(p), j.pop(p)
                assert (a is None) == (b is None), op
                if a is not None:
                    assert a[1] == b[1] and a[0]["k"].nbytes == \
                        b[0]["k"].nbytes
            else:
                d = HostTier.chain_digests(p)[-1]
                assert (t.export_digest(d) is None) == \
                    (j.export_digest(d) is None), op
            assert t.bytes_used == j.bytes_used, op
            assert set(t._entries) == set(j._entries), op
            assert t.digest_table() == j.digest_table(), op


# ------------------------------------------------- cost ledger + metrics
class TestTierLedger:
    def test_tier_series_equal_jax_gateways(self, models):
        """The same thrash through a gateway of each package: the cost
        observatory's d2h/h2d tier bytes, the spill/readmit counters and
        the tier gauges scrape the same values; /debug/profile carries the
        tiers section."""
        reqs = _thrash(rounds=2)
        fams = {}
        for side, Gw, Request in (("port", ServingGateway,
                                   GenerationRequest),
                                  ("jax", JGateway, JRequest)):
            gw = Gw(_engine(models, side, prefix_blocks=2,
                            host_tier_bytes=TIER), start=False)
            gw.start()
            for r in reqs:
                gw.submit(Request(**r)).result()
            if side == "port":
                prof = gw.profile_doc()
            gw.shutdown(drain=True, timeout=60)
            fams[side] = parse_prometheus(gw.registry.render())
        names = ("serving_tier_bytes_total",
                 "serving_prefix_spilled_blocks_total",
                 "serving_prefix_readmitted_blocks_total",
                 "serving_prefix_tier_hits_total",
                 "serving_prefix_tier_blocks", "serving_prefix_tier_bytes",
                 "serving_prefix_tier_bytes_capacity")
        for name in names:
            assert fams["port"][name]["type"] == fams["jax"][name]["type"]
            assert fams["port"][name]["samples"] == \
                fams["jax"][name]["samples"], name
        tb = fams["port"]["serving_tier_bytes_total"]["samples"]
        d2h = tb[("serving_tier_bytes_total", (("direction", "d2h"),))]
        h2d = tb[("serving_tier_bytes_total", (("direction", "h2d"),))]
        assert d2h > 0 and h2d > 0
        tiers = prof["tiers"]
        assert tiers["host_tier_bytes"] == TIER
        assert tiers["per_direction"]["d2h"]["bytes"] == d2h
        assert tiers["per_direction"]["h2d"]["bytes"] == h2d
