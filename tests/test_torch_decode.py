"""Parity of the port's serving math with the JAX package, on the CPU:
the PRNG key walk (bit for bit), sampling, the LLaMA helpers, the paged
KV cache, and the two serving programs ``_prefill_impl`` and
``_ragged_step_impl`` on ``llama_tiny`` (2 layers) with the JAX model's
weights carried across.

Each port function is held against one named JAX function on the same
numpy-made inputs. Tolerances: keys and token ids exact; float tensors
max-abs <= 1e-5 in float32 (summation order is the only difference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import decode as jdec
from paddle_tpu.serving.kv_cache import PagedKVCache as JPaged
from paddle_tpu_torch.core import random as prng
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.serving import decode as tdec
from paddle_tpu_torch.serving.kv_cache import PagedKVCache, PoolExhausted

ATOL = 1e-5
SEEDS = [0, 1, 7, 42, 1234, 2 ** 31 - 1, 2 ** 32 + 9, -3]


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert float(np.max(np.abs(got - np.asarray(want, np.float32)))) <= atol


# --------------------------------------------------------------------- PRNG
class TestKeyWalk:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_prngkey_and_split_bitwise(self, seed):
        jk = jax.random.PRNGKey(seed)
        tk = prng.PRNGKey(seed)
        assert (np.asarray(jk).astype(np.int64) == tk.numpy()).all()
        for _ in range(3):                     # a short split walk
            js, ts = jax.random.split(jk), prng.split(tk)
            assert (np.asarray(js).astype(np.int64) == ts.numpy()).all()
            jk, tk = js[0], ts[0]

    def test_batched_split_is_vmapped_split(self):
        keys = np.random.RandomState(0).randint(0, 2 ** 32, (5, 2),
                                                dtype=np.uint64)
        want = jax.vmap(jax.random.split)(jnp.asarray(keys, jnp.uint32))
        got = prng.split(torch.from_numpy(keys.astype(np.int64)))
        assert (np.asarray(want).astype(np.int64) == got.numpy()).all()

    @pytest.mark.parametrize("seed", SEEDS[:4])
    def test_random_bits_and_uniform_bitwise(self, seed):
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        bits = jax.random.bits(jk, (257,), jnp.uint32)
        assert (np.asarray(bits).astype(np.int64)
                == prng.random_bits(tk, 257).numpy()).all()
        assert (np.asarray(jax.random.uniform(jk, (257,)))
                == prng.uniform(tk, 257).numpy()).all()

    def test_categorical_matches_on_test_seeds(self):
        """Gumbel-max draws: the random bits are exact and the float log
        may differ from XLA's in the last place, so a draw could flip
        only on a near-tie; over 256 draws we allow at most 2."""
        keys = jax.random.split(jax.random.PRNGKey(5), 256)
        lg = np.random.RandomState(1).randn(256, 256).astype(np.float32)
        want = np.asarray(jax.vmap(jax.random.categorical)(
            keys, jnp.asarray(lg)))
        got = prng.categorical(
            torch.from_numpy(np.asarray(keys).astype(np.int64)),
            torch.from_numpy(lg)).numpy()
        assert int((want != got).sum()) <= 2


class TestSampleRows:
    def test_greedy_takes_first_max_on_ties(self):
        lg = np.zeros((3, 10), np.float32)
        lg[0, [2, 7]] = 1.0
        lg[1, [0, 9]] = 3.0
        lg[2, :] = 0.5
        keys = np.zeros((3, 2), np.int64)
        got = tdec.sample_rows(torch.from_numpy(lg), keys,
                               np.zeros(3, np.float32), np.zeros(3, np.int32))
        assert got.tolist() == [2, 0, 0]

    def test_mixed_greedy_and_topk_match_jax(self):
        r = np.random.RandomState(3)
        lg = r.randn(6, 64).astype(np.float32)
        keys = r.randint(0, 2 ** 31, (6, 2)).astype(np.int64)
        temps = np.array([0, 0.7, 1.0, 0, 1.3, 0.5], np.float32)
        topks = np.array([0, 5, 0, 3, 1, 64], np.int32)
        want = jdec.sample_rows(jnp.asarray(lg), jnp.asarray(keys,
                                                             jnp.uint32),
                                jnp.asarray(temps), jnp.asarray(topks))
        got = tdec.sample_rows(torch.from_numpy(lg), keys, temps, topks)
        assert got.tolist() == np.asarray(want).tolist()


# ------------------------------------------------------------ model helpers
class TestLlamaHelpers:
    def test_rope_tables_and_rotation(self):
        js, jc = jllama._rope_tables(50, 16, 10000.0)
        ts, tc = tllama._rope_tables(50, 16, 10000.0)
        _close(ts, js)
        _close(tc, jc)
        x = np.random.RandomState(0).randn(2, 50, 3, 16).astype(np.float32)
        _close(tllama._apply_rope(torch.from_numpy(x), ts, tc),
               jllama._apply_rope(jnp.asarray(x), js, jc))

    def test_rms_casts_back_before_the_weight(self):
        r = np.random.RandomState(1)
        x = r.randn(4, 32).astype(np.float32)
        w = r.randn(32).astype(np.float32)
        _close(tllama._rms(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
               jllama._rms(jnp.asarray(x), jnp.asarray(w), 1e-5))
        xb = torch.from_numpy(x).bfloat16()
        wb = torch.from_numpy(w).bfloat16()
        got = tllama._rms(xb, wb, 1e-5)
        assert got.dtype == torch.bfloat16
        want = (tllama._rms(xb.float(), torch.ones(32), 1e-5)
                .bfloat16() * wb)
        assert torch.equal(got, want)

    def test_swiglu_and_qkv_match(self):
        r = np.random.RandomState(2)
        # weights at a model's scale keep outputs O(1), where 1e-5 is
        # a float32 summation-order bound
        hn = r.randn(2, 5, 16).astype(np.float32)
        g, u = (0.2 * r.randn(16, 24)).astype(np.float32), \
            (0.2 * r.randn(16, 24)).astype(np.float32)
        d = (0.2 * r.randn(24, 16)).astype(np.float32)
        t = [torch.from_numpy(a) for a in (hn, g, u, d)]
        _close(tllama._swiglu_raw(*t),
               jllama._swiglu_raw(*(jnp.asarray(a) for a in (hn, g, u, d))))
        wq, wk = r.randn(16, 16).astype(np.float32), \
            r.randn(16, 8).astype(np.float32)
        got = tllama._qkv_bshd(t[0], torch.from_numpy(wq),
                               torch.from_numpy(wk), torch.from_numpy(wk),
                               4, 2, 4)
        want = jllama._qkv_bshd(jnp.asarray(hn), jnp.asarray(wq),
                                jnp.asarray(wk), jnp.asarray(wk), 4, 2, 4)
        for a, b in zip(got, want):
            _close(a, b)


# ------------------------------------------------------- weights + programs
@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(num_hidden_layers=2))
    p, tied = jdec.llama_decode_params(jm)
    pn = {k: np.asarray(v) for k, v in p.items()}
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(num_hidden_layers=2),
                                 device="cpu")
    tllama.load_decode_params(tm, pn, tied)
    return jm, p, tm


CONSTS = dict(nh=4, nkv=2, hd=16, eps=1e-5, theta=10000.0, tied=False)


class TestWeights:
    def test_load_carries_every_parameter(self, models):
        _, p, tm = models
        tp, tied = tllama.llama_decode_params(tm)
        assert not tied and set(tp) == set(p)
        for k in p:
            assert torch.equal(tp[k], torch.from_numpy(np.array(p[k])))

    def test_tied_head_is_the_embedding(self):
        cfg = tllama.llama_tiny(num_hidden_layers=1, tie_word_embeddings=True)
        m = tllama.LlamaForCausalLM(cfg, device="cpu")
        p, tied = tllama.llama_decode_params(m)
        assert tied and p["lm_head"] is m.embed_tokens
        with pytest.raises(ValueError):
            tllama.load_decode_params(m, {}, tied=False)

    def test_seeded_init_is_deterministic(self):
        cfg = tllama.llama_tiny(num_hidden_layers=1)
        a = tllama.LlamaForCausalLM(cfg, device="cpu", seed=3)
        b = tllama.LlamaForCausalLM(cfg, device="cpu", seed=3)
        assert torch.equal(a.wq, b.wq) and torch.equal(a.lm_head, b.lm_head)
        assert float(a.wq.std()) == pytest.approx(0.02, rel=0.2)
        assert torch.equal(a.input_ln, torch.ones_like(a.input_ln))


class TestPrefill:
    def test_prefill_impl_matches_jax(self, models):
        _, p, tm = models
        r = np.random.RandomState(4)
        ids = r.randint(0, 256, (2, 16)).astype(np.int32)
        lens = np.array([16, 9], np.int32)
        keys = r.randint(0, 2 ** 31, (2, 2)).astype(np.int64)
        temps = np.array([0.0, 0.8], np.float32)
        topks = np.array([0, 3], np.int32)
        jpk, jpv, jtok, jkeys = jdec._prefill_impl(
            p, jnp.asarray(ids), jnp.asarray(lens),
            jnp.asarray(keys, jnp.uint32), jnp.asarray(temps),
            jnp.asarray(topks), **CONSTS)
        tp, _ = tllama.llama_decode_params(tm)
        (pk,), (pv,), tok, tkeys = tdec._prefill_impl(
            [tp], ids, lens, keys, temps, topks, **CONSTS)
        _close(pk, jpk)
        _close(pv, jpv)
        assert tok.tolist() == np.asarray(jtok).tolist()
        assert (tkeys.numpy() == np.asarray(jkeys).astype(np.int64)).all()


def _step_inputs(seed=6):
    """A packed step: slot 0 decodes at cache length 10, slot 1 prefills a
    6-token chunk at positions 8..13 (mid-block), slot 2 idle; bs=8,
    mb=4, 6 pool blocks (sentinel 6), a 3-token dead tail."""
    r = np.random.RandomState(seed)
    L, nb, bs, Hkv, D = 2, 6, 8, 2, 16
    pk = r.randn(L, nb, bs, Hkv, D).astype(np.float32)
    pv = r.randn(L, nb, bs, Hkv, D).astype(np.float32)
    tables = np.full((3, 4), nb, np.int32)
    tables[0, :2] = [4, 1]
    tables[1, :2] = [0, 3]
    T = 10
    ids = np.zeros(T, np.int32)
    seg = np.full(T, 3, np.int32)
    pos = np.zeros(T, np.int32)
    ids[0], seg[0], pos[0] = 17, 0, 10
    ids[1:7] = r.randint(0, 256, 6)
    seg[1:7] = 1
    pos[1:7] = np.arange(8, 14)
    qstart = np.array([0, 1, 0], np.int32)
    qlen = np.array([1, 6, 0], np.int32)
    kvlen = np.array([11, 14, 0], np.int32)
    dec_mask = np.array([1, 0, 0], np.int32)
    keys = r.randint(0, 2 ** 31, (3, 2)).astype(np.int64)
    temps = np.array([0.9, 0.0, 0.0], np.float32)
    topks = np.array([5, 0, 0], np.int32)
    return (pk, pv, tables, ids, seg, pos, qstart, qlen, kvlen, dec_mask,
            keys, temps, topks)


class TestRaggedStep:
    @pytest.mark.parametrize("n_steps", [1, 3])
    def test_ragged_step_impl_matches_jax(self, models, n_steps):
        _, p, tm = models
        (pk, pv, tables, ids, seg, pos, qstart, qlen, kvlen, dec_mask, keys,
         temps, topks) = _step_inputs()
        jout = jdec._ragged_step_impl(
            p, jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
            jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos),
            jnp.asarray(qstart), jnp.asarray(qlen), jnp.asarray(kvlen),
            jnp.asarray(dec_mask), jnp.asarray(keys, jnp.uint32),
            jnp.asarray(temps), jnp.asarray(topks), n_steps=n_steps,
            decode_attn="jnp", **CONSTS)
        tp, _ = tllama.llama_decode_params(tm)
        tpk, tpv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
        tout = tdec._ragged_step_impl(
            [tp], [tpk], [tpv], tables, ids, seg, pos, qstart, qlen, kvlen,
            dec_mask, keys, temps, topks, n_steps=n_steps, **CONSTS)
        assert tout[0] == [tpk] and tout[1] == [tpv]    # updated in place
        assert tout[0][0] is tpk and tout[1][0] is tpv
        _close(tpk, jout[0])
        _close(tpv, jout[1])
        assert tout[2].tolist() == np.asarray(jout[2]).tolist()
        for a, b in zip(tout[3:], jout[3:]):
            assert (a.numpy() == np.asarray(b).astype(np.int64)).all()

    def test_dead_rows_never_write(self, models):
        """Dead packed rows, the idle slot and sentinel table entries
        leave the pool untouched outside the rows the step owns."""
        _, _, tm = models
        args = _step_inputs()
        pk, pv = args[0], args[1]
        tpk, tpv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
        tp, _ = tllama.llama_decode_params(tm)
        tdec._ragged_step_impl([tp], [tpk], [tpv], *args[2:], n_steps=3,
                               **CONSTS)
        changed = (tpk.numpy() != pk).any(axis=(0, 3, 4))   # [nb, bs]
        owned = np.zeros_like(changed)
        owned[1, 2:5] = True          # slot 0 rows 10..12 (block 1)
        owned[0, :] = True            # slot 1 rows 8..13: block 0 ...
        owned[3, :] = True            # ... and block 3
        assert not (changed & ~owned).any()


# ---------------------------------------------------------------- KV cache
class TestPagedCache:
    def test_lifecycle_matches_jax(self):
        """Same op sequence, same tables and free counts."""
        kw = dict(num_layers=1, num_slots=3, max_seq_len=40,
                  num_kv_heads=2, head_dim=4, block_size=8)
        j = JPaged(**kw)
        t = PagedKVCache(**kw, device="cpu")
        ops = [("alloc",), ("alloc",), ("grow", 0, 17), ("grow", 1, 3),
               ("grow", 0, 30), ("free", 0), ("alloc",), ("grow", 0, 9),
               ("free", 1), ("grow", 0, 40)]
        for op in ops:
            for c in (j, t):
                if op[0] == "alloc":
                    c.alloc()
                elif op[0] == "grow":
                    c.ensure_capacity(op[1], op[2])
                else:
                    c.free(op[1])
            assert (j.tables == t.tables).all()
            assert j.num_free == t.num_free
            assert j.pool.num_free == t.pool.num_free

    def test_write_prefill_drops_bucket_padding(self):
        c = PagedKVCache(1, 2, 32, 2, 4, block_size=8, device="cpu")
        s = c.alloc()
        pk = torch.ones(1, 16, 2, 4)
        c.write_prefill(s, [pk], [2 * pk], 11)
        assert c.lengths[s] == 11 and c.tables[s].tolist() == [0, 1, 8, 8]
        k = c.pool.k[0][0]
        assert (k[0] == 1).all() and (k[1, :3] == 1).all()
        assert (k[1, 3:] == 0).all() and (k[2:] == 0).all()
        assert (c.pool.v[0][0, 1, :3] == 2).all()

    def test_failed_growth_leaks_no_block(self):
        """A PoolExhausted on the third block of a growth leaves the two
        blocks already taken counted, so freeing the slot returns them
        (the reference loses them: ROADMAP Queue C 1)."""
        c = PagedKVCache(1, 1, 40, 1, 4, block_size=8, device="cpu")
        s = c.alloc()
        real, calls = c.pool.alloc, []

        def flaky():
            calls.append(1)
            return None if len(calls) == 3 else real()
        c.pool.alloc = flaky
        with pytest.raises(PoolExhausted):
            c.ensure_capacity(s, 40)
        c.pool.alloc = real
        c.free(s)
        assert c.pool.num_free == c.pool.num_blocks

    def test_exhausted_pool_raises_typed(self):
        c = PagedKVCache(1, 2, 16, 1, 4, block_size=8, device="cpu")
        a, b = c.alloc(), c.alloc()
        c.ensure_capacity(a, 16)
        c.ensure_capacity(b, 16)
        c.pool.alloc = lambda: None
        c.free(b)
        with pytest.raises(PoolExhausted):
            c.ensure_capacity(c.alloc(), 8)
