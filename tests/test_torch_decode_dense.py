"""Parity of the port's dense-slot engine (``paged_attn=False``) with the
JAX package, on the CPU: the dense-cache decode attention, the
``SlotKVCache``, the ``_decode_steps_impl`` program on ``llama_tiny`` (2
layers) with the JAX model's weights carried across, and the engine's
request matrix.

The JAX side runs ``decode_attention_pallas`` in interpret mode (its own
CPU setting) and its jnp reference; the port's wrapper runs its plain
version on CPU tensors. Tolerances: tokens, keys and finish reasons
exact; float tensors max-abs <= 1e-5 in float32 (summation order only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels.pallas_decode import decode_attention_pallas
from paddle_tpu.kernels.pallas_decode import \
    decode_attention_reference as j_decode_ref
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving import decode as jdec
from paddle_tpu.serving.block_manager import BlockManager as JBlockManager
from paddle_tpu.serving.kv_cache import SlotKVCache as JSlot
from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
from paddle_tpu_torch.kernels import decode as tdk
from paddle_tpu_torch.kernels import paged_decode as tpd
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest, SlotKVCache)
from paddle_tpu_torch.serving import decode as tdec
from paddle_tpu_torch.serving.block_manager import BlockManager
from test_torch_engine import _eos_inside_a_tick
from test_torch_engine import _matrix as engine_matrix
from torch_threads import one_torch_thread  # noqa: F401


ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _one_shard(x):
    """K/V as the port's caches and pools take them: a list of shards,
    one here."""
    return [_t(x)]


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert float(np.max(np.abs(got - np.asarray(want, np.float32)))) <= atol


def _dense(B, H, Hkv, D, S, lengths, seed):
    """q and a dense cache whose rows past each length hold NaN."""
    r = np.random.RandomState(seed)
    q = r.randn(B, H, D).astype(np.float32)
    k = r.randn(B, S, Hkv, D).astype(np.float32)
    v = r.randn(B, S, Hkv, D).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    for b in range(B):
        k[b, lengths[b]:] = np.nan
        v[b, lengths[b]:] = np.nan
    return q, k, v, lengths


# ------------------------------------------------------- decode attention
class TestDecodeAttention:
    @pytest.mark.parametrize("B,H,Hkv,D,S,lengths", [
        (3, 4, 2, 32, 40, [1, 40, 17]),        # GQA group 2
        (2, 4, 4, 16, 24, [24, 1]),            # MHA
        (4, 8, 1, 16, 16, [16, 3, 1, 9]),      # MQA
    ])
    def test_matches_pallas_interpret_and_reference(self, B, H, Hkv, D, S,
                                                    lengths):
        q, k, v, lens = _dense(B, H, Hkv, D, S, lengths, seed=B + S)
        got = tdk.decode_attention(_t(q), _t(k), _t(v), _t(lens))
        assert torch.isfinite(got).all()
        args = tuple(jnp.asarray(a) for a in (q, k, v, lens))
        _close(got, decode_attention_pallas(*args))
        _close(got, j_decode_ref(*args))

    def test_one_definition_of_the_plain_version(self):
        """The paged decode's plain version builds on the dense one, which
        lives beside its kernel, as in the JAX package."""
        assert tpd.decode_attention_reference is \
            tdk.decode_attention_reference

    def test_cpu_runs_the_plain_version_and_counts_no_launch(self):
        q, k, v, lens = _dense(2, 4, 2, 16, 8, [8, 3], seed=0)
        reset_launches()
        got = tdk.decode_attention(_t(q), _t(k), _t(v), _t(lens))
        want = tdk.decode_attention_reference(_t(q), _t(k), _t(v),
                                              _t(lens))
        assert torch.equal(got, want) and LAUNCHES["decode"] == 0

    def test_other_devices_raise(self):
        q = torch.zeros(1, 2, 16, device="meta")
        kv = torch.zeros(1, 4, 2, 16, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            tdk.decode_attention(q, kv, kv, [1])


# ------------------------------------------------------------ slot cache
class TestSlotCache:
    KW = dict(num_layers=2, num_slots=3, max_seq_len=16, num_kv_heads=2,
              head_dim=4)

    def test_alloc_order_and_double_free_match_jax(self):
        j, t = JSlot(**self.KW), SlotKVCache(**self.KW, device="cpu")
        ops = [("alloc",), ("alloc",), ("alloc",), ("alloc",), ("free", 1),
               ("free", 0), ("alloc",), ("alloc",), ("free", 2)]
        for op in ops:
            if op[0] == "alloc":
                assert j.alloc() == t.alloc()
            else:
                j.free(op[1])
                t.free(op[1])
            assert j.num_free == t.num_free
        for c in (j, t):
            with pytest.raises(ValueError, match="double-freed"):
                c.free(2)

    def test_write_prefill_and_bytes_match_jax(self):
        r = np.random.RandomState(1)
        pk = r.randn(2, 8, 2, 4).astype(np.float32)
        pv = r.randn(2, 8, 2, 4).astype(np.float32)
        j, t = JSlot(**self.KW), SlotKVCache(**self.KW, device="cpu")
        for c, conv in ((j, jnp.asarray), (t, _one_shard)):
            s = c.alloc()
            s = c.alloc()
            c.write_prefill(s, conv(pk), conv(pv), 5)
        _close(t.k, j.k, 0.0)
        _close(t.v, j.v, 0.0)
        assert (t.lengths == j.lengths).all()
        assert t.slot_kv_bytes(1) == j.slot_kv_bytes(1) == 5 * 2 * 2 * 2 * \
            4 * 4
        with pytest.raises(ValueError, match="exceeds max_seq_len"):
            t.write_prefill(0, _one_shard(np.zeros((2, 17, 2, 4), np.float32)),
                            _one_shard(np.zeros((2, 17, 2, 4), np.float32)),
                            3)

    def test_prefix_copies_match_jax(self):
        """The prefix cache's block copies: pool block -> slot rows
        (``copy_block_in``) and slot rows -> pool block
        (``copy_block_out``), the same bits as the JAX cache's."""
        r = np.random.RandomState(3)
        jpool = JBlockManager(2, 3, 4, 2, 4)
        tpool = BlockManager(2, 3, 4, 2, 4, device="cpu")
        blocks = r.randn(2, 3, 4, 2, 4).astype(np.float32)
        jpool.k, jpool.v = jnp.asarray(blocks), jnp.asarray(blocks + 1)
        tpool.k, tpool.v = _one_shard(blocks.copy()), _one_shard(blocks + 1)
        j, t = JSlot(**self.KW), SlotKVCache(**self.KW, device="cpu")
        pk = r.randn(2, 8, 2, 4).astype(np.float32)
        for c, pool, conv in ((j, jpool, jnp.asarray),
                              (t, tpool, _one_shard)):
            s = c.alloc()
            c.write_prefill(s, conv(pk), conv(pk - 1), 8)
            c.copy_block_in(s, 4, pool, 2)
            c.copy_block_out(s, 0, pool, 1)
        _close(t.k, j.k, 0.0)
        _close(t.v, j.v, 0.0)
        _close(tpool.k[0], jpool.k, 0.0)
        _close(tpool.v[0], jpool.v, 0.0)


# --------------------------------------------------- the decode program
@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(num_hidden_layers=2))
    p, tied = jdec.llama_decode_params(jm)
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(num_hidden_layers=2),
                                 device="cpu")
    tllama.load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()},
                              tied)
    return p, tm


CONSTS = dict(nh=4, nkv=2, hd=16, eps=1e-5, theta=10000.0, tied=False)


class TestDecodeSteps:
    @pytest.mark.parametrize("n_steps", [1, 3])
    def test_decode_steps_impl_matches_jax(self, models, n_steps):
        """Three slots at lengths 5, 12 and 1 over a 24-row cache, one of
        them sampled: tokens and keys equal, caches within 1e-5."""
        p, tm = models
        r = np.random.RandomState(7)
        ck = r.randn(2, 3, 24, 2, 16).astype(np.float32)
        cv = r.randn(2, 3, 24, 2, 16).astype(np.float32)
        tokens = np.array([17, 200, 3], np.int32)
        lens = np.array([5, 12, 1], np.int32)
        keys = r.randint(0, 2 ** 31, (3, 2)).astype(np.int64)
        temps = np.array([0.0, 0.9, 0.0], np.float32)
        topks = np.array([0, 5, 0], np.int32)
        jt, jk, jv, jkeys = jdec._decode_steps_impl(
            p, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(tokens),
            jnp.asarray(lens), jnp.asarray(keys, jnp.uint32),
            jnp.asarray(temps), jnp.asarray(topks), n_steps=n_steps,
            decode_attn="pallas", **CONSTS)
        tp, _ = tllama.llama_decode_params(tm)
        tk, tv = _t(ck), _t(cv)
        toks, ok, ov, tkeys = tdec._decode_steps_impl(
            [tp], tk, tv, tokens, lens, keys, temps, topks, n_steps=n_steps,
            **CONSTS)
        assert ok is tk and ov is tv                     # in place
        assert toks.tolist() == np.asarray(jt).tolist()
        assert (tkeys.numpy() == np.asarray(jkeys).astype(np.int64)).all()
        _close(tk, jk)
        _close(tv, jv)


# ---------------------------------------------------------- engine matrix
GEOMETRY = dict(num_slots=3, max_seq_len=128, prefill_chunk=16,
                headroom_mult=None, paged_attn=False)


@pytest.fixture(scope="module")
def engine_models():
    paddle.seed(21)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny())   # Pallas decode
    p, tied = jdec.llama_decode_params(jm)
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(), device="cpu")
    tllama.load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()},
                              tied)
    return jm, tm


def _matrix(eos):
    """The default engine's matrix without the mid-prefill cancel (dense
    prefill is one-shot): long and short cold prompts, seeded sampling,
    EOS inside a fused tick, a one-token cut, a cancel mid-decode."""
    return [m for m in engine_matrix(eos) if m[0] != "victim_prefill"]


def _drive(engine, Request, matrix):
    seqs = {name: engine.submit(Request(prompt=p, **kw))
            for name, p, kw in matrix}
    while engine.has_work():
        vr = seqs["victim_running"]
        if vr.status == "running" and len(vr.tokens) >= 3:
            engine.cancel(vr)
        engine.step()
    return {n: (list(map(int, s.tokens)), s.finish_reason)
            for n, s in seqs.items()}, engine


@pytest.fixture(scope="module")
def dense_runs(engine_models):
    jm, tm = engine_models
    eos, _ = _eos_inside_a_tick(tm)
    matrix = _matrix(eos)
    jax_out, _ = _drive(JEngine(jm, **GEOMETRY), JRequest, matrix)
    port_out, eng = _drive(ContinuousBatchingEngine(tm, **GEOMETRY),
                           GenerationRequest, matrix)
    return jax_out, port_out, eng, eos


class TestDenseEngineAgainstJax:
    def test_greedy_streams_identical(self, dense_runs):
        jax_out, port_out, *_ = dense_runs
        for name in ("long", "short", "eos", "one_token", "victim_running"):
            assert port_out[name][0] == jax_out[name][0], name

    def test_seeded_sampled_streams_equal(self, dense_runs):
        jax_out, port_out, *_ = dense_runs
        for name in ("sampled", "long_sampled"):
            assert port_out[name][0] == jax_out[name][0], name

    def test_finish_reasons_identical(self, dense_runs):
        jax_out, port_out, *_ = dense_runs
        assert {n: r for n, (_, r) in port_out.items()} \
            == {n: r for n, (_, r) in jax_out.items()}

    def test_one_shot_prefill_and_fused_ticks(self, dense_runs):
        """No chunking on the dense engine (the chunk knob is ignored),
        EOS inside a fused tick stops the stream, every slot comes back."""
        _, port_out, eng, eos = dense_runs
        assert eng.stats["prefill_chunks"] == 0
        assert eng.stats["prefills"] == 7
        toks, reason = port_out["eos"]
        assert reason == "stop" and toks[-1] == eos
        assert eng.stats["decode_steps"] > eng.stats["decode_calls"]
        assert eng.cache.num_free == 3 and isinstance(eng.cache, SlotKVCache)


def test_dense_streams_equal_the_paged_engine(engine_models, dense_runs):
    """The dense and the default paged engine serve the same streams."""
    _, tm = engine_models
    _, port_out, _, eos = dense_runs
    geo = dict(GEOMETRY, paged_attn=True, prefix_block_size=8)
    out, _ = _drive(ContinuousBatchingEngine(tm, **geo), GenerationRequest,
                    _matrix(eos))
    for name in port_out:
        if name != "victim_running":
            assert out[name] == port_out[name], name
