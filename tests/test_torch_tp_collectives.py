"""The port's tensor-parallel reductions and shard placement against the
JAX package, on the CPU (the conftest's 8-device CPU mesh for JAX).

- the reductions: the port's list-of-partials forms against the
  reference's functions under ``jax.shard_map`` on seeded float32 ``[rows,
  hidden]`` partials at tp 2 and 4 — the ring (``_permute_allreduce``),
  the row-chunked overlap schedule (``_overlap_reduce``, fp and int8),
  the fp ``psum`` and the EQuARX ``quantized_psum_int8``; every shard's
  copy equal;
- the wire model ``collective_wire_bytes`` on the reference's cases;
- placement: ``place_tp_params``' shard dicts equal the reference's
  per-device shards (``addressable_shards``) bit for bit, dense and
  int8 weight-only;
- the per-shard pool planes (float32, int8 and fp8 with their scale
  planes) against the reference's pool shards after the same prefill.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.quantization import (collective_wire_bytes as
                                     j_wire_bytes)
from paddle_tpu.quantization import quantized_psum_int8 as j_qpsum
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving import decode as jdec
from paddle_tpu_torch.kernels import thread_launches
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           llama_decode_params,
                                           load_decode_params)
from paddle_tpu_torch.quantization import (collective_wire_bytes,
                                           quantized_psum_int8)
from paddle_tpu_torch.serving import ContinuousBatchingEngine
from paddle_tpu_torch.serving import GenerationRequest
from paddle_tpu_torch.serving import decode as tdec
from paddle_tpu_torch.serving import tp as ttp

from torch_threads import one_torch_thread  # noqa: F401

CPU = [torch.device("cpu")]


def _partials(tp, rows=6, hidden=64, seed=0):
    return np.random.RandomState(seed + tp).randn(
        tp, rows, hidden).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_reduce(kind, tp):
    """The reference reduction ``kind`` under shard_map over ``tp``
    devices: ``[tp, rows, hidden]`` partials in (shard s gets row s),
    every shard's result out, stacked."""
    def body(v):
        loc = v[0]
        if kind == "psum":
            out = jax.lax.psum(loc, "tp")
        elif kind == "int8":
            out = j_qpsum(loc, "tp", tp)
        elif kind == "ring":
            out = jdec._permute_allreduce(loc, tp)
        elif kind == "overlap_fp":
            out = jdec._tp_allreduce("fp", tp, overlap=True)(loc)
        else:                                   # overlap_int8
            out = jdec._tp_allreduce("int8", tp, overlap=True)(loc)
        return out[None]

    return jax.jit(jax.shard_map(body, mesh=jdec._tp_mesh(tp),
                                 in_specs=P("tp"), out_specs=P("tp"),
                                 check_vma=False))


def _port_reduce(kind, parts):
    devs = CPU * len(parts)
    if kind == "psum":
        fn = ttp.tp_allreduce("fp", devs)
    elif kind == "int8":
        return quantized_psum_int8(parts)
    elif kind == "ring":
        return ttp._permute_allreduce(parts, devs)
    elif kind == "overlap_fp":
        fn = ttp.tp_allreduce("fp", devs, overlap=True)
    else:
        fn = ttp.tp_allreduce("int8", devs, overlap=True)
    return fn(parts)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["psum", "ring", "overlap_fp", "int8",
                                  "overlap_int8"])
def test_reductions_match_the_reference(kind, tp):
    """Every shard's reduced copy equals the reference's. Bit for bit for
    the ring, the overlap schedules and the fp psum at tp=2 (one
    commutative add). The int8 all-reduce is held to 2 float32 ulps of
    the dequantized value: the port's quantizer gives the reference
    function's bits run op by op (``absmax / 127`` divided), but compiled
    by XLA the reference's division by the constant 127 becomes a
    multiply by its reciprocal (a scale one ulp off) and its
    dequantize-and-sum may fuse into fused multiply-adds; each costs at
    most one ulp of a dequantized element (seeded partials, no
    requantized integer sits at a rounding tie). The fp psum at tp=4 is
    XLA's all-reduce, whose association is its own: held to a few
    float32 ulps."""
    x = _partials(tp)
    want = np.asarray(_jax_reduce(kind, tp)(x))
    got = _port_reduce(kind, [torch.from_numpy(p.copy()) for p in x])
    got = np.stack([g.numpy() for g in got])
    assert got.shape == want.shape and got.dtype == want.dtype
    for s in range(1, tp):                 # every shard holds the same
        assert np.array_equal(got[s], got[0])
    if kind in ("ring", "overlap_fp") or (kind == "psum" and tp == 2):
        assert np.array_equal(got, want)
    elif kind == "psum":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=4 * np.spacing(np.abs(want).max()))
    else:
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert np.all(np.abs(got - want) <= 2 * ulp)


def test_int8_reduction_is_exact_on_a_representable_payload():
    """The reference's lossless payload (integers with amax 127 in every
    row and chunk on one shard, zeros on the other) survives both wire
    phases bit for bit: the dequantization arithmetic itself."""
    rng = np.random.RandomState(1)
    x = np.zeros((2, 4, 64), np.float32)
    x[0] = rng.randint(-127, 128, (4, 64)).astype(np.float32)
    x[0, :, 0] = 127.0
    x[0, :, 32] = 127.0
    got = quantized_psum_int8([torch.from_numpy(p.copy()) for p in x])
    for g in got:
        assert np.array_equal(g.numpy(), x.sum(0))
    zero = quantized_psum_int8([torch.zeros(4, 64)] * 2)
    assert all(bool((z == 0).all()) for z in zero)


def test_reductions_count_their_wire():
    """Each reduction adds one ``tp_reduce``, its wire operations and the
    wire model's bytes to the thread's launch tally, once a site (chunks
    included)."""
    parts = [torch.randn(5, 64) for _ in range(4)]
    for dtype, overlap, ops in [("fp", False, 1), ("int8", False, 4),
                                ("fp", True, 2 * 2 * 3),
                                ("int8", True, 2 * 4)]:
        before = thread_launches()
        ttp.tp_allreduce(dtype, CPU * 4, overlap=overlap)(parts)
        after = thread_launches()
        assert after["tp_reduce"] - before["tp_reduce"] == 1
        assert after["tp_wire_ops"] - before["tp_wire_ops"] == ops
        assert after["tp_wire_bytes"] - before["tp_wire_bytes"] == \
            collective_wire_bytes(5, 64, 4, dtype)


@pytest.mark.parametrize("case", [
    (10, 64, 1, "fp", 4), (6, 64, 2, "fp", 4), (6, 64, 2, "int8", 4),
    (8, 64, 2, "fp", 4), (8, 64, 2, "int8", 4), (7, 4096, 4, "fp", 2),
    (7, 4096, 4, "int8", 2), (1, 4096, 8, "int8", 4)])
def test_wire_model_matches_the_reference(case):
    rows, hidden, tp, dtype, isz = case
    assert collective_wire_bytes(rows, hidden, tp, dtype, isz) == \
        j_wire_bytes(rows, hidden, tp, dtype, isz)
    if (rows, hidden, tp) == (8, 64, 2) and dtype == "fp":
        # the reference's >= 3x pin of the int8 wire format
        assert (collective_wire_bytes(8, 64, 2, "fp")
                / collective_wire_bytes(8, 64, 2, "int8")) > 3.0


# ---------------------------------------------------------------- placement
@pytest.fixture(scope="module")
def models():
    paddle.seed(33)
    jm = JLlama(j_tiny(decode_attention="jnp"))
    p, tied = jdec.llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu", seed=0)
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm, p, tied


def _jax_shards(arr):
    """An array's per-device shards in device order, as numpy."""
    shards = sorted(arr.addressable_shards, key=lambda sh: sh.device.id)
    return [np.asarray(sh.data) for sh in shards]


@pytest.mark.parametrize("wq8", [False, True], ids=["dense", "wq8"])
def test_placed_shards_equal_the_reference(models, wq8):
    _, tm, jp, tied = models
    tp = 2
    tpar, ttied = llama_decode_params(tm)
    if wq8:
        jp = jdec.quantize_decode_params(jp, tied)
        tpar = tdec.quantize_decode_params(tpar, ttied)
    placed = jdec.place_tp_params(jp, tp, wq8)
    ours = ttp.place_tp_params(tpar, CPU * tp)
    assert len(ours) == tp
    for key, val in placed.items():
        leaves = val if isinstance(val, tuple) else (val,)
        for i, leaf in enumerate(leaves):
            want = _jax_shards(leaf)
            for s in range(tp):
                got = ours[s][key]
                got = got[i] if isinstance(got, tuple) else got
                assert np.array_equal(got.detach().numpy(), want[s]), \
                    (key, i, s)


# --------------------------------------------------------- pool partition
GEO = dict(num_slots=2, max_seq_len=64, decode_chunk=1, prefix_block_size=8,
           prefill_chunk=16, headroom_mult=None)


def _one_step(engine, Request):
    """Admit one 13-token prompt (a cold prefill into two blocks) and run
    the step's decode tick, leaving the sequence live."""
    prompt = np.random.RandomState(5).randint(0, 256, (13,)).astype(np.int32)
    engine.submit(Request(prompt=prompt, max_new_tokens=4))
    engine.step()


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
def test_pool_shards_equal_the_reference(models, kv):
    """After the same cold prefill and decode tick (14 rows, two blocks)
    the port's
    per-shard planes hold the reference's pool shards: the same shapes
    and storage types a shard ([L, nb, bs, Hkv/tp, D], int8's per-row
    scale planes split on axis 3, fp8's per-block planes on axis 2), the
    K/V values within float32 rounding of the reference's (float32 pool),
    or within one quantization step (int8: its scales within 1e-5; fp8:
    one e4m3 step, its planes exactly the constant 1.0)."""
    jm, tm, _, _ = models
    jeng = JEngine(jm, tp=2, kv_dtype=kv, jit_cache={}, **GEO)
    _one_step(jeng, JRequest)
    teng = ContinuousBatchingEngine(tm, tp=2, kv_dtype=kv, **GEO)
    _one_step(teng, GenerationRequest)
    jpool, tpool = jeng.cache.pool, teng.cache.pool
    assert tpool.tp == 2
    used = sorted(set(range(tpool.num_blocks)) - set(tpool._free_set))
    assert used == sorted(set(range(jpool.num_blocks))
                          - set(jpool._free_set))
    assert len(used) == 2
    planes = [("k", "k"), ("v", "v")]
    if kv:
        planes += [("k_scale", "k_scale"), ("v_scale", "v_scale")]
    for jname, tname in planes:
        want = _jax_shards(getattr(jpool, jname))
        got = [t.view(torch.uint8).numpy().view(want[0].dtype)
               if t.dtype == torch.float8_e4m3fn else t.numpy()
               for t in getattr(tpool, tname)]
        for s in range(2):
            assert got[s].shape == want[s].shape, (tname, s)
            g = got[s][:, used].astype(np.float32)
            w = want[s][:, used].astype(np.float32)
            if tname.endswith("scale"):
                if kv == "fp8":
                    assert np.all(g == 1.0) and np.all(w == 1.0)
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
            elif kv == "int8":
                assert np.abs(g - w).max() <= 1.0
            elif kv == "fp8":
                # one e4m3 step: 3 mantissa bits
                np.testing.assert_allclose(g, w, rtol=2 ** -3, atol=2 ** -9)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
