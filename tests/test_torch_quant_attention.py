"""The quantized modes of the port's paged decode and ragged attention, on
the CPU, against the JAX references given ``k_scale``/``v_scale``.

- The plain versions on int8 pools (per-row-per-head scale planes) and
  fp8 pools (per-block planes, here not all 1.0, so the planes' path is
  exercised) agree with ``paged_decode_attention_reference`` and
  ``ragged_attention_reference`` to 1e-5 (float32). The ragged check
  holds decode rows, a chunk that starts mid-block and a dead row.
- The kernels' quantized arithmetic has no CPU mode, so
  ``walk_emulation`` (``tests/test_torch_quant_walk.py``),
  ``_qchunk_emulation`` and ``_qchunk_wgmma_emulation`` repeat it in
  PyTorch: the quantized split-KV walk (paged decode, ragged's span-1
  rows, the fused tick's attention), the
  float32 CUDA-core chunk tile (32-key tiles, P kept float32) and the
  bf16 ``wgmma`` chunk tile (64-key tiles; the narrow tile converted
  exactly to bf16, P rounded to bf16 per tile after the V scale is
  folded in), each in the kernels' order — scores from the narrow values,
  the K scale after the dot, the softmax sum ``l`` over the unscaled P,
  then the V scale folded into P before ``P V``. Each sits within
  ``chip_smoke.py``'s ``TOL`` of the JAX reference in the types that take
  it.
- An all-zero int8 row (scale 0) reads back as exact zeros.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL
from paddle_tpu.kernels.pallas_paged_decode import \
    paged_decode_attention_reference as jax_paged
from paddle_tpu.kernels.pallas_ragged_attention import \
    ragged_attention_reference as jax_ragged
from paddle_tpu_torch.kernels import paged_decode as tpd
from paddle_tpu_torch.kernels import ragged_attention as tra
from paddle_tpu_torch.serving import kv_cache as tkv
from test_torch_paged_split import H100_SMS
from test_torch_paged_split import _inputs as _paged_inputs
from test_torch_quant_walk import walk_emulation
from test_torch_ragged_tc import _inputs as _ragged_inputs
from torch_threads import one_torch_thread  # noqa: F401

NEG_INF = -1e30
#: the JAX references compiled whole, once a shape (run op by op they
#: compile every op anew for each shape): the same functions and values
jax_paged = jax.jit(jax_paged)
jax_ragged = jax.jit(jax_ragged)


def _quantize(pk, pv, mode, seed):
    """Float pools → ``(kd, vd, k_scale, v_scale)`` torch tensors: int8 by
    the pool's write rule (per row and head), or e4m3 by its cast with
    per-block planes drawn from [0.5, 2)."""
    pk = np.nan_to_num(pk)
    pv = np.nan_to_num(pv)
    if mode == "int8":
        kd, ks = tkv.quantize_kv_rows(torch.from_numpy(pk))
        vd, vs = tkv.quantize_kv_rows(torch.from_numpy(pv))
        kd[0, 1] = 0            # an all-zero row: scale 0, exact zeros
        ks[0, 1] = 0
        return kd, vd, ks, vs
    r = np.random.RandomState(seed)
    nb, _, hkv, _ = pk.shape
    kd = tkv.quantize_kv_rows_fp8(torch.from_numpy(pk))
    vd = tkv.quantize_kv_rows_fp8(torch.from_numpy(pv))
    ks = torch.from_numpy(r.uniform(0.5, 2.0, (nb, hkv)).astype(np.float32))
    vs = torch.from_numpy(r.uniform(0.5, 2.0, (nb, hkv)).astype(np.float32))
    return kd, vd, ks, vs


def _scale_rows(sc, phys, rows):
    """Each key's scale ``[n, Hkv]``: per-row planes at (block, row),
    per-block planes at the block."""
    return sc[phys, rows] if sc.dim() == 3 else sc[phys]


def _jnp(t):
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


def _qchunk_emulation(q, kd, vd, ks, vs, tbl, qlen, kvlen):
    """One chunk span on the quantized CUDA-core tile: 32-key tiles from
    key 0, the same order as the walk per tile, rows masked past their
    position."""
    nb, bs, Hkv, D = kd.shape
    H = q.shape[1]
    G = H // Hkv
    kv_valid = min(max(kvlen, 0), tbl.shape[0] * bs)
    pos = kvlen - qlen + torch.arange(qlen)
    kv_stop = min(kv_valid, max(int(pos[-1]) + 1, 0))
    keys = torch.arange(kv_stop)
    phys = tbl[keys // bs].long().clamp(0, nb - 1)
    k_raw, v_raw = kd[phys, keys % bs].float(), vd[phys, keys % bs].float()
    k_sc = _scale_rows(ks, phys, keys % bs)
    v_sc = _scale_rows(vs, phys, keys % bs)
    out = torch.zeros(qlen, H, D, dtype=q.dtype)
    for h in range(H):
        c = h // G
        qh = q[:, h].float()
        m, l = torch.full((qlen,), NEG_INF), torch.zeros(qlen)
        acc = torch.zeros(qlen, D)
        for k0 in range(0, kv_stop, 32):
            k1 = min(kv_stop, k0 + 32)
            s = (qh @ k_raw[k0:k1, c].T) / math.sqrt(D) * k_sc[k0:k1, c]
            mask = keys[None, k0:k1] <= pos[:, None]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.max(1).values)
            p = torch.where(mask, torch.exp(s - m_new[:, None]),
                            torch.zeros_like(s))
            alpha = torch.exp(m - m_new)
            l, m = alpha * l + p.sum(1), m_new
            acc = acc * alpha[:, None] \
                + (p * v_sc[k0:k1, c]) @ v_raw[k0:k1, c]
        out[:, h] = (acc / l.clamp(min=1e-30)[:, None]).to(q.dtype)
    return out


def _bf(x):
    return x.to(torch.bfloat16).float()


def _qchunk_wgmma_emulation(q, kd, vd, ks, vs, tbl, qlen, kvlen):
    """One bf16 chunk span on the quantized ``wgmma`` tile: 64-key tiles
    from key 0; each narrow K/V tile converted to bf16 exactly (no scale
    in it); S in float32 times 1/sqrt(D), then times the key's K scale;
    keys masked past each row's position and past kvlen; an online
    softmax whose ``l`` sums the unscaled P; then P times the key's V
    scale, rounded to bf16 per tile, into ``P V``; out = acc / max(l,
    1e-30) rounded once."""
    nb, bs, Hkv, D = kd.shape
    H = q.shape[1]
    G = H // Hkv
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    kv_valid = min(max(kvlen, 0), tbl.shape[0] * bs)
    pos = kvlen - qlen + torch.arange(qlen)
    kv_stop = min(kv_valid, max(int(pos[-1]) + 1, 0))
    keys = torch.arange(kv_stop)
    phys = tbl[keys // bs].long().clamp(0, nb - 1)
    k_raw = _bf(kd[phys, keys % bs].float())
    v_raw = _bf(vd[phys, keys % bs].float())
    assert torch.equal(k_raw, kd[phys, keys % bs].float())   # exact
    k_sc = _scale_rows(ks, phys, keys % bs)
    v_sc = _scale_rows(vs, phys, keys % bs)
    out = torch.zeros(qlen, H, D, dtype=q.dtype)
    for h in range(H):
        c = h // G
        qh = q[:, h].float()
        m, l = torch.full((qlen,), NEG_INF), torch.zeros(qlen)
        acc = torch.zeros(qlen, D)
        for k0 in range(0, kv_stop, 64):
            k1 = min(kv_stop, k0 + 64)
            s = (qh @ k_raw[k0:k1, c].T) * scale * k_sc[k0:k1, c]
            mask = keys[None, k0:k1] <= pos[:, None]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.max(1).values)
            p = torch.where(mask, torch.exp(s - m_new[:, None]),
                            torch.zeros_like(s))
            alpha = torch.exp(m - m_new)
            l, m = alpha * l + p.sum(1), m_new
            acc = acc * alpha[:, None] \
                + _bf(p * v_sc[k0:k1, c]) @ v_raw[k0:k1, c]
        out[:, h] = (acc / l.clamp(min=1e-30)[:, None]).to(q.dtype)
    return out


#: the chunk tile each query type takes, on any pool
CHUNK_EMULATION = {"bfloat16": _qchunk_wgmma_emulation,
                   "float32": _qchunk_emulation}


def _within(got, want, dtype):
    atol, rtol = TOL[dtype]
    assert torch.isfinite(got).all()
    assert ((got.float() - want).abs() <= atol + rtol * want.abs()).all()


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("G", [1, 4])
def test_paged_plain_version_matches_jax(mode, G):
    q, pk, pv, tables, lengths = _paged_inputs(G, 64, seed=G + 3)
    kd, vd, ks, vs = _quantize(pk, pv, mode, seed=G)
    want = jax_paged(jnp.asarray(q), _jnp(kd), _jnp(vd), jnp.asarray(tables),
                     jnp.asarray(lengths), k_scale=_jnp(ks), v_scale=_jnp(vs))
    got = tpd.paged_decode_attention(
        torch.from_numpy(q), kd, vd, torch.from_numpy(tables),
        torch.from_numpy(lengths), k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 128])
def test_quantized_walk_emulation_within_tol(mode, dtype, D):
    q, pk, pv, tables, lengths = _paged_inputs(4, D, seed=D)
    kd, vd, ks, vs = _quantize(pk, pv, mode, seed=D)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    want = jax_paged(jnp.asarray(q, jdt), _jnp(kd), _jnp(vd),
                     jnp.asarray(tables), jnp.asarray(lengths),
                     k_scale=_jnp(ks), v_scale=_jnp(vs))
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    got = walk_emulation(torch.from_numpy(q).to(tdt), kd, vd, ks, vs,
                            torch.from_numpy(tables),
                            torch.from_numpy(lengths))
    assert (got[0] == 0).all()                      # length 0
    _within(got, want, dtype)


def _ragged_q(G, D, mode, seed):
    q, pk, pv, tables, qstart, qlen, kvlen = _ragged_inputs(G, D, seed)
    kd, vd, ks, vs = _quantize(pk, pv, mode, seed)
    return q, kd, vd, ks, vs, tables, qstart, qlen, kvlen


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_ragged_plain_version_matches_jax(mode):
    """Decode rows, chunks from position 0 and from mid-block (a 500-token
    chunk at 37), a dead row."""
    q, kd, vd, ks, vs, tables, qstart, qlen, kvlen = _ragged_q(2, 64, mode,
                                                               seed=9)
    assert 0 in qlen and (kvlen - qlen)[-1] % 16
    got = tra.ragged_paged_attention(
        torch.from_numpy(q), kd, vd, *(torch.from_numpy(x) for x in
                                       (tables, qstart, qlen, kvlen)),
        k_scale=ks, v_scale=vs)
    for r in range(len(qlen)):
        n, a = int(qlen[r]), int(qstart[r])
        if n == 0:
            continue
        want = jax_ragged(jnp.asarray(q[a:a + n]), _jnp(kd), _jnp(vd),
                          jnp.asarray(tables[r:r + 1]),
                          jnp.zeros(1, jnp.int32), jnp.asarray([n]),
                          jnp.asarray(kvlen[r:r + 1]), k_scale=_jnp(ks),
                          v_scale=_jnp(vs))
        np.testing.assert_allclose(got[a:a + n].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert (got[int(qlen.sum()):] == 0).all()


def _ragged_quantized_within_tol(mode, dtype, G, D, seed):
    """Both grids on a quantized pool: span-1 rows on the quantized walk
    (ragged's split rule over all R rows), chunks on the tile of the query
    type (``CHUNK_EMULATION``), each piece of at most 64 span rows within
    TOL of the JAX reference; the dead row is skipped."""
    q, kd, vd, ks, vs, tables, qstart, qlen, kvlen = _ragged_q(G, D, mode,
                                                               seed=seed)
    assert 0 in qlen and (kvlen - qlen)[-1] % 16     # a dead row, mid-block
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    qt = torch.from_numpy(q).to(tdt)
    tb = torch.from_numpy(tables)
    paths = tra.paths(qlen)
    one = torch.tensor([p == "split" for p in paths])
    walked = walk_emulation(qt[torch.from_numpy(qstart).long()], kd, vd,
                               ks, vs, tb,
                               torch.where(one, torch.from_numpy(kvlen), 0))
    for r, path in enumerate(paths):
        n, a, k = int(qlen[r]), int(qstart[r]), int(kvlen[r])
        if path == "dead":
            continue
        got = walked[r:r + 1] if path == "split" else CHUNK_EMULATION[
            dtype](qt[a:a + n], kd, vd, ks, vs, tb[r], n, k)
        for c0 in range(0, n, 64):
            c1 = min(n, c0 + 64)
            want = jax_ragged(jnp.asarray(q[a + c0:a + c1], jdt), _jnp(kd),
                              _jnp(vd), jnp.asarray(tables[r:r + 1]),
                              jnp.zeros(1, jnp.int32),
                              jnp.asarray([c1 - c0]),
                              jnp.asarray([k - n + c1]), k_scale=_jnp(ks),
                              v_scale=_jnp(vs))
            want = torch.from_numpy(np.array(jnp.asarray(want,
                                                           jnp.float32)))
            _within(got[c0:c1], want, dtype)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ragged_quantized_emulation_within_tol(mode, dtype):
    """bf16 chunks on the wgmma tile, float32 chunks on the CUDA-core
    tile (D 128, 4 query heads a KV head)."""
    _ragged_quantized_within_tol(mode, dtype, 4, 128, seed=3)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("D, G", [(64, 1), (64, 4)])
def test_ragged_quantized_wgmma_emulation_within_tol(mode, D, G):
    """The bf16 wgmma tile on int8 and fp8 pools (fp8 planes not all 1.0)
    at D 64, MHA and GQA (D 128 with 4 query heads a KV head is the
    bfloat16 case above): decode rows, chunks of 2 to 500 rows (one
    starting mid-block), a dead row."""
    _ragged_quantized_within_tol(mode, "bfloat16", G, D, seed=D + G)


def test_grid_of_a_quantized_pool_takes_the_cuda_core_tile():
    """A quantized pool's chunks take the tile of the query type, as a
    bf16 or float32 pool's do: the CUDA-core tile (16 rows) in float32 and
    the wgmma tile (64 rows) in bf16."""
    g = tra.grid(520, 8, 32, 32, 4096, torch.float32, H100_SMS)
    assert g["tile_rows"] == 16 and g["tile_blocks"] == 33 * 8 * 32
    g = tra.grid(520, 8, 32, 32, 4096, torch.bfloat16, H100_SMS)
    assert g["tile_rows"] == 64 and g["tile_blocks"] == 9 * 8 * 32


def test_scale_mode_checks_the_planes():
    kd = torch.zeros(4, 8, 2, 16, dtype=torch.int8)
    ks = torch.zeros(4, 8, 2)
    assert tpd.scale_mode(kd, ks, ks) == 1
    f8 = torch.zeros(4, 8, 2, 16, dtype=torch.float8_e4m3fn)
    assert tpd.scale_mode(f8, torch.ones(4, 2), torch.ones(4, 2)) == 2
    assert tpd.scale_mode(torch.zeros(4, 8, 2, 16), None, None) == 0
    with pytest.raises(ValueError, match="needs its scale planes"):
        tpd.scale_mode(kd, None, None)
    with pytest.raises(ValueError, match="contiguous float32"):
        tpd.scale_mode(f8, ks, ks)
    with pytest.raises(TypeError, match="int8 or float8"):
        tpd.scale_mode(torch.zeros(4, 8, 2, 16), ks, ks)
