"""The redesigned ragged paged attention kernels' arithmetic, checked on
the CPU against the JAX reference.

``csrc/ragged_attention.cu`` serves one call with two grids: span-1 rows
take the split-KV walk of ``csrc/split_kv.cuh`` (split rule over the
call's ``R`` rows and the tables' capacity), chunk spans take a tile grid
— in bf16 the ``wgmma`` tile, whose P is rounded to bf16 per 64-key tile
against the running max, in float32 the CUDA-core tile routine (32-key
tiles). A chunk's causal offset ``kvlen - qlen`` is arbitrary. The kernels
have no CPU mode, so ``_ragged_emulation`` below repeats that arithmetic
in PyTorch; it must sit within ``chip_smoke.py``'s ``TOL`` of the JAX
``ragged_attention_reference``
(``paddle_tpu/kernels/pallas_ragged_attention.py:380``), the bound the
smoke and the on-card tests hold the kernels to. Inputs come from a numpy
seed: spans 0, 1, 2, 63, 64, 65 and a 500-token chunk starting
mid-block, scrambled blocks, sentinel table tails and NaN in the stale
rows of each sequence's last block; G = 1 and 4 query heads a KV head,
D = 64 and 128, bf16 and fp32.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import TOL
from paddle_tpu.kernels.pallas_ragged_attention import \
    ragged_attention_reference as jax_ragged_reference
from paddle_tpu_torch.kernels import LAUNCHES, reset_launches
from paddle_tpu_torch.kernels import ragged_attention as tra
from test_torch_paged_split import H100_SMS, _split_emulation

HKV, BS = 2, 16
NEG_INF = -1e30
# (qlen, kvlen): a dead row, decode rows of 1 and of 517 keys, chunks of
# 2, 63, 64 and 65 (some from position 0, some mid-block) and a 500-token
# chunk starting at 37, mid-block, whose last key tile is partial
SPANS = [(0, 0), (1, 1), (2, 35), (63, 63), (64, 200), (1, 517),
         (65, 100), (500, 537)]
MB = 36                                  # 576 keys a table


def _inputs(G, D, seed):
    r = np.random.RandomState(seed)
    qlen = np.array([s[0] for s in SPANS], np.int32)
    kvlen = np.array([s[1] for s in SPANS], np.int32)
    qstart = np.concatenate([[0], np.cumsum(qlen)[:-1]]).astype(np.int32)
    need = [-(-int(k) // BS) for k in kvlen]
    nb = sum(need) + 2
    perm = r.permutation(nb)
    tables = np.full((len(SPANS), MB), nb, np.int32)     # sentinel tails
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    q = r.randn(int(qlen.sum()) + 5, G * HKV, D).astype(np.float32)
    pk = r.randn(nb, BS, HKV, D).astype(np.float32)
    pv = r.randn(nb, BS, HKV, D).astype(np.float32)
    for i, k in enumerate(kvlen):
        if k % BS:
            pk[tables[i, k // BS], k % BS:] = np.nan
            pv[tables[i, k // BS], k % BS:] = np.nan
    return q, pk, pv, tables, qstart, qlen, kvlen


def _chunk_emulation(q, pool_k, pool_v, tbl, qlen, kvlen, tile):
    """One chunk span as the tile kernels compute it: ``tile``-key tiles
    from key 0, scores in fp32, keys masked past each row's position and
    past kvlen, an online softmax, P rounded to the input type against
    the running max, out = acc / max(l, 1e-30) rounded once."""
    nb, bs, Hkv, D = pool_k.shape
    H = q.shape[1]
    G = H // Hkv
    dt = q.dtype
    kv_valid = min(max(kvlen, 0), tbl.shape[0] * bs)
    pos = kvlen - qlen + torch.arange(qlen)
    kv_stop = min(kv_valid, max(int(pos[-1]) + 1, 0))
    keys = torch.arange(kv_stop)
    phys = tbl[keys // bs].long().clamp(0, nb - 1)
    k_rows = pool_k[phys, keys % bs].float()            # [kv_stop, Hkv, D]
    v_rows = pool_v[phys, keys % bs].float()
    out = torch.zeros(qlen, H, D, dtype=dt)
    for h in range(H):
        qh = q[:, h].float()
        m = torch.full((qlen,), NEG_INF)
        l = torch.zeros(qlen)
        acc = torch.zeros(qlen, D)
        for k0 in range(0, kv_stop, tile):
            k1 = min(kv_stop, k0 + tile)
            s = qh @ k_rows[k0:k1, h // G].T / math.sqrt(D)
            mask = keys[None, k0:k1] <= pos[:, None]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.max(1).values)
            p = torch.where(mask, torch.exp(s - m_new[:, None]),
                            torch.zeros_like(s))
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(1)
            m = m_new
            acc = acc * alpha[:, None] + p.to(dt).float() @ v_rows[k0:k1,
                                                                   h // G]
        out[:, h] = (acc / l.clamp(min=1e-30)[:, None]).to(dt)
    return out


def _ragged_emulation(q, pool_k, pool_v, tables, qstart, qlen, kvlen):
    """Both grids of one call: span-1 rows through the split-KV walk under
    the ragged split rule (``R`` rows), chunk spans through the tile of
    their input type; rows outside every span zero."""
    T = q.shape[0]
    R = tables.shape[0]
    tile = 64 if q.dtype == torch.bfloat16 else 32
    out = torch.zeros_like(q)
    paths = tra.paths(qlen)
    one = torch.tensor([p == "split" for p in paths])
    # the walk over all R rows (the split rule counts them); rows that
    # are not span-1 get length 0 and are not kept
    rows_q = q[qstart.long().clamp(0, T - 1)]
    walked = _split_emulation(rows_q, pool_k, pool_v, tables,
                              torch.where(one, kvlen, 0))
    for r in range(R):
        a, n = int(qstart[r]), int(qlen[r])
        if paths[r] == "split":
            out[a] = walked[r]
        elif paths[r] == "tile":
            out[a:a + n] = _chunk_emulation(q[a:a + n], pool_k, pool_v,
                                            tables[r], n, int(kvlen[r]),
                                            tile)
    return out


def _jax_reference(q, pk, pv, tables, qstart, qlen, kvlen, jdt, piece=64):
    """The JAX reference, one sequence and at most ``piece`` span rows at
    a time (it gathers a [tokens, keys, heads, D] cache): rows a..b of a
    span of n tokens over kvlen k are the span of b - a tokens over
    k - n + b, at the same positions."""
    out = np.zeros(q.shape, np.float32)
    for r in range(len(qlen)):
        n, k, s = int(qlen[r]), int(kvlen[r]), int(qstart[r])
        for a in range(0, n, piece):
            b = min(n, a + piece)
            got = jax_ragged_reference(
                jnp.asarray(q[s + a:s + b], jdt), jnp.asarray(pk, jdt),
                jnp.asarray(pv, jdt), jnp.asarray(tables[r:r + 1]),
                jnp.zeros(1, jnp.int32), jnp.asarray([b - a], jnp.int32),
                jnp.asarray([k - n + b], jnp.int32))
            out[s + a:s + b] = np.asarray(jnp.asarray(got, jnp.float32))
    return torch.from_numpy(out)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
def test_emulation_within_tol_of_jax_reference(G, D, dtype):
    q, pk, pv, tables, qstart, qlen, kvlen = _inputs(G, D, seed=G * 10 + D)
    tdt = getattr(torch, dtype)
    got = _ragged_emulation(*(torch.from_numpy(x).to(tdt)
                              for x in (q, pk, pv)),
                            *(torch.from_numpy(x)
                              for x in (tables, qstart, qlen,
                                        kvlen))).float()
    want = _jax_reference(q, pk, pv, tables, qstart, qlen, kvlen,
                          getattr(jnp, dtype))
    assert torch.isfinite(got).all()
    assert (got[int(qlen.sum()):] == 0).all()      # outside every span
    atol, rtol = TOL[dtype]
    assert ((got - want).abs() <= atol + rtol * want.abs()).all()


def test_paths_and_grids_at_the_smoke_spans():
    """The smoke's packed tick-0 buffer (T = 8 + 512, 7B heads, 4096-key
    tables): six decode rows walk 5 splits of 832 keys at most, the
    500-token chunk takes 8 of the 9 64-row tiles (32 of 33 16-row tiles
    in float32), the dead row neither."""
    qlen = [1, 1, 1, 1, 1, 500, 1, 0]
    kvlen = [1, 31, 33, 700, 1601, 1517, 4093, 0]
    assert tra.paths(qlen) == ["split"] * 5 + ["tile", "split", "dead"]
    g = tra.grid(chip_smoke.T_PACKED, 8, 32, 32, 4096, torch.bfloat16,
                 H100_SMS)
    assert g == {"split_len": 832, "n_split": 5, "split_blocks": 1280,
                 "tile_rows": 64, "tile_blocks": 9 * 8 * 32}
    assert chip_smoke.ragged_working_blocks(qlen, kvlen, g) == {
        "split_blocks": 32 * (1 + 1 + 1 + 1 + 2 + 5),
        "tile_blocks": 32 * 8}
    g32 = tra.grid(chip_smoke.T_PACKED, 8, 32, 32, 4096, torch.float32,
                   H100_SMS)
    assert g32["tile_rows"] == 16 and g32["tile_blocks"] == 33 * 8 * 32
    assert chip_smoke.ragged_working_blocks(qlen, kvlen, g32)[
        "tile_blocks"] == 32 * 32


def test_paths_of_the_edge_spans():
    """Spans of 2, 63, 64 and 65 take the tile grid; spans of 1 the walk."""
    for spans in chip_smoke.RAGGED_EDGE.values():
        for (n, _), path in zip(spans, tra.paths([n for n, _ in spans])):
            assert path == ("split" if n == 1 else "tile" if n else "dead")


def test_limits():
    tra.check_limits(32, 32, 128)
    tra.check_limits(8, 2, 64)
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        tra.check_limits(8, 2, 256)
    with pytest.raises(NotImplementedError, match="accumulator"):
        tra.check_limits(64, 2, 128)
    with pytest.raises(ValueError):
        tra.check_limits(6, 4, 64)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = [torch.from_numpy(x) for x in _inputs(4, 64, seed=5)]
    reset_launches()
    got = tra.ragged_paged_attention(*args)
    assert LAUNCHES["ragged_attention"] == 0
    assert torch.equal(got, tra.ragged_attention_reference(*args))
