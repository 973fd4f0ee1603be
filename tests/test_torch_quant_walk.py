"""The quantized split-KV walk's arithmetic (``csrc/split_kv.cuh``
``narrow_walk``: paged decode, ragged's span-1 rows and the fused tick's
attention on int8 and fp8 pools), checked on the CPU against the JAX
reference.

The kernel has no CPU mode, so :func:`walk_emulation` repeats its
arithmetic in PyTorch: splits of :func:`split_len` keys (the plan is the
bf16 walk's), pages of ``narrow_page(D)`` keys, each of the block's four
warps owning a quarter of every page with its own running m, l and
accumulator, scores from the narrow values with the K scale after the dot
and 1/sqrt(D), ``l`` over the unscaled P, the V scale folded into P
(float32) before ``P V``; the warps combined at the end of the split by
exp(m_w - m) in warp order, then the splits' partials in split order. A
KV head with more than 512 / D query heads (G * D > 512) takes the page
walk's quantized mode instead: 32-key pages, one running m and l a
split, the same order of the scales. It
must sit within ``chip_smoke.py``'s ``TOL`` of the JAX
``paged_decode_attention_reference``
(``paddle_tpu/kernels/pallas_paged_decode.py:331``), the bound the smoke
and the on-card tests hold the kernel to.

Inputs come from a numpy seed: lengths 0, 1, 31, 32, 33, a page +- 1, a
split +- 1 and 4093 over a 4096-key table (block 32), scrambled blocks,
sentinel table tails and NaN in the stale rows of each row's last block;
G = 1 and 4 query heads a KV head at D = 64 and 128, and 8 at D = 128
(the page walk's side of the rule), bf16 and float32
queries, int8 pools (per-row planes) and fp8 pools (per-block planes
drawn from [0.5, 2)). A second check replays the kernel's transposing
butterfly sum lane by lane.
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
from paddle_tpu_torch.kernels import split_kv as skv
from paddle_tpu_torch.serving import kv_cache as tkv
from torch_threads import one_torch_thread  # noqa: F401

#: the JAX reference compiled whole (op by op it compiles each op anew):
#: the same function and values
jax_paged = jax.jit(jax_paged)
H100_SMS = 132
HKV, BS, MB = 2, 32, 128            # 4096 keys a table
NEG_INF = -1e30


def _lengths(D, B=10):
    sl = skv.split_len(B, HKV, MB * BS, H100_SMS)
    page = skv.narrow_page(D)
    lengths = [0, 1, 31, 32, 33, page - 1, page + 1, sl - 1, sl + 1, 4093]
    assert len(lengths) == B
    return np.array(lengths, np.int32)


def _inputs(G, D, mode, seed):
    """q [B, G*HKV, D] float32 and a quantized pool over scrambled blocks:
    ``(q, kd, vd, k_scale, v_scale, tables, lengths)``. The stale rows
    past each length in its last block hold NaN: the e4m3 NaN pattern
    (0x7F) in an fp8 pool, NaN scales in an int8 pool's per-row
    planes."""
    r = np.random.RandomState(seed)
    lengths = _lengths(D)
    need = [-(-int(n) // BS) for n in lengths]
    nb = sum(need) + 3
    perm = r.permutation(nb)
    tables = np.full((len(lengths), MB), nb, np.int32)     # unmapped
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    q = r.randn(len(lengths), G * HKV, D).astype(np.float32)
    pk = r.randn(nb, BS, HKV, D).astype(np.float32)
    pv = r.randn(nb, BS, HKV, D).astype(np.float32)
    stale = [(tables[b, n // BS], n % BS) for b, n in enumerate(lengths)
             if n % BS]
    for blk, row in stale:
        pk[blk, row:] = np.nan
        pv[blk, row:] = np.nan
    k, v = (torch.from_numpy(np.nan_to_num(x)) for x in (pk, pv))
    if mode == "int8":
        (kd, ks), (vd, vs) = tkv.quantize_kv_rows(k), tkv.quantize_kv_rows(v)
        for blk, row in stale:
            ks[blk, row:] = float("nan")
            vs[blk, row:] = float("nan")
    else:
        kd, vd = tkv.quantize_kv_rows_fp8(k), tkv.quantize_kv_rows_fp8(v)
        ks, vs = (torch.from_numpy(r.uniform(0.5, 2.0, (nb, HKV))
                                   .astype(np.float32)) for _ in range(2))
        for blk, row in stale:          # e4m3 NaN in the stale rows
            kd.view(torch.uint8)[blk, row:] = 0x7F
            vd.view(torch.uint8)[blk, row:] = 0x7F
    return q, kd, vd, ks, vs, tables, lengths


def _scale_rows(sc, phys, rows):
    """Each key's scale ``[n, Hkv]``: per-row planes at (block, row),
    per-block planes at the block."""
    return sc[phys, rows] if sc.dim() == 3 else sc[phys]


def _softmax_step(state, s, pv_rows, v_rows):
    """One online-softmax step of a warp's state ``(m, l, acc)`` over
    scores ``s`` [Hkv, G, n] (K scale applied): ``l`` over the unscaled
    P, then P times the V scales ``pv_rows`` [Hkv, n] into ``P V``."""
    m, l, acc = state
    m_new = torch.maximum(m, s.max(-1).values)
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = alpha * l + p.sum(-1)
    acc = acc * alpha[..., None] + (p * pv_rows[:, None]) @ v_rows
    return m_new, l, acc


def _combine(states):
    """States ``(m, l, acc)`` combined by exp(m_i - max m), in order."""
    m_max = torch.stack([m for m, _, _ in states]).max(0).values
    l = torch.zeros_like(states[0][1])
    acc = torch.zeros_like(states[0][2])
    for m, ls, a in states:
        w = torch.exp(m - m_max)
        acc, l = acc + w[..., None] * a, l + w * ls
    return m_max, l, acc


def walk_emulation(q, kd, vd, ks, vs, tables, lengths):
    """The quantized walk's arithmetic on torch tensors: ``q`` [B, H, D]
    of the query type, narrow pools with their planes; returns [B, H, D]
    of q's type."""
    B, H, D = q.shape
    nb, bs, Hkv, _ = kd.shape
    G = H // Hkv
    mb = tables.shape[1]
    sl = skv.split_len(B, Hkv, mb * bs, H100_SMS)
    narrow = G * D <= skv.NARROW_MAX_GD
    page = skv.narrow_page(D) if narrow else skv.PAGE
    kw = page // skv.WARPS if narrow else page
    warps = skv.WARPS if narrow else 1
    scale = 1.0 / math.sqrt(D)
    out = torch.zeros(B, H, D, dtype=q.dtype)
    for b in range(B):
        L = min(max(int(lengths[b]), 0), mb * bs)
        if L == 0:
            continue                                    # a row of zeros
        pos = torch.arange(L)
        phys = tables[b, pos // bs].long().clamp(0, nb - 1)
        k_raw = kd[phys, pos % bs].float().transpose(0, 1)   # [Hkv, L, D]
        v_raw = vd[phys, pos % bs].float().transpose(0, 1)
        k_sc = _scale_rows(ks, phys, pos % bs).T            # [Hkv, L]
        v_sc = _scale_rows(vs, phys, pos % bs).T
        qg = q[b].float().reshape(Hkv, G, D)
        splits = []
        for s0 in range(0, L, sl):
            s1 = min(L, s0 + sl)
            states = []
            for w in range(warps):
                state = (torch.full((Hkv, G), NEG_INF),
                         torch.zeros(Hkv, G), torch.zeros(Hkv, G, D))
                for p0 in range(s0, s1, page):
                    a = p0 + w * kw
                    e = min(s1, a + kw)
                    if a >= s1:
                        continue                   # the slice is past s1
                    s = (qg @ k_raw[:, a:e].transpose(1, 2)) * scale \
                        * k_sc[:, None, a:e]
                    state = _softmax_step(state, s, v_sc[:, a:e],
                                          v_raw[:, a:e])
                states.append(state)
            splits.append(_combine(states))
        _, l, acc = splits[0] if len(splits) == 1 else _combine(splits)
        out[b] = (acc / l.clamp(min=1e-30)[..., None]).reshape(H, D) \
            .to(q.dtype)
    return out


def _jnp(t):
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("G,D", [(1, 64), (4, 64), (1, 128), (4, 128),
                                 (8, 128)])
def test_walk_emulation_within_tol_of_jax_reference(G, D, dtype, mode):
    q, kd, vd, ks, vs, tables, lengths = _inputs(G, D, mode,
                                                 seed=G * 100 + D)
    jdt = getattr(jnp, dtype)
    want = jax_paged(jnp.asarray(q, jdt), _jnp(kd), _jnp(vd),
                     jnp.asarray(tables), jnp.asarray(lengths),
                     k_scale=_jnp(ks), v_scale=_jnp(vs))
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    got = walk_emulation(torch.from_numpy(q).to(getattr(torch, dtype)), kd,
                         vd, ks, vs, torch.from_numpy(tables),
                         torch.from_numpy(lengths)).float()
    assert torch.isfinite(got).all()
    assert (got[0] == 0).all()                          # length 0
    atol, rtol = TOL[dtype]
    assert ((got - want).abs() <= atol + rtol * want.abs()).all()


@pytest.mark.parametrize("D", [64, 128, 256])
def test_pages_and_slices(D):
    """A page holds a bf16 page's bytes of K (8 KB), the four warps' slices
    tile it, and a slice is a power of two of keys that the 32 lanes
    share evenly (the butterfly's precondition)."""
    page = skv.narrow_page(D)
    kw = page // skv.WARPS
    assert page * D == skv.NARROW_PAGE_BYTES == 2 * skv.PAGE * 128
    assert kw * skv.WARPS == page and 32 % kw == 0 and kw & (kw - 1) == 0
    assert D // 32 in (2, 4, 8)                         # a lane's word


def _transpose_sum(v):
    """The kernel's transpose_sum over 32 lanes, step by step: ``v``
    [32, N] partial sums; returns each lane's v[0] afterwards."""
    v = v.clone()
    n, o = v.shape[1], 16
    lane = torch.arange(32)
    while o > 0:
        partner = lane ^ o
        if n > 1:
            up = (lane & o) != 0
            lo, hi = v[:, :n // 2], v[:, n // 2:n]
            send = torch.where(up[:, None], lo, hi)
            keep = torch.where(up[:, None], hi, lo)
            v = keep + send[partner]
            n //= 2
        else:
            v = v + v[partner]
        o //= 2
    return v[:, 0]


@pytest.mark.parametrize("N", [8, 16, 32])
def test_transposing_butterfly_gives_each_lane_its_key(N):
    """After the butterfly, lane l holds key l // (32 / N) summed over
    all 32 lanes (float64 here: the order is the kernel's, the check is
    the mapping), and lanes that share a key hold the same value."""
    r = np.random.RandomState(N)
    v = torch.from_numpy(r.randn(32, N))
    got = _transpose_sum(v)
    want = v.sum(0)[torch.arange(32) // (32 // N)]
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    share = got.reshape(N, 32 // N)
    assert (share == share[:, :1]).all()
