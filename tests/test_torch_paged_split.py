"""The split-KV paged decode kernel's arithmetic, checked on the CPU against
the JAX reference.

``csrc/paged_decode.cu`` cuts each row's keys into splits of
:func:`paddle_tpu_torch.kernels.paged_decode.split_len` keys and walks a
split in 32-key pages with an online softmax: P is rounded to the input
type per page against the split's running max, each split keeps fp32
partials (m, l, unnormalised acc), and the last block combines them in
split order. ``_split_emulation`` below repeats that arithmetic in
PyTorch (the kernel has no CPU mode); it must sit within
``chip_smoke.py``'s ``TOL`` of the JAX
``paged_decode_attention_reference``
(``paddle_tpu/kernels/pallas_paged_decode.py:331``) — the bound the smoke
and the on-card tests hold the kernel to. Inputs come from a numpy seed:
lengths 0, 1, 31, 32, 33, a split +- 1 and 4093 over a 4096-key table
(block 32), scrambled blocks, sentinel table tails and NaN in the stale
rows of each row's last block; G = 1 and 4 query heads a KV head, D = 64
and 128, bf16 and fp32.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL
from paddle_tpu.kernels.pallas_paged_decode import \
    paged_decode_attention_reference as jax_paged_reference
from paddle_tpu_torch.kernels import paged_decode as tpd
from torch_threads import one_torch_thread  # noqa: F401


H100_SMS = 132
HKV, BS, MB = 2, 32, 128            # 4096 keys a table
NEG_INF = -1e30


def _lengths(B=8):
    sl = tpd.split_len(B, HKV, MB * BS, H100_SMS)
    return np.array([0, 1, 31, 32, 33, sl - 1, sl + 1, 4093], np.int32)


def _inputs(G, D, seed):
    """q [8, G*HKV, D], pools [nb, BS, HKV, D], tables [8, MB] with
    sentinel tails, lengths; NaN past each length in its last block."""
    r = np.random.RandomState(seed)
    lengths = _lengths()
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
    for b, n in enumerate(lengths):
        if n % BS:
            pk[tables[b, n // BS], n % BS:] = np.nan
            pv[tables[b, n // BS], n % BS:] = np.nan
    return q, pk, pv, tables, lengths


def _split_emulation(q, pool_k, pool_v, tables, lengths):
    """The kernel's arithmetic on torch tensors of its input type; returns
    ``[B, H, D]`` of that type."""
    B, H, D = q.shape
    nb, bs, Hkv, _ = pool_k.shape
    G = H // Hkv
    mb = tables.shape[1]
    sl = tpd.split_len(B, Hkv, mb * bs, H100_SMS)
    dt = q.dtype
    scale = 1.0 / math.sqrt(D)
    out = torch.zeros(B, H, D, dtype=dt)
    for b in range(B):
        L = min(max(int(lengths[b]), 0), mb * bs)
        if L == 0:
            continue                                    # a row of zeros
        pos = torch.arange(L)
        phys = tables[b, pos // bs].long().clamp(0, nb - 1)
        k_rows = pool_k[phys, pos % bs].float()         # [L, Hkv, D]
        v_rows = pool_v[phys, pos % bs].float()
        for kvh in range(Hkv):
            qg = q[b, kvh * G:(kvh + 1) * G].float()    # [G, D]
            parts = []
            for s0 in range(0, L, sl):
                s1 = min(L, s0 + sl)
                m = torch.full((G,), NEG_INF)
                l = torch.zeros(G)
                acc = torch.zeros(G, D)
                for p0 in range(s0, s1, tpd.PAGE):
                    p1 = min(s1, p0 + tpd.PAGE)
                    s = (qg @ k_rows[p0:p1, kvh].T) * scale
                    m_new = torch.maximum(m, s.max(1).values)
                    p = torch.exp(s - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = alpha * l + p.sum(1)
                    m = m_new
                    acc = (acc * alpha[:, None]
                           + p.to(dt).float() @ v_rows[p0:p1, kvh])
                parts.append((m, l, acc))
            if len(parts) == 1:
                _, l, acc = parts[0]
            else:                            # the combine, in split order
                m_max = torch.stack([m for m, _, _ in parts]).max(0).values
                acc = torch.zeros(G, D)
                l = torch.zeros(G)
                for m, ls, a in parts:
                    w = torch.exp(m - m_max)
                    acc = acc + w[:, None] * a
                    l = l + w * ls
            out[b, kvh * G:(kvh + 1) * G] = (
                acc / l.clamp(min=1e-30)[:, None]).to(dt)
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
def test_split_emulation_within_tol_of_jax_reference(G, D, dtype):
    q, pk, pv, tables, lengths = _inputs(G, D, seed=G * 100 + D)
    jdt = getattr(jnp, dtype)
    want = jax_paged_reference(jnp.asarray(q, jdt), jnp.asarray(pk, jdt),
                               jnp.asarray(pv, jdt), jnp.asarray(tables),
                               jnp.asarray(lengths))
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    tdt = getattr(torch, dtype)
    got = _split_emulation(*(torch.from_numpy(x).to(tdt)
                             for x in (q, pk, pv)),
                           torch.from_numpy(tables),
                           torch.from_numpy(lengths)).float()
    assert torch.isfinite(got).all()
    assert (got[0] == 0).all()                          # length 0
    atol, rtol = TOL[dtype]
    assert ((got - want).abs() <= atol + rtol * want.abs()).all()


@pytest.mark.parametrize("B,Hkv", [(8, 32), (8, 8), (1, 1), (64, 32)])
def test_split_rule(B, Hkv):
    """Splits are whole pages, at least MIN_SPLIT_PAGES long, cover the
    table, and a full-capacity batch gets at least BLOCKS_PER_SM blocks an
    SM unless the split floor stops it."""
    cap = MB * BS
    sl = tpd.split_len(B, Hkv, cap, H100_SMS)
    n_split = -(-cap // sl)
    assert sl % tpd.PAGE == 0 and sl >= tpd.MIN_SPLIT_PAGES * tpd.PAGE
    assert n_split * sl >= cap
    if sl > tpd.MIN_SPLIT_PAGES * tpd.PAGE:
        assert n_split * B * Hkv >= tpd.BLOCKS_PER_SM * H100_SMS


def test_split_rule_fills_the_card_at_the_smoke_lengths():
    """The 7B serving geometry (8 rows, 32 KV heads, 4096-key tables) at
    the smoke's lengths: at least two blocks an SM do work."""
    sl = tpd.split_len(8, 32, MB * BS, H100_SMS)
    lengths = [1, 31, 33, 700, 1601, 2500, 4093, 0]
    active = 32 * sum(max(1, -(-n // sl)) for n in lengths)
    assert active >= 2 * H100_SMS


def test_wrapper_takes_the_plain_version_on_the_cpu():
    q, pk, pv, tables, lengths = _inputs(4, 64, seed=7)
    args = [torch.from_numpy(x) for x in (q, pk, pv, tables, lengths)]
    torch.testing.assert_close(tpd.paged_decode_attention(*args),
                               tpd.paged_decode_attention_reference(*args))
