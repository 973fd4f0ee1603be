"""The fused decode tick kernel's bf16 arithmetic, checked on the CPU
against the JAX reference.

``csrc/fused_decode_tick.cu`` cuts every projection into tiles of 64
output columns by chunks of 64 k rows, numbered tile-major, and gives each
of the grid's blocks an equal run of chunks: a block's share of one tile
(a piece) is summed in float32 on the tensor cores, the pieces are added
in block order, and the sum is rounded to bf16 where the scanned tick
rounds. The attention is the split-KV walk at the paged decode kernel's
split plan. With int8 weights a bf16 chunk is two tiles wide (64 k rows
x 128 columns, 8 KB of int8; a projection of an odd number of tiles ends
in a one-tile chunk) and every weight value reaching an MMA is ``_dq``'s
``round(float(q) * scale)``.
``_tick_emulation`` below repeats that arithmetic in float32
PyTorch, with each bf16 rounding written out (the kernel has no CPU
mode); its logits and appended K/V rows must sit within the scaled bf16
bound ``chip_smoke.py`` holds the kernel to (``BWD_TOL``'s form:
``atol * max|ref| + rtol * |ref|``) of the JAX
``fused_decode_tick_reference``
(``paddle_tpu/kernels/pallas_fused_decode_tick.py:88``, the scanned tick
with the plain attention) on ``llama_tiny`` widened to head dim 64
(hidden 256, intermediate 512, 4 heads over 2 KV heads, 2 layers, bf16),
11 rows (sampled, idle and sentinel rows among them), lengths up to 379
over 384-key tables (two splits a long row), with dense weights and with
``jdec.quantize_decode_params``' int8 pairs (the two-tile plan). Grids of
5 blocks (many pieces a tile) and 396 (an H100 at 3 blocks an SM). Inputs
from a numpy seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from chip_smoke import BWD_TOL
from paddle_tpu.kernels.pallas_fused_decode_tick import \
    fused_decode_tick_reference as jax_tick_reference
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import decode as jdec
from paddle_tpu_torch.kernels import fused_decode_tick as tft
from paddle_tpu_torch.kernels import split_kv
from test_torch_paged_split import H100_SMS, _split_emulation
from torch_threads import one_torch_thread  # noqa: F401

NT, KC = tft.TILE_COLS[torch.bfloat16], tft.CHUNK
PC8 = tft.PLAN_COLS[torch.bfloat16, True]        # int8 weights' plan tile
NH, NKV, HD, EPS, THETA = 4, 2, 64, 1e-5, 10000.0
HIDDEN, INTER = 256, 512
BS, MB = 16, 24                      # 384-key tables
LENS = np.array([10, 0, 200, 379, 31, 64, 255, 256, 120, 383, 5], np.int32)
APP = np.array([1, 0, 1, 1, 1, 1, 1, 1, 0, 1, 1], np.int32)


def _bf(x):
    return x.to(torch.bfloat16).float()


def _pieces(t, N, K, grid, cols=NT):
    """The k ranges ``[k0, k1)`` of plan tile ``t``'s pieces, in slot
    order: the kernel's ``Plan`` over plan tiles of ``cols`` columns (the
    last one narrower where ``cols`` does not divide N) and chunks of
    ``KC`` k rows (block b streams chunks [b*C/geff, (b+1)*C/geff))."""
    nc = K // KC
    C = -(-N // cols) * nc
    geff = min(grid, C)
    c0, c1 = t * nc, (t + 1) * nc
    b, out = ((c0 + 1) * geff - 1) // C, []
    while b < geff and b * C // geff < c1:
        lo, hi = max(c0, b * C // geff), min(c1, (b + 1) * C // geff)
        out.append(((lo - c0) * KC, (hi - c0) * KC))
        b += 1
    return out


def _gemv(x, w, grid, pc=NT):
    """``x [R, K] @ w [K, N]`` as the kernel sums it: each plan tile's
    (``pc`` columns) pieces in float32, added in slot order, the sum
    rounded to bf16."""
    R, K = x.shape
    N = w.shape[1]
    out = torch.empty(R, N)
    for t in range(-(-N // pc)):
        cols = slice(t * pc, min(N, (t + 1) * pc))
        s = torch.zeros(R, cols.stop - cols.start)
        for k0, k1 in _pieces(t, N, K, grid, pc):
            s = s + x[:, k0:k1] @ w[k0:k1, cols]
        out[:, cols] = s
    return _bf(out)


def _rms(x, w):
    out = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS)
    return _bf(_bf(out) * w)


def _rope(y, sin_r, cos_r):
    half = y.shape[-1] // 2
    rot = torch.cat([-y[..., half:], y[..., :half]], -1)
    return _bf(y * cos_r[:, None] + rot * sin_r[:, None])


def _live(tables, nb):
    """Rows that append, and where: (row, block, position in block)."""
    out = []
    for b in range(len(LENS)):
        phys = tables[b, min(LENS[b] // BS, MB - 1)]
        if APP[b] and LENS[b] < MB * BS and phys < nb:
            out.append((b, int(phys), int(LENS[b] % BS)))
    return out


def _tick_emulation(p, head, tables, sin, cos, tok, pk, pv, grid, pc=NT):
    """The kernel's tick on float32 tensors holding bf16 values (the
    weights as the MMAs see them, ``head [H, V]``; ``pk``, ``pv`` bf16,
    appended in place) over plan tiles of ``pc`` columns; returns the
    float32 logits."""
    R = len(tok)
    L, nb = pk.shape[0], pk.shape[1]
    pos = torch.from_numpy(np.clip(LENS, 0, sin.shape[0] - 1)).long()
    sin_r, cos_r = sin[pos], cos[pos]
    alen = torch.from_numpy(LENS + APP)
    tbl = torch.from_numpy(tables)
    live = _live(tables, nb)
    h = p["embed"][torch.from_numpy(tok)]
    for l in range(L):
        hn = _rms(h, p["input_ln"][l])
        qkv = _gemv(hn, torch.cat([p["wq"][l], p["wk"][l], p["wv"][l]], 1),
                    grid, pc)
        q = _rope(qkv[:, :NH * HD].reshape(R, NH, HD), sin_r, cos_r)
        k = _rope(qkv[:, NH * HD:(NH + NKV) * HD].reshape(R, NKV, HD),
                  sin_r, cos_r)
        v = qkv[:, (NH + NKV) * HD:].reshape(R, NKV, HD)
        for b, phys, row in live:
            pk[l, phys, row] = k[b].to(torch.bfloat16)
            pv[l, phys, row] = v[b].to(torch.bfloat16)
        attn = _split_emulation(q.to(torch.bfloat16), pk[l], pv[l], tbl,
                                alen).float()
        h = _bf(h + _gemv(attn.reshape(R, NH * HD), p["wo"][l], grid, pc))
        hn = _rms(h, p["post_ln"][l])
        gu = _gemv(hn, torch.cat([p["w_gate"][l], p["w_up"][l]], 1), grid, pc)
        g, u = gu[:, :INTER], gu[:, INTER:]
        act = _bf(_bf(g / (1 + torch.exp(-g))) * u)
        h = _bf(h + _gemv(act, p["w_down"][l], grid, pc))
    hn = _rms(h, p["final_norm"])
    return _gemv(hn, head, grid, pc)


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def bf16_model(request):
    paddle.seed(17)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(
        hidden_size=HIDDEN, intermediate_size=INTER, num_hidden_layers=2,
        num_attention_heads=NH, num_key_value_heads=NKV, dtype="bfloat16",
        tie_word_embeddings=request.param))
    p, tied = jdec.llama_decode_params(jm)
    return p, tied


def _inputs(seed=11):
    """Tables with each live row's blocks mapped (sentinel tails), row 7's
    append block unmapped (a sentinel append); bf16 pools, tokens, keys;
    rows 0 and 4 sample."""
    r = np.random.RandomState(seed)
    need = [-(-int(n + 1) // BS) for n in LENS]
    need[7] = LENS[7] // BS                   # block 16 stays a sentinel
    nb = sum(need) + 2
    perm = r.permutation(nb)
    tables = np.full((len(LENS), MB), nb, np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    pk = r.randn(2, nb, BS, NKV, HD).astype(np.float32)
    pv = r.randn(2, nb, BS, NKV, HD).astype(np.float32)
    tok = r.randint(0, 256, len(LENS)).astype(np.int64)
    keys = r.randint(0, 2 ** 32, (len(LENS), 2), dtype=np.uint64).astype(
        np.int64)
    temps = np.where(np.isin(np.arange(len(LENS)), [0, 4]), 0.8,
                     0.0).astype(np.float32)
    topks = np.where(temps > 0, 7, 0).astype(np.int32)
    return tables, pk, pv, tok, keys, temps, topks


def _within(got, want):
    atol, rtol = BWD_TOL["bfloat16"]
    err = (got - want).abs()
    return bool((err <= atol * want.abs().max() + rtol * want.abs()).all())


def _dq_torch(w):
    """A weight as the kernel's MMAs see it: a dense bf16 array, or an
    int8 ``(q, scale)`` pair as ``_dq`` dequantizes it (one rounding)."""
    if isinstance(w, tuple):
        q, sc = (torch.from_numpy(np.array(x, np.float32)) for x in w)
        return _bf(q * sc)
    return torch.from_numpy(np.array(w, np.float32))


@pytest.mark.parametrize("grid, w8", [(5, False), (396, False), (5, True),
                                     (396, True)],
                         ids=["5", "396", "5-w8", "396-w8"])
def test_emulation_within_scaled_bf16_bound_of_jax_reference(
        bf16_model, grid, w8, monkeypatch):
    """Dense weights in one-tile chunks, and int8 weights
    (``jdec.quantize_decode_params``, the tied head quantized along V) in
    the kernel's two-tile chunks, against the reference tick over the same
    parameters."""
    p, tied = bf16_model
    if w8:
        p = jdec.quantize_decode_params(p, tied)
    tables, pk, pv, tok, keys, temps, topks = _inputs()
    js, jc = jllama._rope_tables(MB * BS, HD, THETA)
    stack = tuple(p[k] for k in jdec._STACK_KEYS)
    jhead = jdec._dq_head(p, tied, p["embed"].dtype)
    seen = {}
    sample = jdec.sample_rows

    def grab(logits, *a, **k):                # the reference's logits
        seen["logits"] = logits
        return sample(logits, *a, **k)

    monkeypatch.setattr(jdec, "sample_rows", grab)
    jpk, jpv = (jnp.asarray(x, jnp.bfloat16) for x in (pk, pv))
    _, jpk, jpv, _ = jax_tick_reference(
        p, stack, jhead, jnp.asarray(tables), js, jc,
        jnp.asarray(tok, jnp.int32), jpk, jpv, jnp.asarray(LENS),
        jnp.asarray(keys, jnp.uint32), jnp.asarray(APP), jnp.asarray(temps),
        jnp.asarray(topks), nh=NH, nkv=NKV, hd=HD, eps=EPS,
        decode_attn="jnp")
    want = torch.from_numpy(np.asarray(seen["logits"], np.float32))

    tp = {k: _dq_torch(v) for k, v in p.items()}
    # the head [H, V]: the embedding transposed when tied, or (int8) the
    # lm head pair dequantized, then transposed when tied (_dq_head)
    head = tp["lm_head"] if not tied else (tp["lm_head"] if w8
                                           else tp["embed"]).T
    tpk, tpv = (torch.from_numpy(x).to(torch.bfloat16) for x in (pk, pv))
    got = _tick_emulation(tp, head, tables, torch.from_numpy(np.array(js)),
                          torch.from_numpy(np.array(jc)), tok, tpk, tpv,
                          grid, PC8 if w8 else NT)
    assert torch.isfinite(got).all() and got.shape == want.shape
    assert _within(got, want)
    live = _live(tables, pk.shape[1])
    assert len(live) == 8                     # 2 idle rows, 1 sentinel
    for gpool, jpool in ((tpk, jpk), (tpv, jpv)):
        jp = torch.from_numpy(np.asarray(jnp.asarray(jpool, jnp.float32)))
        rows = [(gpool[:, ph, r].float(), jp[:, ph, r])
                for _, ph, r in live]
        assert _within(torch.stack([g for g, _ in rows]),
                       torch.stack([w for _, w in rows]))
        untouched = torch.ones(gpool.shape[:3], dtype=torch.bool)
        for _, ph, r in live:
            untouched[:, ph, r] = False
        assert torch.equal(gpool.float()[untouched], jp[untouched])


@pytest.mark.parametrize("grid", [5, 396])
def test_emulation_splits_k_and_the_attention(grid):
    """The plan really splits K: at 5 blocks a block streams many chunks
    across tile boundaries, at 396 (more blocks than these projections
    have chunks) each block takes one chunk; both cut tiles into several
    pieces. The long rows take two splits of the walk."""
    shapes = ((NH + 2 * NKV) * HD, HIDDEN), (HIDDEN, INTER), (256, HIDDEN)
    most = max(len(_pieces(t, N, K, grid)) for N, K in shapes
               for t in range(N // NT))
    assert most > 1
    sl, n_split = split_kv.plan(len(LENS), NKV, MB * BS, H100_SMS)
    assert n_split == 2 and LENS.max() > sl


SHAPES = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008),
          (32000, 4096), (512, 256), (256, 512), (320, 512)]


@pytest.mark.parametrize("grid", [1, 5, 132, 396, 528])
@pytest.mark.parametrize(
    "shape, pc", [(s, NT) for s in SHAPES] + [(s, PC8) for s in SHAPES],
    ids=[f"{n}x{k}" for n, k in SHAPES] + [f"{n}x{k}-w8" for n, k in SHAPES])
def test_part_slots_bound_the_pieces(shape, pc, grid):
    """The wrapper sizes the pieces' buffer by ``part_slots`` at the
    largest grid it allows, for the plan of the launch (one-tile chunks,
    or two-tile chunks of int8 weights in bf16); every plan tile's pieces
    fit at that grid and any smaller one (7B's QKV, O, gate/up, down and
    head, tiny shapes with fewer chunks than blocks, and N = 320, five
    tiles, whose two-tile plan ends in a one-tile chunk)."""
    N, K = shape
    bound = tft.part_slots(N, K, pc, max(grid, 528))
    assert max(len(_pieces(t, N, K, grid, pc))
               for t in range(-(-N // pc))) <= bound
    # every chunk is in exactly one piece, and the pieces cover K
    for t in range(-(-N // pc)):
        ranges = _pieces(t, N, K, grid, pc)
        assert ranges[0][0] == 0 and ranges[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_plan_columns_of_each_plan():
    """Two-tile (128-column) chunks for int8 weights in bf16 (8 KB of int8
    in 128-byte rows, a dense bf16 chunk's bytes and row width), one tile
    otherwise; 64 k rows each. The pieces' buffer follows the plan: at 7B
    widths and 528 blocks a 128-column plan tile of the head takes up to
    4 pieces where a 64-column one takes 3."""
    assert tft.CHUNK == 64
    assert tft.PLAN_COLS == {(torch.bfloat16, False): 64,
                             (torch.bfloat16, True): 128,
                             (torch.float32, False): 32,
                             (torch.float32, True): 32}
    assert tft.part_slots(32000, 4096, PC8, 528) == 4
    assert tft.part_slots(32000, 4096, NT, 528) == 3
    geo = (8, 32, 32, 128, 4096, 11008, 32000)
    assert tft.part_size(*geo, PC8, 528) == 4 * 8 * 32000
