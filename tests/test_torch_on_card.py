"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is ``cuda``-marked and skips without a CUDA device and
``nvcc``. The file imports neither JAX nor ``paddle_tpu``, so it runs on
the machine with the card, where JAX is not installed (the tests'
``conftest.py`` imports JAX, hence ``--noconftest``)::

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_on_card.py

Tolerances: float32 kernels differ from their plain versions only in
summation order; bf16 ones also round P (and dS) to 8 mantissa bits where
the two sides' float32 values differ in the last bits. The backward
tolerances are relative to each gradient's largest entry, as in
``chip_smoke.py``'s ``BWD_TOL``. The sweep of the three tensor-core kernels
(``TestTensorCoreFlash``: the flash forward, dK/dV and dQ) holds them to
``chip_smoke.py``'s own ``TOL`` and ``BWD_TOL``, and the split-KV paged
decode sweep (``test_paged_decode_split_sweep``) to ``TOL``;
``-k "TensorCore or paged"`` runs those two alone. The sweeps of the two
kernels redesigned last — dense decode on the split-KV walk
(``test_decode_split_sweep``) and ragged attention on the split-KV walk
and the ``wgmma`` tile (``test_ragged_sweep``) — hold them to ``TOL``;
``-k sweep`` runs the three decode-side sweeps alone.
"""
import subprocess

import numpy as np
import pytest
import torch

from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.kernels import LAUNCHES, _build, reset_launches
from paddle_tpu_torch.kernels import decode as tdk
from paddle_tpu_torch.kernels import flash as tflash
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import fused_decode_tick as tft
from paddle_tpu_torch.kernels import paged_decode as tpd
from paddle_tpu_torch.kernels import ragged_attention as tra
from paddle_tpu_torch.kernels import split_kv
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, _rope_tables,
                                           llama_decode_params, llama_tiny)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)
from paddle_tpu_torch.serving.decode import _head, _keys_host
from chip_smoke import BWD_TOL, TOL

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    try:
        subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                       check=True)
    except (OSError, subprocess.CalledProcessError):
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30)).item()


def _paged(B, H, Hkv, D, mb, bs, seed):
    """Pool + scrambled tables with sentinel tails, and NaN in the
    unwritten rows of each row's last block."""
    r = np.random.RandomState(seed)
    nb = B * mb + 2
    q = r.randn(B, H, D).astype(np.float32)
    pk = r.randn(nb, bs, Hkv, D).astype(np.float32)
    pv = r.randn(nb, bs, Hkv, D).astype(np.float32)
    tables = r.permutation(B * mb).reshape(B, mb).astype(np.int32)
    lengths = r.randint(1, mb * bs + 1, B).astype(np.int32)
    for b in range(B):
        L = int(lengths[b])
        tables[b, -(-L // bs):] = nb                      # unmapped
        if L % bs:
            pk[tables[b, L // bs], L % bs:] = np.nan
            pv[tables[b, L // bs], L % bs:] = np.nan
    return q, pk, pv, tables, lengths


def _ragged(spans, H, Hkv, D, mb, bs, seed, T):
    """spans: [(qlen, kvlen)] per sequence, packed back to back; T pads
    the packed buffer with rows outside every span."""
    r = np.random.RandomState(seed)
    R = len(spans)
    qlen = np.array([s[0] for s in spans], np.int32)
    kvlen = np.array([s[1] for s in spans], np.int32)
    qstart = np.concatenate([[0], np.cumsum(qlen)[:-1]]).astype(np.int32)
    nb = R * mb + 1
    q = r.randn(T, H, D).astype(np.float32)
    pk = r.randn(nb, bs, Hkv, D).astype(np.float32)
    pv = r.randn(nb, bs, Hkv, D).astype(np.float32)
    tables = r.permutation(R * mb).reshape(R, mb).astype(np.int32)
    for i, kl in enumerate(kvlen):
        tables[i, -(-int(kl) // bs):] = nb                  # sentinel tail
    return q, pk, pv, tables, qstart, qlen, kvlen


# (qlen, kvlen): span-1 decode rows, chunks starting mid-block, a chunk
# ending exactly on a block edge, a dead row
MIXED = [(1, 29), (5, 21), (0, 0), (8, 16), (3, 35), (1, 1), (7, 13)]
# (qlen, kvlen): a dead row, decode rows of 1 and 517 keys, chunks of 2,
# 63, 64 and 65 (from position 0 and mid-block) and a 500-token chunk
# from position 37 whose last key tile is partial
SWEEP_SPANS = [(0, 0), (1, 1), (2, 35), (63, 63), (64, 200), (1, 517),
               (65, 100), (500, 537)]


def _ragged_spans(spans, G, Hkv, D, bs, mb, seed):
    """Packed spans (5 more rows outside every span) over a pool of just
    their blocks: scrambled placement, sentinel table tails, NaN in the
    stale rows of each sequence's last block."""
    r = np.random.RandomState(seed)
    qlen = np.array([s[0] for s in spans], np.int32)
    kvlen = np.array([s[1] for s in spans], np.int32)
    qstart = np.concatenate([[0], np.cumsum(qlen)[:-1]]).astype(np.int32)
    need = [-(-int(k) // bs) for k in kvlen]
    nb = sum(need) + 2
    perm = r.permutation(nb)
    tables = np.full((len(spans), mb), nb, np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    q = r.randn(int(qlen.sum()) + 5, G * Hkv, D).astype(np.float32)
    pk = r.randn(nb, bs, Hkv, D).astype(np.float32)
    pv = r.randn(nb, bs, Hkv, D).astype(np.float32)
    for i, k in enumerate(kvlen):
        if k % bs:
            pk[tables[i, k // bs], k % bs:] = np.nan
            pv[tables[i, k // bs], k % bs:] = np.nan
    return q, pk, pv, tables, qstart, qlen, kvlen


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
class TestServingKernels:
    def test_paged_decode_kernel_vs_plain(self, cuda_dev, dtype, atol):
        q, pk, pv, tbl, lens = _paged(4, 8, 2, 64, 4, 16, seed=1)
        a = [torch.from_numpy(x).to(cuda_dev, dtype) for x in (q, pk, pv)]
        a += [torch.from_numpy(x).to(cuda_dev) for x in (tbl, lens)]
        got = tpd.paged_decode_attention(*a)
        want = tpd.paged_decode_attention_reference(*a)
        assert (got.float() - want.float()).abs().max().item() <= atol

    @pytest.mark.parametrize("D", [64, 128, 256])
    @pytest.mark.parametrize("G", [1, 4, 8])
    def test_paged_decode_split_sweep(self, cuda_dev, dtype, atol, G, D):
        """The split-KV kernel over lengths 0, 1, 31, 32, 33, a split +- 1,
        several splits and 4093 (block 16, so a 32-key page spans two
        blocks): within TOL, the same bits on a second launch, one launch
        counted per call."""
        B, Hkv, bs, mb = 8, 2, 16, 256
        sms = torch.cuda.get_device_properties(cuda_dev).multi_processor_count
        sl = tpd.split_len(B, Hkv, mb * bs, sms)
        lengths = np.array([0, 1, 31, 32, 33, sl - 1, 3 * sl + 5, 4093],
                           np.int32)
        r = np.random.RandomState(G * 10 + D)
        need = [-(-int(n) // bs) for n in lengths]
        nb = sum(need) + 2
        perm = r.permutation(nb)
        tables = np.full((B, mb), nb, np.int32)          # sentinel tails
        at = 0
        for b, n in enumerate(need):
            tables[b, :n] = perm[at:at + n]
            at += n
        pk = r.randn(nb, bs, Hkv, D).astype(np.float32)
        pv = r.randn(nb, bs, Hkv, D).astype(np.float32)
        for b, n in enumerate(lengths):
            if n % bs:
                pk[tables[b, n // bs], n % bs:] = np.nan
                pv[tables[b, n // bs], n % bs:] = np.nan
        q = r.randn(B, G * Hkv, D).astype(np.float32)
        a = [torch.from_numpy(x).to(cuda_dev, dtype) for x in (q, pk, pv)]
        a += [torch.from_numpy(x).to(cuda_dev) for x in (tables, lengths)]
        reset_launches()
        got = tpd.paged_decode_attention(*a)
        again = tpd.paged_decode_attention(*a)
        assert LAUNCHES["paged_decode"] == 2
        assert tpd.LAST_GRID["split_len"] == sl
        assert tpd.LAST_GRID["n_split"] > 1
        assert torch.equal(got, again)
        want = tpd.paged_decode_attention_reference(*a)
        assert _within(got, want, *TOL[str(dtype).split(".")[-1]])
        assert (got[0] == 0).all()

    def test_ragged_kernel_vs_plain(self, cuda_dev, dtype, atol):
        args = _ragged(MIXED, 8, 2, 64, 5, 8, seed=2, T=48)
        a = [torch.from_numpy(x).to(cuda_dev) for x in args]
        a = [x.to(dtype) for x in a[:3]] + a[3:]
        got = tra.ragged_paged_attention(*a)
        want = tra.ragged_attention_reference(*a)
        assert (got.float() - want.float()).abs().max().item() <= atol

    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("G", [1, 4])
    def test_ragged_sweep(self, cuda_dev, dtype, atol, G, D):
        """Both grids: span-1 rows on the split-KV walk, chunks of 2, 63,
        64, 65 and 500 on the tile grid (bf16: the wgmma tile), block 16
        so a 64-key tile spans four pool blocks: within TOL, rows outside
        every span zero, one launch counted per call."""
        args = _ragged_spans(SWEEP_SPANS, G, 2, D, 16, 36, seed=G * 7 + D)
        a = [torch.from_numpy(x).to(cuda_dev) for x in args]
        a = [x.to(dtype) for x in a[:3]] + a[3:]
        reset_launches()
        got = tra.ragged_paged_attention(*a)
        assert LAUNCHES["ragged_attention"] == 1
        assert tra.LAST_GRID["tile_rows"] == tra.TILE_ROWS[dtype]
        want = tra.ragged_attention_reference(*a)
        assert _within(got, want, *TOL[str(dtype).split(".")[-1]])
        assert (got[int(args[5].sum()):] == 0).all()

    @pytest.mark.parametrize("D", [64, 128, 256])
    @pytest.mark.parametrize("G", [1, 4, 8])
    def test_decode_split_sweep(self, cuda_dev, dtype, atol, G, D):
        """The dense-cache split-KV kernel over lengths 0, 1, 31, 33, a
        split +- 1, 4093 and S_max (4096), NaN past each length: within
        TOL, the same bits on a second launch, one launch counted per
        call."""
        B, Hkv, s_max = 8, 2, 4096
        sms = torch.cuda.get_device_properties(cuda_dev).multi_processor_count
        sl = split_kv.split_len(B, Hkv, s_max, sms)
        lengths = np.array([0, 1, 31, 33, sl - 1, sl + 1, 4093, s_max],
                           np.int32)
        r = np.random.RandomState(G * 10 + D + 1)
        q = r.randn(B, G * Hkv, D).astype(np.float32)
        k = r.randn(B, s_max, Hkv, D).astype(np.float32)
        v = r.randn(B, s_max, Hkv, D).astype(np.float32)
        for b, n in enumerate(lengths):
            k[b, n:] = v[b, n:] = np.nan
        a = [torch.from_numpy(x).to(cuda_dev, dtype) for x in (q, k, v)]
        a.append(torch.from_numpy(lengths).to(cuda_dev))
        reset_launches()
        got = tdk.decode_attention(*a)
        again = tdk.decode_attention(*a)
        assert LAUNCHES["decode"] == 2
        assert tdk.LAST_GRID["split_len"] == sl
        assert tdk.LAST_GRID["n_split"] > 1
        assert torch.equal(got, again)
        want = tdk.decode_attention_reference(*a)
        assert _within(got, want, *TOL[str(dtype).split(".")[-1]])
        assert (got[0] == 0).all()

    def test_decode_kernel_vs_plain(self, cuda_dev, dtype, atol):
        """Dense cache, GQA, lengths 1 and S_max, NaN past each length."""
        r = np.random.RandomState(3)
        q = r.randn(4, 8, 64).astype(np.float32)
        k = r.randn(4, 77, 2, 64).astype(np.float32)
        v = r.randn(4, 77, 2, 64).astype(np.float32)
        lens = np.array([1, 77, 40, 9], np.int32)
        for b, n in enumerate(lens):
            k[b, n:] = v[b, n:] = np.nan
        a = [torch.from_numpy(x).to(cuda_dev, dtype) for x in (q, k, v)]
        a.append(torch.from_numpy(lens).to(cuda_dev))
        reset_launches()
        got = tdk.decode_attention(*a)
        assert LAUNCHES["decode"] == 1
        want = tdk.decode_attention_reference(*a)
        assert (got.float() - want.float()).abs().max().item() <= atol

    @pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
    @pytest.mark.parametrize("rows", [4, 21, 70],
                             ids=["rows4", "rows21", "rows70"])
    def test_fused_tick_kernel_vs_plain(self, cuda_dev, dtype, atol, tie,
                                        rows):
        """One launch per tick; keys bit for bit; logits and the appended
        pool rows within the tolerance; tokens equal in float32; GQA, an
        untied or a tied (embedding read transposed) head, and 4 rows, 21
        (past the 16 the kernel once took, not a multiple of its 8-row
        tiles) or 70 (two passes over the weights, of 64 rows and 6); the
        last layer's attention equals the paged decode kernel's at the
        tick's own q and updated pool, bit for bit."""
        cfg = llama_tiny(hidden_size=256, num_attention_heads=4,
                         num_key_value_heads=2, tie_word_embeddings=tie,
                         dtype=str(dtype).split(".")[-1])
        m = LlamaForCausalLM(cfg, device="cuda", seed=4)
        p, tied = llama_decode_params(m)
        r = np.random.RandomState(4)
        L, nb, bs, D = cfg.num_hidden_layers, 12 + 2 * (rows - 4), 16, 64
        pk = torch.from_numpy(r.randn(L, nb, bs, 2, D).astype(
            np.float32)).to(cuda_dev, dtype)
        pv = torch.from_numpy(r.randn(L, nb, bs, 2, D).astype(
            np.float32)).to(cuda_dev, dtype)
        tables = np.full((rows, 4), nb, np.int32)
        tables[0, :2], tables[1, :3], tables[2, :1] = [3, 7], [0, 1, 2], [9]
        lens = np.zeros(rows, np.int32)
        lens[:2] = [20, 40]
        app = np.ones(rows, np.int32)
        app[3] = 0
        temps = np.zeros(rows, np.float32)
        temps[1] = 0.8
        topks = np.zeros(rows, np.int32)
        topks[1] = 7
        tok = [5, 77, 200, 0]
        for b in range(4, rows):      # two blocks each, seeded lengths
            tables[b, :2] = [12 + 2 * (b - 4), 13 + 2 * (b - 4)]
            lens[b] = r.randint(0, 32)
            app[b] = 0 if b % 6 == 0 else 1
            if b % 4 == 0:
                temps[b], topks[b] = 0.7, 5
            tok.append(int(r.randint(0, 256)))
        keys = r.randint(0, 2 ** 32, (rows, 2), dtype=np.uint64).astype(
            np.int64)
        sin, cos = _rope_tables(64, D, 10000.0, device=cuda_dev)
        tok = torch.tensor(tok, device=cuda_dev)
        outs = []
        for fn in (tft.fused_decode_tick, tft.fused_decode_tick_reference):
            k2, v2 = pk.clone(), pv.clone()
            reset_launches()
            with torch.inference_mode():
                out = fn(p, _head(p, tied), tables,
                         torch.from_numpy(tables).to(cuda_dev), sin, cos, tok,
                         k2, v2, lens, keys, app, temps, topks, nh=4, nkv=2,
                         hd=D, eps=1e-5, return_logits=True)
            torch.cuda.synchronize()
            assert LAUNCHES["fused_decode_tick"] == (
                1 if fn is tft.fused_decode_tick else 0)
            assert LAUNCHES["paged_decode"] == 0
            outs.append(out)
            if fn is tft.fused_decode_tick:
                q, attn = (tft.LAST_SCRATCH[k].clone() for k in ("q", "attn"))
        (nxt, gk, gv, gkeys, glog), (wnxt, wk, wv, wkeys, wlog) = outs
        assert (_keys_host(gkeys) == _keys_host(wkeys)).all()
        for g, w in ((glog, wlog), (gk, wk), (gv, wv)):
            assert (g.float() - w.float()).abs().max().item() <= atol
        if dtype == torch.float32:
            assert nxt.tolist() == wnxt.tolist()
        want = tpd.paged_decode_attention(q, gk[L - 1], gv[L - 1], tables,
                                          lens + app)
        assert torch.equal(attn, want)

    def test_flash_kernel_vs_plain(self, cuda_dev, dtype, atol):
        r = np.random.RandomState(0)
        q, k, v = (torch.from_numpy(r.randn(2, 77, h, 64).astype(
            np.float32)).to(cuda_dev, dtype) for h in (8, 2, 2))
        got = tflash.flash_attention(q, k, v, causal=True)
        want = tfa._ref_attention(q, k, v, True)
        assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.parametrize("knob,kernel", [
    (dict(fused_tick=True), "fused_decode_tick"),
    (dict(paged_attn=False), "decode")], ids=["fused_tick", "dense"])
def test_new_engines_kernels_vs_plain(cuda_dev, knob, kernel):
    """float32 greedy streams of the fused-tick and the dense engine with
    the kernels equal those with the plain versions (the flag off), and
    the fused engine's equal the default engine's."""
    cfg = llama_tiny(hidden_size=256, num_attention_heads=4,
                     num_key_value_heads=2)
    model = LlamaForCausalLM(cfg, device="cuda", seed=5)
    r = np.random.RandomState(9)
    reqs = [GenerationRequest(prompt=r.randint(0, 256, n).astype(np.int32),
                              max_new_tokens=12) for n in (45, 12, 30)]
    geo = dict(num_slots=4, max_seq_len=128, prefix_block_size=8,
               prefill_chunk=16, headroom_mult=None)
    outs, launches = {}, {}
    try:
        for use in (True, False):
            set_flags({"FLAGS_use_cuda_kernels": use})
            reset_launches()
            eng = ContinuousBatchingEngine(model, **geo, **knob)
            outs[use] = [o.tolist() for o in eng.generate(reqs)]
            launches[use] = LAUNCHES[kernel]
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    assert outs[True] == outs[False]
    assert launches[True] > 0 and launches[False] == 0
    base = ContinuousBatchingEngine(model, **geo).generate(reqs)
    assert [o.tolist() for o in base] == outs[True]


class TestFlashBackwardKernels:
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("S,Hk", [(77, 2), (128, 8)])
    def test_backward_kernels_vs_plain(self, cuda_dev, dtype, tol, S, Hk):
        """dQ, dK, dV of the two kernels against the plain backward, on a
        tail (S=77) and on full tiles; dK/dV the same bits twice."""
        r = np.random.RandomState(S)
        q, k, v, do = (torch.from_numpy(r.randn(2, S, h, 64).astype(
            np.float32)).to(cuda_dev, dtype) for h in (8, Hk, Hk, 8))
        o, lse = tflash.flash_attention_fwd(q, k, v, True)
        reset_launches()
        got = tflash.flash_attention_bwd(q, k, v, o, lse, do, True)
        assert LAUNCHES["flash_bwd_dkv"] == LAUNCHES["flash_bwd_dq"] == 1
        want = tflash.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                    True)
        for g, w in zip(got, want):
            assert _rel_err(g, w) <= tol
        again = tflash.flash_attention_bwd(q, k, v, o, lse, do, True)
        assert torch.equal(got[1], again[1]) and torch.equal(got[2],
                                                             again[2])

    def test_autograd_goes_through_the_kernels(self, cuda_dev):
        q = torch.randn(1, 70, 4, 128, device=cuda_dev, requires_grad=True)
        reset_launches()
        tfa.attention(q, q, q).sum().backward()
        assert LAUNCHES["flash"] == 1
        assert LAUNCHES["flash_bwd_dkv"] == LAUNCHES["flash_bwd_dq"] == 1

    def test_training_gradients_kernels_vs_plain(self, cuda_dev):
        """A float32 forward+backward of a small LLaMA through the kernels
        and through the plain versions (the flag off): every gradient to
        1e-4 of its largest entry (summation order only)."""
        cfg = llama_tiny(hidden_size=256, num_attention_heads=4,
                         num_key_value_heads=2)
        m = LlamaForCausalLM(cfg, device="cuda", seed=0)
        ids = torch.from_numpy(np.random.RandomState(1).randint(
            0, cfg.vocab_size, (2, 100))).to(cuda_dev)
        grads = {}
        try:
            for use in (True, False):
                set_flags({"FLAGS_use_cuda_kernels": use})
                m.zero_grad()
                m(ids, ids).backward()
                grads[use] = {n: p.grad.clone()
                              for n, p in m.named_parameters()}
        finally:
            set_flags({"FLAGS_use_cuda_kernels": True})
        for n in grads[True]:
            assert _rel_err(grads[True][n], grads[False][n]) <= 1e-4, n


# The bf16 flash forward and dK/dV run on the tensor cores, fp32 on the
# CUDA cores. S covers one tile, its edges, the tail and several tiles; D
# both head sizes the kernels take; G = H / Hk is 1 (MHA) or 4 (GQA).
SWEEP = [(S, D, G) for S in (1, 63, 64, 65, 300, 1024) for D in (64, 128)
         for G in (1, 4)]


def _qkvdo(S, D, G, dtype, dev, B=2, H=8):
    r = np.random.RandomState(S * 7 + D + G)
    return [torch.from_numpy(r.randn(B, S, h, D).astype(np.float32)).to(
        dev, dtype) for h in (H, H // G, H // G, H)]


def _within(got, want, atol, rtol):
    """``TOL``'s form: |got - want| <= atol + rtol * |want|, all finite."""
    g, w = got.float(), want.float()
    return bool(torch.isfinite(g).all()) and bool(
        ((g - w).abs() <= atol + rtol * w.abs()).all())


def _within_scaled(got, want, atol, rtol):
    """``BWD_TOL``'s form: |got - want| <= atol * max|want| + rtol * |want|."""
    g, w = got.float(), want.float()
    return bool(torch.isfinite(g).all()) and bool(
        ((g - w).abs() <= atol * w.abs().max() + rtol * w.abs()).all())


class TestTensorCoreFlash:
    @pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
    @pytest.mark.parametrize("S,D,G", SWEEP)
    def test_forward_bf16_vs_plain(self, cuda_dev, S, D, G, causal):
        """O within TOL["bfloat16"], LSE within TOL["float32"]."""
        q, k, v, _ = _qkvdo(S, D, G, torch.bfloat16, cuda_dev)
        reset_launches()
        o, lse = tflash.flash_attention_fwd(q, k, v, causal)
        assert LAUNCHES["flash"] == 1
        assert _within(o, tfa._ref_attention(q, k, v, causal),
                       *TOL["bfloat16"])
        assert _within(lse, tfa._ref_lse(q, k, causal), *TOL["float32"])

    @pytest.mark.parametrize("S,D,G", SWEEP)
    def test_dkv_bf16_vs_plain(self, cuda_dev, S, D, G):
        """dK and dV within BWD_TOL["bfloat16"]; the same bits on a second
        launch (GQA sums its group in registers, no atomics)."""
        q, k, v, do = _qkvdo(S, D, G, torch.bfloat16, cuda_dev)
        o, lse = tflash.flash_attention_fwd(q, k, v, True)
        delta = tflash.attention_delta(o, do)
        reset_launches()
        got = tflash.flash_bwd_dkv(q, k, v, do, lse, delta, True)
        again = tflash.flash_bwd_dkv(q, k, v, do, lse, delta, True)
        assert LAUNCHES["flash_bwd_dkv"] == 2
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want = tflash.flash_bwd_dkv_reference(q, k, v, do, lse, delta, True)
        if S == 1:
            # one key: the softmax has no gradient with respect to its only
            # score, so dK is 0 in exact arithmetic and both sides return
            # the rounding noise of dP - delta; it stays near 0 beside dV
            size = want[1].float().abs().max()
            assert got[0].float().abs().max() <= 1e-4 * size
            assert want[0].float().abs().max() <= 1e-4 * size
            got, want = got[1:], want[1:]
        for g, w in zip(got, want):
            assert _within_scaled(g, w, *BWD_TOL["bfloat16"])

    @pytest.mark.parametrize("S,D,G", SWEEP)
    def test_dq_bf16_vs_plain(self, cuda_dev, S, D, G):
        """dQ within BWD_TOL["bfloat16"]; the same bits on a second launch
        (no atomics)."""
        q, k, v, do = _qkvdo(S, D, G, torch.bfloat16, cuda_dev)
        o, lse = tflash.flash_attention_fwd(q, k, v, True)
        delta = tflash.attention_delta(o, do)
        reset_launches()
        got = tflash.flash_bwd_dq(q, k, v, do, lse, delta, True)
        again = tflash.flash_bwd_dq(q, k, v, do, lse, delta, True)
        assert LAUNCHES["flash_bwd_dq"] == 2
        assert torch.equal(got, again)
        want = tflash.flash_bwd_dq_reference(q, k, v, do, lse, delta, True)
        if S == 1:
            # one key: dS = P (dP - delta) is 0 in exact arithmetic (P = 1,
            # dP = delta), so both sides return rounding noise; it stays
            # near 0 beside dV
            _, dv = tflash.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   True)
            size = dv.float().abs().max()
            assert got.float().abs().max() <= 1e-4 * size
            assert want.float().abs().max() <= 1e-4 * size
            return
        assert _within_scaled(got, want, *BWD_TOL["bfloat16"])

    @pytest.mark.parametrize("which", ["forward", "dkv", "dq"])
    def test_float32_on_the_cuda_cores(self, cuda_dev, which):
        """float32 still runs the CUDA-core kernels: summation order only,
        so TOL["float32"] (BWD_TOL's form for the gradients)."""
        q, k, v, do = _qkvdo(300, 128, 4, torch.float32, cuda_dev)
        o, lse = tflash.flash_attention_fwd(q, k, v, True)
        if which == "forward":
            assert _within(o, tfa._ref_attention(q, k, v, True),
                           *TOL["float32"])
            assert _within(lse, tfa._ref_lse(q, k, True), *TOL["float32"])
            return
        delta = tflash.attention_delta(o, do)
        args = (q, k, v, do, lse, delta, True)
        if which == "dkv":
            got = tflash.flash_bwd_dkv(*args)
            want = tflash.flash_bwd_dkv_reference(*args)
        else:
            got = (tflash.flash_bwd_dq(*args),)
            want = (tflash.flash_bwd_dq_reference(*args),)
        for g, w in zip(got, want):
            assert _within_scaled(g, w, *BWD_TOL["float32"])


def _front_door_model():
    cfg = llama_tiny(hidden_size=256, num_attention_heads=4,
                     num_key_value_heads=2)
    return LlamaForCausalLM(cfg, device="cuda", seed=7)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "top_k"])
def test_generate_kernels_vs_plain(cuda_dev, sampled):
    """``model.generate`` (decode_chunk=16: flash, ragged and paged
    decode) gives the same float32 ids with the kernels as with the
    plain versions, and launches all three."""
    model = _front_door_model()
    ids = np.random.RandomState(3).randint(0, 256, (3, 40)).astype(np.int32)
    kw = dict(temperature=0.8, top_k=20, seed=5) if sampled else {}
    outs, launches = {}, {}
    try:
        for use in (True, False):
            set_flags({"FLAGS_use_cuda_kernels": use})
            reset_launches()
            outs[use] = model.generate(ids, max_new_tokens=24, **kw).cpu()
            launches[use] = dict(LAUNCHES)
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    assert torch.equal(outs[True], outs[False])
    assert outs[True].device.type == "cpu" and outs[True].shape == (3, 24)
    for name in ("flash", "ragged_attention", "paged_decode"):
        assert launches[True][name] > 0 and launches[False][name] == 0


def test_serve_one_request_on_the_card(cuda_dev):
    """``serve()`` on a CUDA model answers one completion over HTTP with
    the ids a direct engine run gives, through the kernels."""
    import json
    import urllib.request
    from paddle_tpu_torch.serving.server import serve
    model = _front_door_model()
    prompt = np.random.RandomState(4).randint(0, 256, 33).tolist()
    want = ContinuousBatchingEngine(
        model, num_slots=2, max_seq_len=128, decode_chunk=1).generate(
        [GenerationRequest(prompt=prompt, max_new_tokens=10)])[0].tolist()
    reset_launches()
    srv = serve(model, port=0, num_slots=2, max_seq_len=128)
    try:
        req = urllib.request.Request(
            srv.url + "/v1/completions",
            data=json.dumps({"prompt": prompt, "max_tokens": 10}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            doc = json.load(r)
    finally:
        srv.shutdown(drain=False, timeout=60)
    assert doc["choices"][0]["token_ids"] == want
    assert LAUNCHES["flash"] > 0 and LAUNCHES["ragged_attention"] > 0
    assert LAUNCHES["paged_decode"] == 0        # decode_chunk=1
