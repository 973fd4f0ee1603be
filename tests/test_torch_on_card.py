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
``-k "TensorCore or paged"`` runs those two alone (with the quantized
walk's sweep, ``test_paged_decode_quantized_split_sweep``, int8 and fp8
pools). The sweeps of the two
kernels redesigned last — dense decode on the split-KV walk
(``test_decode_split_sweep``) and ragged attention on the split-KV walk
and the ``wgmma`` tile (``test_ragged_sweep``) — hold them to ``TOL``;
``-k sweep`` runs the three decode-side sweeps alone. Every sweep also
runs at the head dims the kernels take since ROADMAP Queue C 7 (``DIMS``:
16, 40, 80 and 96, each at its padded width; the backward and the RoPE
pre-pass at 256 too), and ``-k dims`` runs the fused tick's and the
engines' cases at those dims.
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
from chip_smoke import BWD_TOL, QUANT_F32_LOGITS, TOL

pytestmark = pytest.mark.cuda

#: head dims past {64, 128, 256} that the kernels take since ROADMAP Queue
#: C 7: D % 16 == 0 under 64 (llama_tiny's 16), D % 16 == 8 (40: 8-byte
#: narrow rows and RoPE halves), and two that pad to 128 (80, 96)
DIMS = (16, 40, 80, 96)
#: (hidden, heads, KV heads) of a small model at each of DIMS, with a QKV
#: width (nh + 2 nkv) * D that the fused tick takes (a multiple of 64)
DIM_GEOS = {16: (64, 4, 2), 40: (320, 8, 4), 80: (320, 4, 2),
            96: (384, 4, 2)}


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

    @pytest.mark.parametrize("D", [64, 128, 256, *DIMS])
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

    @pytest.mark.parametrize("D", [64, 128, 256, *DIMS])
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

    @pytest.mark.parametrize("D", [64, 128, 256, *DIMS])
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


@pytest.mark.parametrize("knob", [
    dict(decode_ticks=6), dict(decode_ticks=6, fused_tick=True),
    dict(prefix_cache=True), dict(ragged_step=False)],
    ids=["multitick", "multitick_fused", "prefix_cache", "two_program"])
def test_step9_paths_kernels_graph_and_plain(cuda_dev, knob):
    """float32: the multi-tick engine (the scanned tail on its captured
    graph, then eagerly; the fused tail), the prefix cache (a second wave
    hitting the first's prefix) and the two-program step give the default
    engine's greedy streams with the kernels and with their plain
    versions, with an EOS the rows meet mid-stream; the multi-tick
    launches equal the code's count with the replays counted."""
    cfg = llama_tiny(hidden_size=256, num_attention_heads=4,
                     num_key_value_heads=2)
    model = LlamaForCausalLM(cfg, device="cuda", seed=5)
    r = np.random.RandomState(9)
    pre = r.randint(0, 256, 24).astype(np.int32)
    prompts = [np.concatenate([pre, r.randint(0, 256, n).astype(np.int32)])
               for n in (21, 5, 40)]
    geo = dict(num_slots=4, max_seq_len=128, prefix_block_size=8,
               prefill_chunk=16, headroom_mult=None)
    probe = ContinuousBatchingEngine(model, **geo).generate(
        [GenerationRequest(prompt=prompts[0], max_new_tokens=14)])[0]
    # a token the stream meets after its first (a random tiny model may
    # repeat one token, and then no EOS is planted)
    eos = next((t for i, t in enumerate(probe.tolist())
                if i >= 1 and t not in probe.tolist()[:i]), None)

    def run(**kw):
        eng = ContinuousBatchingEngine(model, **geo, **kw)
        out = []
        for wave in (prompts, prompts[::-1]):
            out += [o.tolist() for o in eng.generate([GenerationRequest(
                prompt=p, max_new_tokens=14, eos_token_id=eos)
                for p in wave])]
        return out, eng

    want, _ = run()
    L = cfg.num_hidden_layers
    try:
        for use, graph in ((True, True), (True, False), (False, True)):
            set_flags({"FLAGS_use_cuda_kernels": use,
                       "FLAGS_cuda_graph_tail": graph})
            reset_launches()
            got, eng = run(**knob)
            torch.cuda.synchronize()
            assert got == want, (use, graph)
            if not use:
                assert not any(LAUNCHES.values())
                continue
            if eng.decode_ticks > 1:
                st, tail = eng.stats, eng._tail
                if eng.fused_tick:
                    assert LAUNCHES["fused_decode_tick"] == \
                        st["mtick_pure_syncs"] + tail.ticks
                    assert LAUNCHES["paged_decode"] == 0
                else:
                    assert LAUNCHES["paged_decode"] == L * tail.ticks
                    assert tail.captures == (1 if graph else 0)
                assert tail.ticks >= st["mtick_ticks"] - st["mtick_syncs"]
            elif knob.get("prefix_cache"):
                # the second wave repeats the first's prompts: each hits
                # its donated full blocks short of its final token
                assert eng.stats["prefill_tokens_saved"] == sum(
                    (len(p) - 1) // 8 * 8 for p in prompts)
            else:
                assert LAUNCHES["paged_decode"] > 0
                assert LAUNCHES["ragged_attention"] == 0
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True,
                   "FLAGS_cuda_graph_tail": True})


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
# the head sizes the kernels take (the padded widths in full, the dims
# that pad to them at fewer S); G = H / Hk is 1 (MHA) or 4 (GQA).
SWEEP = [(S, D, G) for S in (1, 63, 64, 65, 300, 1024) for D in (64, 128,
                                                                 256)
         for G in (1, 4)] + [(S, D, G) for S in (1, 65, 300) for D in DIMS
                             for G in (1, 4)]
FWD_SWEEP = SWEEP


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
    @pytest.mark.parametrize("S,D,G", FWD_SWEEP)
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

    @pytest.mark.parametrize("D", [128, 256, *DIMS])
    @pytest.mark.parametrize("which", ["forward", "dkv", "dq"])
    def test_float32_on_the_cuda_cores(self, cuda_dev, which, D):
        """float32 still runs the CUDA-core kernels: summation order only,
        so TOL["float32"] (BWD_TOL's form for the gradients)."""
        q, k, v, do = _qkvdo(300, D, 4, torch.float32, cuda_dev)
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


# The fused-RoPE mode of the three flash kernels (rope=(sin, cos): Q and K
# un-rotated in; the forward and the backward each rotate Q and K once by
# the rope_qk pre-pass; the adjoint on dQ and dK), in the head-major layout
# the model's bhsd branch hands them.
ROPE_SWEEP = [(S, D, G) for S in (63, 65, 300) for D in (64, 128)
              for G in (1, 4)] + [(S, D, G) for S in (65, 300)
                                  for D in (256, *DIMS) for G in (1, 4)]


class TestRopeFlash:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["fp32", "bf16"])
    @pytest.mark.parametrize("S,D,G", ROPE_SWEEP)
    def test_rope_kernels_vs_plain(self, cuda_dev, S, D, G, dtype):
        """The forward (O within TOL, LSE within TOL["float32"]), dK/dV
        and dQ (BWD_TOL) against the plain versions, which rotate first and
        apply the adjoint to the float32 dK and dQ; counted as
        ``name[rope]``, the forward and each standalone backward entry
        with its own ``rope_qk`` pre-pass; bf16 the same bits on a second
        launch."""
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        r = np.random.RandomState(S + D + G)
        q, k, v, do = (torch.from_numpy(r.randn(2, h, S, D).astype(
            np.float32)).to(cuda_dev, dtype).transpose(1, 2)
            for h in (8, 8 // G, 8 // G, 8))
        rope = _rope_tables(S, D, 10000.0, device=cuda_dev)
        reset_launches()
        o, lse = tflash.flash_attention_fwd(q, k, v, True, rope)
        ro, rl = tflash.flash_attention_reference(q, k, v, True, rope)
        assert _within(o, ro, *TOL[name])
        assert _within(lse, rl, *TOL["float32"])
        delta = tflash.attention_delta(o, do)
        args = (q, k, v, do, lse, delta, True, rope)
        got = tflash.flash_bwd_dkv(*args) + (tflash.flash_bwd_dq(*args),)
        want = tflash.flash_bwd_dkv_reference(*args) + (
            tflash.flash_bwd_dq_reference(*args),)
        assert (LAUNCHES["flash[rope]"], LAUNCHES["flash_bwd_dkv[rope]"],
                LAUNCHES["flash_bwd_dq[rope]"], LAUNCHES["flash"],
                LAUNCHES["rope_qk"]) == (1, 1, 1, 0, 3)
        for g, w in zip(got, want):
            assert _within_scaled(g, w, *BWD_TOL[name])
        if dtype == torch.bfloat16:
            again = tflash.flash_bwd_dkv(*args) + (
                tflash.flash_bwd_dq(*args),)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            assert torch.equal(o, tflash.flash_attention_fwd(q, k, v, True,
                                                             rope)[0])

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["fp32", "bf16"])
    @pytest.mark.parametrize("S,D,G", [(300, 128, 4), (65, 64, 1),
                                       (2048, 128, 1)])
    def test_forward_rotates_once(self, cuda_dev, S, D, G, dtype):
        """``flash_attention_fwd(..., rope)`` is one ``rope_qk`` launch and
        one ``flash[rope]`` launch, with the bits of the plain-mode kernel
        on the pair ``rope_qk`` rotated; the un-rotated inputs are left as
        they were."""
        r = np.random.RandomState(S + D + G + 3)
        q, k, v = (torch.from_numpy(r.randn(2, h, S, D).astype(
            np.float32)).to(cuda_dev, dtype).transpose(1, 2)
            for h in (8, 8 // G, 8 // G))
        q0, k0 = q.clone(), k.clone()
        rope = _rope_tables(S, D, 10000.0, device=cuda_dev)
        reset_launches()
        o, lse = tflash.flash_attention_fwd(q, k, v, True, rope)
        assert (LAUNCHES["rope_qk"], LAUNCHES["flash[rope]"],
                LAUNCHES["flash"]) == (1, 1, 0)
        qr, kr = tflash.rope_qk(q, k, *rope)
        wo, wl = tflash.flash_attention_fwd(qr, kr, v, True)
        assert torch.equal(o, wo) and torch.equal(lse, wl)
        assert torch.equal(q, q0) and torch.equal(k, k0)

    @pytest.mark.parametrize("layout", ["bhsd", "bshd"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["fp32", "bf16"])
    @pytest.mark.parametrize("S,D,G", ROPE_SWEEP)
    def test_pre_pass_is_rope_rotate(self, cuda_dev, S, D, G, dtype,
                                     layout):
        """One ``rope_qk`` launch gives ``rope_rotate``'s bits for Q and
        K, in the inputs' strides."""
        r = np.random.RandomState(S + D + G + 1)
        q, k = (torch.from_numpy(r.randn(2, h, S, D).astype(
            np.float32)).to(cuda_dev, dtype).transpose(1, 2)
            for h in (8, 8 // G))
        if layout == "bshd":
            q, k = q.contiguous(), k.contiguous()
        sin, cos = _rope_tables(S, D, 10000.0, device=cuda_dev)
        reset_launches()
        qr, kr = tflash.rope_qk(q, k, sin, cos)
        assert LAUNCHES["rope_qk"] == 1
        for got, x in ((qr, q), (kr, k)):
            assert got.stride() == x.stride()
            assert torch.equal(got, tflash.rope_rotate(x, sin, cos))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["fp32", "bf16"])
    @pytest.mark.parametrize("S,D,G", [(300, 128, 4), (65, 64, 1)])
    def test_backward_rotates_once(self, cuda_dev, S, D, G, dtype):
        """``flash_attention_bwd(..., rope)`` launches the pre-pass once
        and each backward body once, and gives the bits of the two
        standalone entries (each of which runs its own pre-pass)."""
        r = np.random.RandomState(S + D + G + 2)
        q, k, v, do = (torch.from_numpy(r.randn(2, h, S, D).astype(
            np.float32)).to(cuda_dev, dtype).transpose(1, 2)
            for h in (8, 8 // G, 8 // G, 8))
        rope = _rope_tables(S, D, 10000.0, device=cuda_dev)
        o, lse = tflash.flash_attention_fwd(q, k, v, True, rope)
        reset_launches()
        dq, dk, dv = tflash.flash_attention_bwd(q, k, v, o, lse, do, True,
                                                rope)
        assert (LAUNCHES["rope_qk"], LAUNCHES["flash_bwd_dkv[rope]"],
                LAUNCHES["flash_bwd_dq[rope]"]) == (1, 1, 1)
        delta = tflash.attention_delta(o, do)
        args = (q, k, v, do, lse, delta, True, rope)
        reset_launches()
        want = tflash.flash_bwd_dkv(*args) + (tflash.flash_bwd_dq(*args),)
        assert LAUNCHES["rope_qk"] == 2
        assert all(torch.equal(a, b) for a, b in zip((dk, dv, dq), want))

    @pytest.mark.parametrize("fuse", [False, True], ids=["bhsd", "rope"])
    def test_bhsd_model_gradients_kernels_vs_plain(self, cuda_dev, fuse):
        """A 2-layer model (4 heads of 64, 2 KV heads) in the head-major
        layout, fp32: loss to 1e-5, every gradient to 1e-4 of its largest
        entry, kernels against ``FLAGS_use_cuda_kernels`` off."""
        cfg = llama_tiny(hidden_size=256, num_attention_heads=4,
                         num_hidden_layers=2, attention_layout="bhsd",
                         fuse_rope=fuse)
        model = LlamaForCausalLM(cfg, device=cuda_dev, seed=3)
        ids = torch.from_numpy(np.random.RandomState(1).randint(
            0, 256, (2, 77))).to(cuda_dev)
        out = {}
        try:
            for use in (True, False):
                set_flags({"FLAGS_use_cuda_kernels": use})
                model.zero_grad(set_to_none=True)
                reset_launches()
                loss = model(ids, ids)
                loss.backward()
                out[use] = (float(loss), {n: p.grad.clone() for n, p in
                                          model.named_parameters()},
                            dict(LAUNCHES))
        finally:
            set_flags({"FLAGS_use_cuda_kernels": True})
        assert abs(out[True][0] - out[False][0]) <= 1e-5 * abs(out[False][0])
        for n, g in out[False][1].items():
            assert _rel_err(out[True][1][n], g) <= 1e-4, n
        sfx = "[rope]" if fuse else ""
        assert out[True][2]["flash" + sfx] == 4
        assert out[True][2]["flash_bwd_dq" + sfx] == 2
        # one pre-pass a forward (4: two layers, each recomputed) and one
        # a layer's backward
        assert out[True][2]["rope_qk"] == (6 if fuse else 0)
        assert sum(out[False][2].values()) == 0


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


# ------------------------------------------------------- quantized serving
def _qpool(pk, pv, mode, dev, seed):
    """float pools (numpy, NaN allowed past the lengths) → ``(kd, vd,
    k_scale, v_scale)`` on ``dev``: int8 by the pool's write rule, or e4m3
    by its cast with per-block planes drawn from [0.5, 2)."""
    from paddle_tpu_torch.serving import kv_cache as tkv
    k = torch.from_numpy(np.nan_to_num(pk)).to(dev)
    v = torch.from_numpy(np.nan_to_num(pv)).to(dev)
    if mode == "int8":
        (kd, ks), (vd, vs) = tkv.quantize_kv_rows(k), tkv.quantize_kv_rows(v)
        return kd, vd, ks, vs
    r = np.random.RandomState(seed)
    shape = k.shape[:-3] + k.shape[-2:-1]
    ks, vs = (torch.from_numpy(r.uniform(0.5, 2.0, shape).astype(
        np.float32)).to(dev) for _ in range(2))
    return (tkv.quantize_kv_rows_fp8(k), tkv.quantize_kv_rows_fp8(v), ks,
            vs)


def _steps(got, want, unit=False):
    """Largest distance of two quantized pools, in steps of the grid:
    int8 units, or e4m3 steps (2^-3 of the value's binade); with ``unit``
    the step at each of ``want``'s values instead."""
    g, w = got.float(), want.float()
    ulp = torch.ones_like(w) if got.dtype == torch.int8 else torch.exp2(
        torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -6))) - 3)
    return ulp if unit else ((g - w).abs() / ulp).max().item()


def _tol_ok(got, want, dtype):
    atol, rtol = TOL["bfloat16" if dtype == torch.bfloat16 else "float32"]
    got, want = got.float(), want.float()
    return bool(torch.isfinite(got).all()
                and ((got - want).abs() <= atol + rtol * want.abs()).all())


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
class TestQuantizedKernels:
    @pytest.mark.parametrize("G,D", [(1, 64), (4, 128), (8, 128), (2, 256)])
    def test_paged_decode_quantized_vs_plain(self, cuda_dev, mode, dtype, G,
                                             D):
        """Lengths 1 .. the table, scrambled blocks, sentinel tails; the
        same bits on two launches."""
        q, pk, pv, tables, lengths = _paged(8, 2 * G, 2, D, 24, 32, seed=D)
        lengths[0] = 0
        kd, vd, ks, vs = _qpool(pk, pv, mode, cuda_dev, seed=G)
        qt = torch.from_numpy(q).to(cuda_dev, dtype)
        reset_launches()
        got = tpd.paged_decode_attention(qt, kd, vd, tables, lengths, ks, vs)
        again = tpd.paged_decode_attention(qt, kd, vd, tables, lengths, ks,
                                           vs)
        torch.cuda.synchronize()
        assert LAUNCHES["paged_decode"] == 2
        want = tpd.paged_decode_attention_reference(qt, kd, vd, tables,
                                                    lengths, ks, vs)
        assert torch.equal(got, again)
        assert (got[0] == 0).all()
        assert _tol_ok(got, want, dtype)

    @pytest.mark.parametrize("D", [64, 128, 256, *DIMS])
    @pytest.mark.parametrize("G", [1, 4, 8])
    def test_paged_decode_quantized_split_sweep(self, cuda_dev, mode, dtype,
                                                G, D):
        """The quantized walk over lengths 0, 1, 31, 32, 33, a page +- 1, a
        split +- 1, several splits and 4093 (block 16), scrambled blocks,
        sentinel tails, NaN in the stale rows (e4m3 NaN bytes; int8: NaN
        scales): within TOL, the same bits on a second launch, one launch
        counted per call."""
        B, Hkv, bs, mb = 10, 2, 16, 256
        sms = torch.cuda.get_device_properties(cuda_dev).multi_processor_count
        sl = tpd.split_len(B, Hkv, mb * bs, sms)
        page = split_kv.narrow_page(D)
        lengths = np.array([0, 1, 31, 32, 33, page - 1, page + 1, sl - 1,
                            3 * sl + 5, 4093], np.int32)
        r = np.random.RandomState(G * 10 + D + 1)
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
        kd, vd, ks, vs = _qpool(pk, pv, mode, cuda_dev, seed=G + D)
        for b, n in enumerate(lengths):
            if n % bs:
                blk, row = int(tables[b, n // bs]), int(n % bs)
                if mode == "int8":
                    ks[blk, row:] = float("nan")
                    vs[blk, row:] = float("nan")
                else:
                    kd.view(torch.uint8)[blk, row:] = 0x7F
                    vd.view(torch.uint8)[blk, row:] = 0x7F
        qt = torch.from_numpy(r.randn(B, G * Hkv, D).astype(
            np.float32)).to(cuda_dev, dtype)
        tb, ln = (torch.from_numpy(x).to(cuda_dev) for x in (tables,
                                                             lengths))
        reset_launches()
        got = tpd.paged_decode_attention(qt, kd, vd, tb, ln, ks, vs)
        again = tpd.paged_decode_attention(qt, kd, vd, tb, ln, ks, vs)
        torch.cuda.synchronize()
        assert LAUNCHES["paged_decode"] == 2
        assert tpd.LAST_GRID["split_len"] == sl
        assert torch.equal(got, again)
        want = tpd.paged_decode_attention_reference(qt, kd, vd, tb, ln, ks,
                                                    vs)
        assert (got[0] == 0).all()
        assert _tol_ok(got, want, dtype)

    @pytest.mark.parametrize("G,D", [(1, 64), (4, 128), (2, 256), (2, 16),
                                     (2, 40), (1, 80), (4, 96)])
    def test_ragged_quantized_vs_plain(self, cuda_dev, mode, dtype, G, D):
        """Span-1 rows on the quantized walk, chunks (from mid-block, a
        partial last tile, 500 rows) on the query type's tile: the wgmma
        tile in bf16 (narrow tiles converted in shared memory), the
        CUDA-core tile in float32; the same bits on two launches; rows
        outside every span zero."""
        q, pk, pv, tables, qs, ql, kl = _ragged_spans(SWEEP_SPANS, G, 2, D,
                                                      16, 36, seed=G + D)
        kd, vd, ks, vs = _qpool(pk, pv, mode, cuda_dev, seed=D)
        qt = torch.from_numpy(q).to(cuda_dev, dtype)
        args = (qt, kd, vd, tables, qs, ql, kl)
        got = tra.ragged_paged_attention(*args, k_scale=ks, v_scale=vs)
        again = tra.ragged_paged_attention(*args, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert tra.LAST_GRID["tile_rows"] == tra.TILE_ROWS[dtype]
        assert torch.equal(got, again)
        want = tra.ragged_attention_reference(*args, k_scale=ks, v_scale=vs)
        assert (got[int(ql.sum()):] == 0).all()
        assert _tol_ok(got, want, dtype)

    @pytest.mark.parametrize("w8", [True, False], ids=["w8", "dense"])
    @pytest.mark.parametrize("rows", [4, 21])
    def test_fused_tick_quantized_vs_plain(self, cuda_dev, mode, dtype, w8,
                                           rows, record_property):
        """An int8 or fp8 pool, with int8 or dense weights (``_fused_check``)."""
        _fused_check(cuda_dev, mode, dtype, w8, rows, record_property)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows", [4, 21])
def test_fused_tick_w8_vs_plain(cuda_dev, dtype, rows, record_property):
    """int8 weights on a pool at the model's type: the tick the engine's
    ``fused_tick=True, quantize_weights=True`` launches."""
    _fused_check(cuda_dev, None, dtype, True, rows, record_property)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", [None, "int8"], ids=["pool", "int8"])
@pytest.mark.parametrize("geo", [dict(intermediate_size=320),
                                 dict(hidden_size=320,
                                      num_attention_heads=5,
                                      num_key_value_heads=1)],
                         ids=["inter320", "hidden320"])
def test_fused_tick_w8_odd_tiles_vs_plain(cuda_dev, dtype, mode, geo,
                                          record_property):
    """int8 weights where the bf16 tick's two-tile chunks meet odd
    widths: an intermediate width of 320 (gate/up's plan tile 2 holds a
    gate tile and an up tile of other groups) and a hidden width of 320
    with 5 heads over 1 KV head (QKV and O end in a one-tile chunk);
    float32 keeps one-tile chunks."""
    _fused_check(cuda_dev, mode, dtype, True, 4, record_property, geo=geo)


def _fused_check(cuda_dev, mode, dtype, w8, rows, record_property,
                 geo=None):
    """One fused tick on an int8, fp8 or (``mode`` None) full-precision
    pool, with int8 or dense weights, against its plain version: one
    launch, keys bit for bit, tokens equal in float32, logits within the
    tolerance (``TOL``'s, or on a quantized pool ``QUANT_F32_LOGITS`` of
    the reference's max in float32 and the scaled bf16 bound in bf16),
    the appended values at most one step of the grid apart and an int8
    row's scale within the tolerance; the last layer's attention bit for
    bit the (quantized) paged decode kernel's."""
    from paddle_tpu_torch.serving import decode as tdec
    cfg = llama_tiny(**{**dict(hidden_size=256, num_attention_heads=4,
                               num_key_value_heads=2), **(geo or {})},
                     tie_word_embeddings=w8,
                     dtype=str(dtype).split(".")[-1])
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    m = LlamaForCausalLM(cfg, device="cuda", seed=4)
    p, tied = llama_decode_params(m)
    if w8:
        p = tdec.quantize_decode_params(p, tied)
    r = np.random.RandomState(rows)
    L, bs, D = cfg.num_hidden_layers, 16, cfg.head_dim
    nb = 2 * rows + 2
    pk = r.randn(L, nb, bs, nkv, D).astype(np.float32) * 3
    pv = r.randn(L, nb, bs, nkv, D).astype(np.float32) * 3
    if mode is None:
        kp, vp = (torch.from_numpy(x).to(cuda_dev, dtype) for x in (pk, pv))
    else:
        kd, vd, ks, vs = _qpool(pk, pv, mode, cuda_dev, seed=rows)
        kp, vp = (kd, ks), (vd, vs)
    tables = np.full((rows, 4), nb, np.int32)
    lens = r.randint(0, 32, rows).astype(np.int32)
    app = (np.arange(rows) % 5 != 3).astype(np.int32)
    temps = np.where(np.arange(rows) % 4 == 1, 0.8, 0).astype(np.float32)
    topks = np.where(temps > 0, 5, 0).astype(np.int32)
    for b in range(rows):
        tables[b, :2] = [2 * b, 2 * b + 1]
    keys = r.randint(0, 2 ** 32, (rows, 2), dtype=np.uint64).astype(
        np.int64)
    sin, cos = _rope_tables(64, D, 10000.0, device=cuda_dev)
    tok = torch.from_numpy(r.randint(0, 256, rows)).to(cuda_dev)
    head = tdec._dq_head(p, tied, dtype)
    clone = (lambda x: tuple(y.clone() for y in x)) if mode else (
        lambda x: x.clone())
    outs = []
    for fn in (tft.fused_decode_tick, tft.fused_decode_tick_reference):
        reset_launches()
        with torch.inference_mode():
            out = fn(p, head, tables, torch.from_numpy(tables).to(cuda_dev),
                     sin, cos, tok, clone(kp), clone(vp), lens, keys, app,
                     temps, topks, nh=nh, nkv=nkv, hd=D, eps=1e-5,
                     return_logits=True)
        torch.cuda.synchronize()
        assert LAUNCHES["fused_decode_tick"] == (
            1 if fn is tft.fused_decode_tick else 0)
        outs.append(out)
        if fn is tft.fused_decode_tick:
            q, attn = (tft.LAST_SCRATCH[k].clone() for k in ("q", "attn"))
    (nxt, gk, gv, gkeys, glog), (wnxt, wk, wv, wkeys, wlog) = outs
    assert (_keys_host(gkeys) == _keys_host(wkeys)).all()
    gl, wl = glog.float(), wlog.float()
    rel = ((gl - wl).abs().max() / wl.abs().max()).item()
    record_property("logits_err_of_max_ref", rel)
    if dtype == torch.float32:
        assert nxt.tolist() == wnxt.tolist()
    if mode is None:
        # the weights dequantize to the same values on both sides: the
        # unquantized tick's tolerance (TestServingKernels')
        atol = 1e-4 if dtype == torch.float32 else 3e-2
        for g, w in ((glog, wlog), (gk, wk), (gv, wv)):
            assert (g.float() - w.float()).abs().max().item() <= atol
        want = tpd.paged_decode_attention(q, gk[L - 1], gv[L - 1], tables,
                                          lens + app)
        assert torch.equal(attn, want)
        return
    # the write rule's step is coarser than bf16's rounding: float32
    # logits take QUANT_F32_LOGITS of the reference's max, bf16 the
    # scaled bf16 bound
    if dtype == torch.float32:
        assert rel <= QUANT_F32_LOGITS
    else:
        assert ((gl - wl).abs() <= 0.02 * wl.abs().max()
                + 0.02 * wl.abs()).all()
    for g, w in ((gk, wk), (gv, wv)):
        # the write rule re-rounds the projections' differences to the
        # grid: float32 (last place) one step; bf16 (several bf16 ulps)
        # the scaled bound of the unquantized tick plus a step
        if dtype == torch.float32:
            assert _steps(g[0], w[0]) <= 1
            assert _tol_ok(g[1], w[1], dtype)
        else:
            gv_, wv_ = (x[0].float() * (x[1][..., None] if mode == "int8"
                                        else 1.0) for x in (g, w))
            step = _steps(g[0], w[0], unit=True) * (
                w[1][..., None] if mode == "int8" else 1.0)
            assert ((gv_ - wv_).abs() <= 0.02 * wv_.abs().max()
                    + 0.02 * wv_.abs() + step).all()
    want = tpd.paged_decode_attention(q, gk[0][L - 1], gv[0][L - 1], tables,
                                      lens + app, gk[1][L - 1], gv[1][L - 1])
    assert torch.equal(attn, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode,w8", [(None, False), (None, True),
                                     ("int8", False), ("fp8", True)],
                         ids=["dense", "w8", "int8", "fp8_w8"])
@pytest.mark.parametrize("D", DIMS)
def test_fused_tick_dims_vs_plain(cuda_dev, dtype, mode, w8, D,
                                  record_property):
    """The fused tick at each of DIMS (a QKV group of several heads; a
    tile holding parts of two at 80 and 96; RoPE pairs D/2 apart; the
    walk at the padded width) against its plain version, on a pool of the
    model's type or quantized, with dense or int8 weights
    (``_fused_check``)."""
    hidden, nh, nkv = DIM_GEOS[D]
    _fused_check(cuda_dev, mode, dtype, w8, 21, record_property,
                 geo=dict(hidden_size=hidden, num_attention_heads=nh,
                          num_key_value_heads=nkv))


@pytest.mark.parametrize("knob,kernel", [
    ({}, "paged_decode"), (dict(fused_tick=True), "fused_decode_tick"),
    (dict(paged_attn=False), "decode"), (dict(kv_dtype="int8"),
                                         "paged_decode")],
    ids=["default", "fused_tick", "dense", "kv_int8"])
@pytest.mark.parametrize("D", DIMS)
def test_engines_dims_kernels_vs_plain(cuda_dev, knob, kernel, D):
    """float32 greedy streams of the engines at each of DIMS (2 layers)
    with the kernels equal those with the plain versions (the flag off);
    the engine's own kernel and ragged attention (the default engine's
    flash forward too) ran, and nothing with the flag off."""
    hidden, nh, nkv = DIM_GEOS[D]
    cfg = llama_tiny(hidden_size=hidden, num_attention_heads=nh,
                     num_key_value_heads=nkv, num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, device="cuda", seed=5)
    r = np.random.RandomState(D)
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
            torch.cuda.synchronize()
            launches[use] = dict(LAUNCHES)
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    assert outs[True] == outs[False]
    assert launches[True][kernel] > 0
    if not knob:
        assert launches[True]["flash"] > 0
    if knob.get("paged_attn", True):
        assert launches[True]["ragged_attention"] > 0
    assert not any(launches[False].values())


@pytest.mark.parametrize("knob", [
    dict(kv_dtype="int8"), dict(kv_dtype="fp8"),
    dict(quantize_weights=True),
    dict(quantize_weights=True, quantize_activations=True),
    dict(fused_tick=True, quantize_weights=True),
    dict(fused_tick=True, kv_dtype="int8"),
    dict(fused_tick=True, kv_dtype="int8", quantize_weights=True),
    dict(fused_tick=True, kv_dtype="fp8"),
    dict(fused_tick=True, kv_dtype="fp8", quantize_weights=True),
    dict(decode_ticks=4, kv_dtype="int8"),
    dict(prefix_cache=True, kv_dtype="int8")],
    ids=["kv_int8", "kv_fp8", "w8", "w8_a8", "fused_w8", "fused_int8",
         "fused_int8_w8", "fused_fp8", "fused_fp8_w8", "ticks4_int8",
         "prefix_int8"])
def test_quantized_engines_kernels_vs_plain(cuda_dev, knob):
    """float32 greedy streams of each quantized knob set with the kernels
    equal those with the plain versions (the flag off); the kernels of
    the path ran."""
    cfg = llama_tiny(hidden_size=256, num_attention_heads=4,
                     num_key_value_heads=2)
    model = LlamaForCausalLM(cfg, device="cuda", seed=5)
    r = np.random.RandomState(9)
    pre = r.randint(0, 256, 24).astype(np.int32)
    prompts = [np.concatenate([pre, r.randint(0, 256, n).astype(np.int32)])
               for n in (21, 5, 40)]
    geo = dict(num_slots=4, max_seq_len=128, prefix_block_size=8,
               prefill_chunk=16, headroom_mult=None)
    outs, launches = {}, {}
    try:
        for use in (True, False):
            set_flags({"FLAGS_use_cuda_kernels": use})
            reset_launches()
            eng = ContinuousBatchingEngine(model, **geo, **knob)
            out = []
            for wave in (prompts, prompts[::-1]):
                out += [o.tolist() for o in eng.generate([GenerationRequest(
                    prompt=p, max_new_tokens=12) for p in wave])]
            torch.cuda.synchronize()
            outs[use], launches[use] = out, dict(LAUNCHES)
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    assert outs[True] == outs[False]
    assert not any(launches[False].values())
    assert launches[True]["ragged_attention"] > 0
    fused = knob.get("fused_tick") and not knob.get("quantize_activations")
    assert launches[True]["fused_decode_tick" if fused
                          else "paged_decode"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kv", [None, 4], ids=["mha", "gqa"])
def test_fused_multi_transformer_decode_vs_plain(cuda_dev, dtype, kv):
    """``incubate.nn.FusedMultiTransformer`` at GPT-3 345M's widths (E
    1024, 16 heads of 64, FF 4096), 2 layers, MHA and GQA over 4 KV heads:
    after a 16-row prefill, each one-token step through the dense decode
    kernel (``decode_attention="pallas"``, 2 launches a step) against the
    same step on its masked-softmax path (``"jnp"``) from the same cache:
    hidden states and the appended cache rows within ``TOL``, and the
    same bits on a second launch."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    prev = paddle.get_device()
    paddle.set_device("gpu:0")
    paddle.seed(7)
    try:
        layer = FusedMultiTransformer(1024, 16, 4096, num_layers=2,
                                      kv_num_heads=kv).to(dtype=dtype)
    finally:
        paddle.set_device(prev)
    B, P, steps, s_max = 4, 16, 6, 64
    gen = torch.Generator(device=cuda_dev).manual_seed(3)
    x = torch.randn(B, P + steps, 1024, generator=gen,
                    device=cuda_dev).to(dtype)
    cache = torch.zeros(2, 2, B, s_max, kv or 16, 64, dtype=dtype,
                        device=cuda_dev)
    atol, rtol = TOL["bfloat16" if dtype == torch.bfloat16 else "float32"]
    with torch.no_grad():
        layer(x[:, :P], caches=cache, time_step=0)
        for t in range(P, P + steps):
            outs = {}
            for mode in ("pallas", "pallas", "jnp"):
                layer.decode_attention = mode
                c = cache.clone()
                reset_launches()
                h, c = layer(x[:, t:t + 1], caches=c, time_step=t)
                assert LAUNCHES["decode"] == (2 if mode == "pallas" else 0)
                outs.setdefault(mode, []).append((h, c))
            (h1, c1), (h2, c2) = outs["pallas"]
            hp, cp = outs["jnp"][0]
            assert torch.equal(h1, h2) and torch.equal(c1, c2)
            for got, want in ((h1, hp), (c1[:, :, :, t], cp[:, :, :, t])):
                g, w = got.float(), want.float()
                assert bool(((g - w).abs() <= atol + rtol * w.abs()).all())
            cache = cp
