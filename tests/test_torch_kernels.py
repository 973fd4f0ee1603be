"""Parity of the port's attention kernels (``paddle_tpu_torch/kernels``)
with the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode (the JAX package's own CPU
setting) and its jnp reference. Inputs come from a numpy seed and go to
both sides as the same arrays. Tolerance: max-abs <= 1e-5 in float32 —
the two sides sum in different orders, nothing else differs.

The CUDA kernels themselves run only on a GPU: ``test_torch_on_card.py``
holds each against its plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels import pallas_flash as jflash
from paddle_tpu.kernels.pallas_decode import \
    decode_attention_reference as j_decode_ref
from paddle_tpu.kernels.pallas_paged_decode import (
    paged_decode_attention_pallas, paged_decode_attention_reference)
from paddle_tpu.kernels.pallas_ragged_attention import (
    ragged_attention_reference, ragged_paged_attention_pallas)
from paddle_tpu_torch.kernels import LAUNCHES, _build, reset_launches
from paddle_tpu_torch.kernels import flash as tflash
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import paged_decode as tpd
from paddle_tpu_torch.kernels import ragged_attention as tra
from torch_threads import one_torch_thread  # noqa: F401


ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = float(np.max(np.abs(got - np.asarray(want)))) if got.size else 0.0
    assert err <= atol, err


def _paged(B, H, Hkv, D, mb, bs, seed, lengths=None, sentinel_tail=True,
           nan_stale=False):
    """Pool + scrambled tables (+ sentinel tails past each row's blocks)."""
    r = np.random.RandomState(seed)
    nb = B * mb + 2
    q = r.randn(B, H, D).astype(np.float32)
    pk = r.randn(nb, bs, Hkv, D).astype(np.float32)
    pv = r.randn(nb, bs, Hkv, D).astype(np.float32)
    tables = r.permutation(B * mb).reshape(B, mb).astype(np.int32)
    if lengths is None:
        lengths = r.randint(1, mb * bs + 1, B)
    lengths = np.asarray(lengths, np.int32)
    if sentinel_tail:
        for b in range(B):
            tables[b, -(-int(lengths[b]) // bs):] = nb     # unmapped
    if nan_stale:
        for b in range(B):
            L = int(lengths[b])
            if L % bs and L > 0:
                blk = tables[b, L // bs]
                pk[blk, L % bs:] = np.nan
                pv[blk, L % bs:] = np.nan
    return q, pk, pv, tables, lengths


# ------------------------------------------------------------ paged decode
class TestPagedDecode:
    @pytest.mark.parametrize("B,H,Hkv,D,mb,bs", [
        (3, 4, 2, 32, 4, 8),      # GQA group 2
        (2, 4, 4, 16, 3, 16),     # MHA
        (4, 8, 1, 16, 2, 8),      # MQA
    ])
    def test_matches_pallas_interpret_and_reference(self, B, H, Hkv, D, mb,
                                                    bs):
        q, pk, pv, tbl, lens = _paged(B, H, Hkv, D, mb, bs, seed=B + H)
        got = tpd.paged_decode_attention(_t(q), _t(pk), _t(pv), _t(tbl),
                                         _t(lens))
        args = tuple(jnp.asarray(a) for a in (q, pk, pv, tbl, lens))
        _close(got, paged_decode_attention_pallas(*args))
        _close(got, paged_decode_attention_reference(*args))

    def test_dead_rows_and_stale_nan(self):
        """A length-0 row returns zeros (not NaN); NaN in pool rows past a
        row's length never reaches the output."""
        q, pk, pv, tbl, lens = _paged(4, 4, 2, 16, 3, 8, seed=5,
                                      lengths=[0, 5, 17, 0], nan_stale=True)
        got = tpd.paged_decode_attention(_t(q), _t(pk), _t(pv), _t(tbl),
                                         _t(lens))
        assert torch.isfinite(got).all()
        assert (got[0] == 0).all() and (got[3] == 0).all()
        want = paged_decode_attention_reference(
            *(jnp.asarray(a) for a in (q, pk, pv, tbl, lens)))
        _close(got, want)

    def test_dense_helper_matches_jax(self):
        r = np.random.RandomState(3)
        q = r.randn(3, 4, 16).astype(np.float32)
        k = r.randn(3, 20, 2, 16).astype(np.float32)
        v = r.randn(3, 20, 2, 16).astype(np.float32)
        lens = np.array([20, 7, 1], np.int32)
        _close(tpd.decode_attention_reference(_t(q), _t(k), _t(v),
                                              _t(lens)),
               j_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lens)))


# ------------------------------------------------------- ragged attention
def _ragged(spans, H, Hkv, D, mb, bs, seed, T=None):
    """spans: [(qlen, kvlen)] per sequence, packed back to back; T pads
    the packed buffer with rows outside every span."""
    r = np.random.RandomState(seed)
    R = len(spans)
    qlen = np.array([s[0] for s in spans], np.int32)
    kvlen = np.array([s[1] for s in spans], np.int32)
    qstart = np.concatenate([[0], np.cumsum(qlen)[:-1]]).astype(np.int32)
    T = int(T or qlen.sum())
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


class TestRaggedAttention:
    @pytest.mark.parametrize("H,Hkv,D,mb,bs", [
        (4, 2, 16, 5, 8),         # GQA group 2
        (4, 4, 32, 3, 16),        # MHA
        (4, 1, 16, 5, 8),         # MQA
    ])
    def test_matches_pallas_interpret_and_reference(self, H, Hkv, D, mb,
                                                    bs):
        spans = [(min(q, mb * bs), min(k, mb * bs)) for q, k in MIXED]
        args = _ragged(spans, H, Hkv, D, mb, bs, seed=H + bs, T=32)
        got = tra.ragged_paged_attention(*(_t(a) for a in args))
        jargs = tuple(jnp.asarray(a) for a in args)
        _close(got, ragged_paged_attention_pallas(*jargs))
        _close(got, ragged_attention_reference(*jargs))

    def test_rows_outside_spans_are_zero(self):
        args = _ragged(MIXED, 4, 2, 16, 5, 8, seed=1, T=40)
        got = tra.ragged_paged_attention(*(_t(a) for a in args))
        used = int(np.sum(args[5]))
        assert (got[used:] == 0).all()
        assert torch.isfinite(got).all()

    def test_span1_rows_equal_paged_decode(self):
        """A span-1 row is the paged decode row of the same length."""
        q, pk, pv, tbl, lens = _paged(5, 4, 2, 16, 3, 8, seed=9)
        qstart = np.arange(5, dtype=np.int32)
        one = np.ones(5, np.int32)
        got = tra.ragged_paged_attention(_t(q), _t(pk), _t(pv), _t(tbl),
                                         _t(qstart), _t(one), _t(lens))
        want = tpd.paged_decode_attention(_t(q), _t(pk), _t(pv), _t(tbl),
                                          _t(lens))
        _close(got, want.numpy())


# ------------------------------------------------------------------- flash
class TestFlash:
    @pytest.mark.parametrize("B,S,H,Hk,D", [
        (2, 37, 4, 2, 16),        # non-pow2 S, GQA
        (1, 64, 4, 4, 32),        # MHA, one full tile
        (2, 5, 2, 1, 16),         # tiny S, MQA
    ])
    def test_causal_matches_pallas_interpret_and_reference(self, B, S, H,
                                                           Hk, D):
        r = np.random.RandomState(S + H)
        q = r.randn(B, S, H, D).astype(np.float32)
        k = r.randn(B, S, Hk, D).astype(np.float32)
        v = r.randn(B, S, Hk, D).astype(np.float32)
        got = tfa.attention(_t(q), _t(k), _t(v), causal=True)
        jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        _close(got, jflash.flash_attention_pallas(jq, jk, jv, causal=True))
        _close(got, jfa._ref_attention(jq, jk, jv, True))

    def test_lse_matches_pallas_forward(self):
        """The forward's log-sum-exp equals the Pallas ``_flash_fwd``'s."""
        r = np.random.RandomState(0)
        B, S, H, D = 1, 24, 2, 16
        q = r.randn(B, S, H, D).astype(np.float32)
        k = r.randn(B, S, H, D).astype(np.float32)
        v = r.randn(B, S, H, D).astype(np.float32)
        out, lse = tflash.flash_attention_fwd(_t(q), _t(k), _t(v), True)

        def fold(x):
            return jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(B * H, S, D)
        o_j, lse_j = jflash._flash_fwd(fold(q), fold(k), fold(v),
                                       1.0 / np.sqrt(D), True, S, S, True)
        _close(lse.reshape(B * H, S), np.asarray(lse_j)[..., 0])
        _close(out.permute(0, 2, 1, 3).reshape(B * H, S, D), o_j)


# -------------------------------------------------------------- wrappers
class TestWrappers:
    def test_cpu_tensors_take_plain_versions_without_counting(self):
        reset_launches()
        q, pk, pv, tbl, lens = _paged(2, 4, 2, 16, 2, 8, seed=2)
        tpd.paged_decode_attention(_t(q), _t(pk), _t(pv), _t(tbl), _t(lens))
        assert LAUNCHES == {"flash": 0, "paged_decode": 0,
                            "ragged_attention": 0, "flash_bwd_dkv": 0,
                            "flash_bwd_dq": 0, "decode": 0,
                            "fused_decode_tick": 0, "flash[rope]": 0,
                            "flash_bwd_dkv[rope]": 0,
                            "flash_bwd_dq[rope]": 0, "rope_qk": 0}

    @pytest.mark.parametrize("which", ["paged", "ragged", "flash"])
    def test_other_devices_raise(self, which):
        """A tensor neither on the CPU nor on a CUDA device is refused —
        no wrapper quietly computes elsewhere."""
        m = torch.zeros(2, 4, 16, device="meta")
        with pytest.raises(ValueError):
            if which == "paged":
                tpd.paged_decode_attention(m, m, m, None, None)
            elif which == "ragged":
                tra.ragged_paged_attention(m, m, m, None, None, None, None)
            else:
                tflash.flash_attention(m[None], m[None], m[None])

    def test_failed_build_raises(self, tmp_path, monkeypatch):
        """A kernel whose compile fails raises; there is no fallback."""
        monkeypatch.setenv("PADDLE_TPU_TORCH_BUILD_DIR", str(tmp_path))
        monkeypatch.setenv("NVCC", "false")
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _build.build_all(["flash"])
        assert not list(tmp_path.glob("*.so"))

    def test_library_named_by_source_hash(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_TORCH_BUILD_DIR", str(tmp_path))
        paths = {n: _build.library_path(n) for n in _build.LIBRARIES}
        # eight kernels in thirteen libraries: the fused tick's source
        # builds once a (pool mode, weights) variant, the backward source
        # once an entry, the backward's RoPE pre-pass from its own source
        assert len(set(paths.values())) == 13
        assert _build.LIBRARIES["rope_qk"] == ("rope_qk", ())
        for n, p in paths.items():
            assert p.parent == tmp_path and p.name.startswith(n + "-")
            assert p == _build.library_path(n)          # deterministic
        # both backward kernels live in one source, one library each
        assert _build.library_path("flash_bwd_dkv") == \
            paths["flash_bwd_dkv"] != paths["flash_bwd_dq"]
        assert {_build.LIBRARIES[n] for n in ("flash_bwd_dkv",
                                              "flash_bwd_dq")} == {
            ("flash_bwd", ("-DFLASH_BWD_ENTRY=1",)),
            ("flash_bwd", ("-DFLASH_BWD_ENTRY=2",))}
        fused = [n for n in _build.LIBRARIES if n.startswith("fused")]
        assert len(fused) == 6 and {
            _build.LIBRARIES[n][0] for n in fused} == {"fused_decode_tick"}
        # one source, six macro sets: each variant its own entry point
        assert len({_build.LIBRARIES[n][1] for n in fused}) == 6
        assert all(f"-DFT_ENTRY={_build.SIGNATURES[n][1]}"
                   in _build.LIBRARIES[n][1] for n in fused)

    def test_nonzero_cuda_status_raises(self):
        _build.check("flash", 0)
        with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
            _build.check("flash", 1)
