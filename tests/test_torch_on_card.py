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
``chip_smoke.py``'s ``BWD_TOL``.
"""
import subprocess

import numpy as np
import pytest
import torch

from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.kernels import LAUNCHES, _build, reset_launches
from paddle_tpu_torch.kernels import flash as tflash
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import paged_decode as tpd
from paddle_tpu_torch.kernels import ragged_attention as tra
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

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

    def test_ragged_kernel_vs_plain(self, cuda_dev, dtype, atol):
        args = _ragged(MIXED, 8, 2, 64, 5, 8, seed=2, T=48)
        a = [torch.from_numpy(x).to(cuda_dev) for x in args]
        a = [x.to(dtype) for x in a[:3]] + a[3:]
        got = tra.ragged_paged_attention(*a)
        want = tra.ragged_attention_reference(*a)
        assert (got.float() - want.float()).abs().max().item() <= atol

    def test_flash_kernel_vs_plain(self, cuda_dev, dtype, atol):
        r = np.random.RandomState(0)
        q, k, v = (torch.from_numpy(r.randn(2, 77, h, 64).astype(
            np.float32)).to(cuda_dev, dtype) for h in (8, 2, 2))
        got = tflash.flash_attention(q, k, v, causal=True)
        want = tfa._ref_attention(q, k, v, True)
        assert (got.float() - want.float()).abs().max().item() <= atol


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
