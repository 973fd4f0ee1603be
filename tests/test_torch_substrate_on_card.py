"""The substrate's ``F.flash_attention`` on the flash kernels, on a GPU:
causal and not, bf16, fp16 and fp32, at a length that is and one that is
not a multiple of the kernels' 64-row tiles, against the plain versions
(``FLAGS_use_cuda_kernels`` off) within ``chip_smoke.py``'s ``TOL`` (O)
and ``BWD_TOL`` (dQ, dK, dV); each call launches one forward, one dK/dV
and one dQ kernel of its mode (``name`` causal, ``name:full`` not); a
float16 input reaches the kernels (ROADMAP.md Queue C 8, done: it used to
raise before any launch). Every test is ``cuda``-marked
and skips without a CUDA device and ``nvcc``. The file imports neither
JAX nor ``paddle_tpu``; on the card::

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_substrate_on_card.py
"""
import subprocess

import pytest
import torch

from chip_smoke import BWD_TOL, TOL
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.kernels import LAUNCHES, _build, reset_launches
from paddle_tpu_torch.nn import functional as F

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


def _run(q, k, v, do, causal):
    qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out, none = F.flash_attention(*qkv, causal=causal)
    grads = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    assert none is None
    return (out.detach(),) + grads


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("S,Hk", [(256, 4), (200, 2)])
def test_flash_attention_kernels_against_plain(cuda_dev, S, Hk, dtype,
                                               causal):
    gen = torch.Generator(device=cuda_dev).manual_seed(S + Hk)
    dt = getattr(torch, dtype)
    mk = lambda h: torch.randn(2, S, h, 64, generator=gen,  # noqa: E731
                               device=cuda_dev).to(dt)
    q, k, v, do = mk(4), mk(Hk), mk(Hk), mk(4)
    reset_launches()
    got = _run(q, k, v, do, causal)
    sfx = "" if causal else ":full"
    assert {n: c for n, c in LAUNCHES.items() if c} == {
        "flash" + sfx: 1, "flash_bwd_dkv" + sfx: 1, "flash_bwd_dq" + sfx: 1}
    again = _run(q, k, v, do, causal)
    set_flags({"FLAGS_use_cuda_kernels": False})
    try:
        want = _run(q, k, v, do, causal)
    finally:
        set_flags({"FLAGS_use_cuda_kernels": True})
    if dtype != "float32":
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    atol, rtol = TOL[dtype]
    o, w = got[0].float(), want[0].float()
    assert bool(((o - w).abs() <= atol + rtol * w.abs()).all())
    atol, rtol = BWD_TOL[dtype]
    for g, w in zip(got[1:], want[1:]):
        g, w = g.float(), w.float()
        assert bool(((g - w).abs() <= atol * w.abs().max()
                     + rtol * w.abs()).all())


def test_flash_attention_float16_launches_the_kernel(cuda_dev):
    """Queue C 8 is done: float16 no longer raises; a forward launches the
    flash forward kernel, as the other types do."""
    q = torch.randn(1, 64, 2, 64, device=cuda_dev, dtype=torch.float16)
    reset_launches()
    out, _ = F.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert out.dtype == torch.float16 and bool(torch.isfinite(out).all())
    assert {n: c for n, c in LAUNCHES.items() if c} == {"flash:full": 1}
