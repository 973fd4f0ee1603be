"""Head dim 256 in the three serving kernels that took D in {64, 128}
(the flash forward, ragged attention, the fused decode tick; ROADMAP
Queue C 6), and the dims the kernels still refuse (Queue C 7), on the CPU.

- every kernel's limits and the engine's construction-time check take
  D = 256 and refuse 16, 32, 80 and 96 naming Queue C 7; the flash
  backward (and so a forward autograd will differentiate) refuses 256;
- the CPU emulations of the kernels' rounding at D = 256 stay within the
  bounds ``chip_smoke.py`` holds the kernels to, against the JAX
  references: the flash forward's 64 x 64 bf16 tiles (the Pallas kernel
  in interpret mode at those blocks), both ragged grids
  (``tests/test_torch_ragged_tc.py``'s emulation) and the fused tick's
  split-K plan (``tests/test_torch_fused_tick_split.py``'s);
- engines with 2 layers and 2 query heads of 256 over one KV head stream
  as the JAX engine does, in fp32: the default, ``fused_tick=True`` and
  ``paged_attn=False`` engines.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import test_torch_fused_tick_split as fts
import test_torch_ragged_tc as trt
from chip_smoke import TOL
from paddle_tpu.kernels import pallas_flash as jflash
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving.decode import llama_decode_params
from paddle_tpu_torch.kernels import decode as tdec
from paddle_tpu_torch.kernels import flash as tflash
from paddle_tpu_torch.kernels import fused_decode_tick as tft
from paddle_tpu_torch.kernels import paged_decode as tpd
from paddle_tpu_torch.kernels import ragged_attention as tra
from paddle_tpu_torch.kernels.flash_attention import _ref_attention, _ref_lse
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           load_decode_params)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)
from paddle_tpu_torch.serving import engine as sengine

REFUSED = (16, 32, 80, 96)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (its engines run many
    small eager ops; parallel workers with full pools oversubscribe)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the kernels' own checks: (H, Hkv, D) -> raises or returns
KERNEL_LIMITS = {
    "ragged": lambda h, hkv, d: tra.check_limits(h, hkv, d),
    "fused": lambda h, hkv, d: tft.check_limits(h, hkv, d, 512, 512, 256),
    "paged": lambda h, hkv, d: tpd.check_limits(h, hkv, d),
    "dense": lambda h, hkv, d: tdec.check_limits(h, hkv, d),
    "flash": lambda h, hkv, d: tflash._check_shapes(
        "flash", *(torch.zeros(1, 8, n, d, device="meta")
                   for n in (h, hkv, hkv))),
}


@pytest.mark.parametrize("kernel", list(KERNEL_LIMITS))
def test_kernel_limits_take_256_and_refuse_queue_c7_dims(kernel):
    check = KERNEL_LIMITS[kernel]
    check(2, 1, 256)
    check(8, 4, 128)
    for d in REFUSED:
        with pytest.raises(NotImplementedError, match="Queue C 7"):
            check(2, 1, d)


def test_flash_backward_refuses_256():
    """The backward entries keep {64, 128}; so does a forward whose inputs
    autograd will differentiate (raised at the attention call, before the
    forward runs) and the RoPE pre-pass; a forward without grad takes
    256."""
    m = torch.zeros(1, 8, 2, 256, device="meta")
    with pytest.raises(NotImplementedError, match="head_dim 256.*Queue C 7"):
        tflash._check_bwd("flash_bwd_dq", m, m, m, m, None, None)
    g = torch.zeros(1, 8, 2, 256, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError,
                       match="flash backward kernel: head_dim 256"):
        tflash.flash_attention(g, g, g)
    with torch.no_grad(), pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention(g, g, g)     # past the check: meta refused
    assert tflash._check_shapes("flash", m, m, m)[-1] == 256
    assert 256 in tflash.HEAD_DIMS and 256 not in tflash.BWD_HEAD_DIMS


def _cfg(hd, **kw):
    """A one-layer tiny model with 2 query heads of ``hd`` over 1 KV
    head."""
    g = dict(num_hidden_layers=1, hidden_size=2 * hd, num_attention_heads=2,
             num_key_value_heads=1, intermediate_size=128)
    g.update(kw)
    return llama_tiny(**g)


GEOMETRY = dict(num_slots=2, max_seq_len=64, decode_chunk=1,
                prefix_block_size=8, prefill_chunk=16, headroom_mult=None)


@pytest.mark.parametrize("knob", [{}, dict(fused_tick=True),
                                  dict(paged_attn=False)],
                         ids=["default", "fused", "dense"])
def test_engine_limits_take_256_and_refuse_the_rest(monkeypatch, knob):
    """With the kernels on, each engine constructs at head dim 256 and
    raises at construction, naming Queue C 7, at 16, 32, 80 and 96."""
    monkeypatch.setattr(sengine, "_kernels_on", lambda params, config: True)
    m = LlamaForCausalLM(_cfg(256), device="cpu", seed=0)
    ContinuousBatchingEngine(m, **GEOMETRY, **knob)
    for d in REFUSED:
        m = LlamaForCausalLM(_cfg(d), device="cpu", seed=0)
        with pytest.raises(NotImplementedError, match="Queue C 7"):
            ContinuousBatchingEngine(m, **GEOMETRY, **knob)


# --------------------------------------------------- the tiles at D = 256
@pytest.mark.parametrize("S", [128, 300])
def test_flash_tiles_at_256_within_tol(S):
    """The bf16 forward's 64 x 64 tiles (the Pallas forward in interpret
    mode at those blocks, bf16) within TOL of the plain version at D =
    256, causal, 2 heads; the LSE within fp32 TOL."""
    B, H, D = 1, 2, 256
    r = np.random.RandomState(S + 1)
    q, k, v = (r.randn(B, S, H, D).astype(np.float32) for _ in range(3))

    def heads_first(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D),
                           jnp.bfloat16)

    def seq_first(x):
        a = np.asarray(jnp.asarray(x, jnp.float32)).reshape(B, H, S, -1)
        return torch.from_numpy(a.transpose(0, 2, 1, 3).copy())

    o, lse = jflash._flash_fwd(heads_first(q), heads_first(k),
                               heads_first(v), 1.0 / math.sqrt(D), True,
                               64, 64, True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want_o = _ref_attention(tq, tk, tv, True).float()
    got_o = seq_first(o)
    atol, rtol = TOL["bfloat16"]
    assert torch.isfinite(got_o).all()
    assert ((got_o - want_o).abs() <= atol + rtol * want_o.abs()).all()
    got_lse = seq_first(lse)[..., 0].transpose(1, 2)
    want_lse = _ref_lse(tq, tk, True)
    atol, rtol = TOL["float32"]
    assert ((got_lse - want_lse).abs() <= atol + rtol * want_lse.abs()).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("G", [1, 4])
def test_ragged_grids_at_256_within_tol(G, dtype):
    """Both ragged grids emulated at D = 256 (split-KV span-1 rows; chunk
    spans with P rounded per 64-key tile in bf16, 32 in fp32) within TOL
    of the JAX ``ragged_attention_reference``."""
    trt.test_emulation_within_tol_of_jax_reference(G, 256, dtype)


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def wide_head_model(request):
    """``llama_tiny`` at hidden 512 as 2 query heads of 256 over 1 KV head,
    2 layers, bf16."""
    paddle.seed(17)
    jm = JLlama(j_tiny(hidden_size=512, intermediate_size=512,
                       num_hidden_layers=2, num_attention_heads=2,
                       num_key_value_heads=1, dtype="bfloat16",
                       tie_word_embeddings=request.param))
    return llama_decode_params(jm)


@pytest.mark.parametrize("grid, w8", [(5, False), (396, False), (5, True)],
                         ids=["5", "396", "5-w8"])
def test_fused_tick_at_256_within_scaled_bf16_bound(wide_head_model, grid,
                                                    w8, monkeypatch):
    """The fused tick's split-K plan and walk emulated at D = 256 (a QKV
    head of 4 tiles, RoPE pairs 128 columns apart) within the scaled bf16
    bound of the JAX reference tick: the fused-tick split test's body at
    this geometry."""
    for name, value in (("NH", 2), ("NKV", 1), ("HD", 256),
                        ("HIDDEN", 512), ("INTER", 512)):
        monkeypatch.setattr(fts, name, value)
    fts.test_emulation_within_scaled_bf16_bound_of_jax_reference(
        wide_head_model, grid, w8, monkeypatch)


# ------------------------------------------------ engines at D = 256, fp32
@pytest.fixture(scope="module")
def wide_models():
    paddle.seed(5)
    kw = dict(hidden_size=512, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=2, num_key_value_heads=1)
    jm = JLlama(j_tiny(decode_attention="jnp", **kw))
    p, tied = llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


_JAX = {}


def _matrix():
    r = np.random.RandomState(9)
    return [dict(prompt=r.randint(0, 256, n).astype(np.int32),
                 max_new_tokens=8, **kw)
            for n, kw in ((5, {}), (23, {}),
                          (11, dict(temperature=0.8, top_k=5, seed=7)))]


@pytest.mark.parametrize("knob", [{}, dict(fused_tick=True),
                                  dict(paged_attn=False)],
                         ids=["default", "fused", "dense"])
def test_engine_at_256_streams_as_jax(wide_models, knob):
    """Greedy and seeded streams and finish reasons of the port's engine
    at head dim 256 equal the JAX engine's with the same knobs."""
    jm, tm = wide_models
    geo = dict(GEOMETRY, **knob)
    key = tuple(sorted(knob))
    if key not in _JAX:
        eng = JEngine(jm, **geo, jit_cache={})
        outs = eng.generate([JRequest(**r) for r in _matrix()])
        _JAX[key] = ([o.tolist() for o in outs],
                     [o.finish_reason for o in outs])
    outs = ContinuousBatchingEngine(tm, **geo).generate(
        [GenerationRequest(**r) for r in _matrix()])
    assert ([o.tolist() for o in outs],
            [o.finish_reason for o in outs]) == _JAX[key]
