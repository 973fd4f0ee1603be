"""The head dims of the port's kernels, on the CPU: head dim 256 in the
three serving kernels that took D in {64, 128} (the flash forward, ragged
attention, the fused decode tick; ROADMAP Queue C 6), and every D % 8 ==
0 from 8 to 256 in every kernel, the flash backward and the RoPE
pre-pass included (Queue C 7; each runs at its padded width 64, 128 or
256, zero columns past D).

- every kernel's limits and the engine's construction-time check take
  D in {8, 16, 40, 80, 96, 128, 256} and refuse 4, 12, 20 and 264 naming
  Queue C 7 (the rest of the item); the flash backward takes 256;
- the CPU emulations of the kernels' rounding at D = 256 stay within the
  bounds ``chip_smoke.py`` holds the kernels to, against the JAX
  references: the flash forward's 64 x 64 bf16 tiles (the Pallas kernel
  in interpret mode at those blocks), both ragged grids
  (``tests/test_torch_ragged_tc.py``'s emulation) and the fused tick's
  split-K plan (``tests/test_torch_fused_tick_split.py``'s);
- the plain flash backward at D = 256 and 80, with and without RoPE,
  within 2e-4 of the JAX Pallas backward in interpret mode;
- engines with 2 layers and 2 query heads over one KV head stream as the
  JAX engine does, in fp32, at D = 256, 40, 80 and 96: the default,
  ``fused_tick=True`` and ``paged_attn=False`` engines (streams, finish
  reasons, and at the new dims the step counters), each JAX run held in
  a module cache keyed by head dim and knobs.
"""
import math

import jax
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
from paddle_tpu_torch.kernels._launch import check_head_dim
from paddle_tpu_torch.kernels.flash_attention import _ref_attention, _ref_lse
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           load_decode_params)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)
from paddle_tpu_torch.serving import engine as sengine
from torch_threads import one_torch_thread  # noqa: F401

#: head dims the kernels take (a sample: any D % 8 == 0 from 8 to 256)
ACCEPTED = (8, 16, 40, 80, 96, 128, 256)
#: head dims they refuse, naming ROADMAP Queue C 7: not a multiple of 8,
#: or past 256
REFUSED = (4, 12, 20, 264)


def _meta(*shape):
    return torch.zeros(*shape, device="meta")


def _bwd_limits(h, hkv, d):
    """The backward entries' own check (``_check_bwd``) on meta tensors."""
    q, kv = _meta(1, 8, h, d), _meta(1, 8, hkv, d)
    stats = torch.zeros(1, h, 8, device="meta")
    return tflash._check_bwd("flash_bwd_dq", q, kv, kv, q, stats, stats)


#: the kernels' own checks: (H, Hkv, D) -> raises or returns
KERNEL_LIMITS = {
    "ragged": lambda h, hkv, d: tra.check_limits(h, hkv, d),
    "fused": lambda h, hkv, d: tft.check_limits(h, hkv, d, 512, 512, 256),
    "paged": lambda h, hkv, d: tpd.check_limits(h, hkv, d),
    "dense": lambda h, hkv, d: tdec.check_limits(h, hkv, d),
    "flash": lambda h, hkv, d: tflash._check_shapes(
        "flash", *(_meta(1, 8, n, d) for n in (h, hkv, hkv))),
    "flash_backward": _bwd_limits,
}


@pytest.mark.parametrize("kernel", list(KERNEL_LIMITS))
def test_kernel_limits_take_256_and_refuse_queue_c7_dims(kernel):
    """Each kernel's limits take every D in ACCEPTED (8 query heads over 4
    KV heads: a QKV width of 16 D, which the fused tick takes) and refuse
    every D in REFUSED, naming Queue C 7."""
    check = KERNEL_LIMITS[kernel]
    for d in ACCEPTED:
        check(8, 4, d)
    for d in REFUSED:
        with pytest.raises(NotImplementedError, match="Queue C 7"):
            check(8, 4, d)


def test_flash_backward_refuses_256():
    """Since Queue C 7 the backward entries take 256 (the name recalls
    what they refused before) and refuse D % 8 != 0 naming the item; a
    forward autograd will differentiate at 256 is no longer refused at
    the attention call (it reaches the device check: meta tensors are
    refused as off the card), nor is the RoPE pre-pass's dim."""
    m = _meta(1, 8, 2, 256)
    stats = torch.zeros(1, 2, 8, device="meta")
    assert tflash._check_bwd("flash_bwd_dq", m, m, m, m, stats,
                             stats)[-1] == 256
    odd = _meta(1, 8, 2, 12)
    with pytest.raises(NotImplementedError, match="head_dim 12.*Queue C 7"):
        tflash._check_bwd("flash_bwd_dq", odd, odd, odd, odd, stats, stats)
    g = torch.zeros(1, 8, 2, 256, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention(g, g, g)
    with torch.no_grad(), pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention(g, g, g)
    assert tflash._check_shapes("flash", m, m, m)[-1] == 256
    check_head_dim("rope_qk", 256)
    with pytest.raises(NotImplementedError, match="rope_qk.*Queue C 7"):
        check_head_dim("rope_qk", 260)


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
    """With the kernels on, each engine constructs at every head dim in
    ACCEPTED (8 query heads over 4 KV heads: widths the fused tick takes)
    and raises at construction, naming Queue C 7, at every one in
    REFUSED."""
    monkeypatch.setattr(sengine, "_kernels_on", lambda params, config: True)
    for d in ACCEPTED + REFUSED:
        m = LlamaForCausalLM(_cfg(d, hidden_size=8 * d,
                                  num_attention_heads=8,
                                  num_key_value_heads=4),
                             device="cpu", seed=0)
        if d in ACCEPTED:
            ContinuousBatchingEngine(m, **GEOMETRY, **knob)
            continue
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


# --------------------------------------- engines at D = 40, 80, 96, fp32
#: the step counters both engines keep, equal when their schedules are
STATS = ("steps", "decode_calls", "decode_steps", "prefills",
         "prefill_tokens", "prefill_chunks", "unified_steps",
         "tokens_generated", "preemptions")
_DIM_MODELS = {}


def _dim_models(hd):
    """The JAX model (jnp attention) and the port's, with its weights, at
    2 layers of 2 query heads of ``hd`` over 1 KV head, built once a
    module."""
    if hd not in _DIM_MODELS:
        paddle.seed(hd)
        kw = dict(hidden_size=2 * hd, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=2,
                  num_key_value_heads=1)
        jm = JLlama(j_tiny(decode_attention="jnp", **kw))
        p, tied = llama_decode_params(jm)
        tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
        load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()},
                           tied)
        _DIM_MODELS[hd] = jm, tm
    return _DIM_MODELS[hd]


def _run(eng, Request):
    outs = eng.generate([Request(**r) for r in _matrix()])
    return ([o.tolist() for o in outs], [o.finish_reason for o in outs],
            {k: eng.stats[k] for k in STATS})


@pytest.mark.parametrize("knob", [{}, dict(fused_tick=True),
                                  dict(paged_attn=False)],
                         ids=["default", "fused", "dense"])
@pytest.mark.parametrize("hd", [40, 80, 96])
def test_engine_at_dims_streams_as_jax(hd, knob):
    """Greedy and seeded streams, finish reasons and step counters of the
    port's engine at head dims 40 (D % 16 == 8), 80 and 96 equal the JAX
    engine's with the same knobs (one JAX run a head dim and knob set)."""
    jm, tm = _dim_models(hd)
    geo = dict(GEOMETRY, **knob)
    key = (hd,) + tuple(sorted(knob))
    if key not in _JAX:
        _JAX[key] = _run(JEngine(jm, **geo, jit_cache={}), JRequest)
    assert _run(ContinuousBatchingEngine(tm, **geo),
                GenerationRequest) == _JAX[key]


# ------------------------------ the flash backward at D = 256 and 80
def _tables(S, D, theta=10000.0):
    inv = 1.0 / (theta ** (np.arange(0, D, 2, dtype=np.float32) / D))
    emb = np.outer(np.arange(S, dtype=np.float32), inv)
    emb = np.concatenate([emb, emb], axis=-1)
    return np.sin(emb), np.cos(emb)


@pytest.fixture
def _interpret():
    jflash._FORCE_INTERPRET[0] = True
    yield
    jflash._FORCE_INTERPRET[0] = False


@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("D", [256, 80])
def test_flash_backward_at_dims_matches_jax_pallas(_interpret, D, rope):
    """The port's plain flash backward (the kernels' CPU route: the
    ``rope_qk`` pre-pass's plain version, both halves on the rotated
    pair, the adjoint on the float32 dQ and dK) against the JAX Pallas
    backward (``flash_attention_bhsd``, interpret mode, one block a head)
    within 2e-4, at D = 256 and 80, 4 query heads over 2 KV heads, S =
    40."""
    B, H, Hk, S = 1, 4, 2, 40
    r = np.random.RandomState(D + rope)
    q, k, v, do = (r.randn(B, h, S, D).astype(np.float32) * 0.5
                   for h in (H, Hk, Hk, H))
    sin, cos = _tables(S, D)
    G = H // Hk
    fold = lambda x: jnp.asarray(x).reshape(-1, S, D)       # noqa: E731
    rep = lambda x: np.repeat(x, G, axis=1)                  # noqa: E731
    jrope = (jnp.asarray(sin), jnp.asarray(cos)) if rope else None

    def f(q_, k_, v_):
        return jflash.flash_attention_bhsd(q_, k_, v_, causal=True,
                                           block_q=S, block_k=S, rope=jrope)

    _, vjp = jax.vjp(f, fold(q), fold(rep(k)), fold(rep(v)))
    gq, gk, gv = vjp(fold(do))
    back = lambda g: np.asarray(g).reshape(B, Hk, G, S, D).sum(2)  # noqa
    want = (np.asarray(gq).reshape(B, H, S, D), back(gk), back(gv))
    tq, tk, tv, tdo = (torch.from_numpy(x).transpose(1, 2)
                       for x in (q, k, v, do))
    trope = (torch.from_numpy(sin), torch.from_numpy(cos)) if rope else None
    o, lse = tflash.flash_attention_fwd(tq, tk, tv, True, trope)
    got = tflash.flash_attention_bwd(tq, tk, tv, o, lse, tdo, True, trope)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w, rtol=2e-4,
                                   atol=2e-4)
