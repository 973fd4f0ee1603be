"""``llama_13b`` in the port against the JAX package's, on the CPU:

- ``llama_13b()`` equals the reference's config field by field (hidden
  5120, FFN 13824, 40 layers, 40 query heads over 40 KV heads of 128),
  with keywords passed through, and refuses a layer count as the
  reference does (its overrides fix the depth);
- engines at a 40-over-40 head geometry, narrow (40 heads of 8, hidden
  320, FFN 864: 13B's FFN-to-hidden ratio) and 2 layers deep, stream as
  the JAX engine does in fp32 — the default, ``fused_tick=True`` and
  ``paged_attn=False`` engines (greedy and seeded streams, finish reasons,
  step counters), as ``tests/test_torch_head_dims.py`` holds other head
  geometries;
- the kernels' limits and plans take 13B's widths: the fused tick's
  ``check_limits``, its split-K plan (every plan tile's pieces within the
  ``part_slots`` bound the pieces' buffer is sized by, at 13B's five
  projections), its barrier groups, the split-KV plan at 8 rows of 40 KV
  heads, and the split-KV tickets past the 256 a 32-head geometry used.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_13b as j13b
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving.decode import llama_decode_params
from paddle_tpu_torch.kernels import fused_decode_tick as tft
from paddle_tpu_torch.kernels import split_kv
from paddle_tpu_torch.models import llama_13b
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           load_decode_params)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      GenerationRequest)
from test_torch_fused_tick_split import _pieces
from test_torch_head_dims import GEOMETRY, STATS, _matrix
from torch_threads import one_torch_thread  # noqa: F401

#: 13B's head geometry and widths
H, HKV, D, HIDDEN, FFN, LAYERS, VOCAB = 40, 40, 128, 5120, 13824, 40, 32000
#: the card's SMs (H100 SXM) and the fused tick's blocks on it
H100_SMS = 132


@pytest.mark.parametrize("kw", [{}, dict(dtype="bfloat16"),
                                dict(max_position_embeddings=2048,
                                     rope_theta=5e5, fuse_rope=True)])
def test_config_equals_reference_field_by_field(kw):
    got, want = llama_13b(**kw), j13b(**kw)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.hidden_size, got.intermediate_size, got.num_hidden_layers,
            got.num_attention_heads, got.num_key_value_heads,
            got.head_dim, got.vocab_size) == (HIDDEN, FFN, LAYERS, H, HKV,
                                              D, VOCAB)
    for k, v in kw.items():
        assert getattr(got, k) == v
    with pytest.raises(TypeError):
        llama_13b(num_hidden_layers=2)
    with pytest.raises(TypeError):
        j13b(num_hidden_layers=2)


def test_kernel_limits_and_plans_take_13b_widths():
    c = llama_13b()
    tft.check_limits(c.num_attention_heads, c.num_key_value_heads,
                     c.head_dim, c.hidden_size, c.intermediate_size,
                     c.vocab_size)
    split_kv.check_heads("paged decode", H, HKV, D)
    qkv = (H + 2 * HKV) * D
    shapes = ((qkv, HIDDEN), (HIDDEN, H * D), (2 * FFN, HIDDEN),
              (HIDDEN, FFN), (VOCAB, HIDDEN))
    for dtype, w8 in ((torch.bfloat16, False), (torch.bfloat16, True),
                      (torch.float32, False)):
        pc = tft.PLAN_COLS[(dtype, w8)]
        for grid in (tft.BLOCKS_PER_SM * H100_SMS, 396, 132):
            size = tft.part_size(8, H, HKV, D, HIDDEN, FFN, VOCAB, pc,
                                 tft.BLOCKS_PER_SM * H100_SMS)
            for N, K in shapes:
                bound = tft.part_slots(N, K, pc,
                                       tft.BLOCKS_PER_SM * H100_SMS)
                assert bound * 8 * N <= size
                for t in range(-(-N // pc)):
                    ranges = _pieces(t, N, K, grid, pc)
                    assert len(ranges) <= bound
                    assert ranges[0][0] == 0 and ranges[-1][1] == K
    # the barrier's groups: QKV heads, and the widest projection's tiles
    cols = tft.TILE_COLS[torch.bfloat16]
    assert max(H + 2 * HKV, FFN // cols, HIDDEN // cols,
               VOCAB // cols) == VOCAB // cols == 500
    # the walk at 8 rows of 40 KV heads over 4096 keys: 4 splits of 1024
    # (the smoke's rows read split_len 1024, n_split 4 on the card)
    assert split_kv.plan(8, HKV, 4096, H100_SMS) == (1024, 4)
    t = split_kv._tickets(torch.device("cpu"), 8 * HKV)
    assert t.numel() >= 8 * HKV == 320 and not t.any()


# ---------------------------------------- engines at 40 over 40 heads
NARROW = dict(hidden_size=H * 8, intermediate_size=FFN * 8 // D,
              num_hidden_layers=2, num_attention_heads=H,
              num_key_value_heads=HKV)
_MODELS, _JAX = {}, {}


def _models():
    """The JAX model (jnp attention) and the port's with its weights, 2
    layers of 40 heads of 8 over 40 KV heads, built once a module."""
    if not _MODELS:
        P.seed(13)
        jm = JLlama(j_tiny(decode_attention="jnp", **NARROW))
        p, tied = llama_decode_params(jm)
        tm = LlamaForCausalLM(llama_tiny(**NARROW), device="cpu")
        load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()},
                           tied)
        _MODELS["m"] = jm, tm
    return _MODELS["m"]


def _run(eng, Request):
    outs = eng.generate([Request(**r) for r in _matrix()])
    return ([o.tolist() for o in outs], [o.finish_reason for o in outs],
            {k: eng.stats[k] for k in STATS})


@pytest.mark.parametrize("knob", [{}, dict(fused_tick=True),
                                  dict(paged_attn=False)],
                         ids=["default", "fused", "dense"])
def test_engine_at_40_over_40_heads_streams_as_jax(knob):
    jm, tm = _models()
    assert tm.config.head_dim == 8 and tm.config.num_attention_heads == 40
    geo = dict(GEOMETRY, **knob)
    key = tuple(sorted(knob))
    if key not in _JAX:
        _JAX[key] = _run(JEngine(jm, **geo, jit_cache={}), JRequest)
    got = _run(ContinuousBatchingEngine(tm, **geo), GenerationRequest)
    assert got == _JAX[key]
    assert sum(len(s) for s in got[0]) == 24
