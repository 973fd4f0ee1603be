"""``LlamaForCausalLM.generate`` of the port against the JAX model's, on
the CPU, on ``llama_tiny`` with the JAX weights carried across
(``load_decode_params``): the cases of tests/test_generate.py.

The JAX side runs its plain decode attention (``decode_attention="jnp"``);
the port's default (``"pallas"``) reaches the kernel wrappers, which run
their plain versions on CPU tensors. Greedy ids must be equal, GQA and
MHA; seeded sampled ids equal and reproducible; unseeded ids equal after
the same global ``seed``; rows ending at EOS padded the same way; the
overflow ``ValueError`` the same; and the programs each side recorded
(the port's signature counts, the JAX traces) equal per key.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import random as jrandom
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as j_tiny
from paddle_tpu.serving.decode import llama_decode_params
from paddle_tpu_torch.core import random as prng
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                           load_decode_params)


def _pair(seed, **kw):
    paddle.seed(seed)
    jm = JLlama(j_tiny(decode_attention="jnp", **kw))
    p, tied = llama_decode_params(jm)
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
    load_decode_params(tm, {k: np.asarray(v) for k, v in p.items()}, tied)
    return jm, tm


@pytest.fixture(scope="module")
def gqa():
    return _pair(11)        # nkv=2 < nh=4


def _ids(seed, b, s):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


def _both(pair, ids, **kw):
    jm, tm = pair
    want = jm.generate(paddle.to_tensor(ids), **kw).numpy()
    got = tm.generate(torch.as_tensor(ids), **kw)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    return got.numpy(), want


def _greedy_oracle(tm, ids, n):
    """The port model's full forward, one argmax token at a time."""
    cur = torch.as_tensor(ids).long()
    out = []
    with torch.no_grad():
        for _ in range(n):
            nxt = tm(cur)[:, -1].argmax(-1)
            out.append(nxt)
            cur = torch.cat([cur, nxt[:, None]], 1)
    return torch.stack(out, 1).numpy()


def test_greedy_equals_jax_and_full_forward_gqa(gqa):
    ids = _ids(0, 2, 12)
    got, want = _both(gqa, ids, max_new_tokens=8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _greedy_oracle(gqa[1], ids, 8))


def test_greedy_equals_jax_mha():
    pair = _pair(12, num_key_value_heads=4)
    got, want = _both(pair, _ids(1, 1, 6), max_new_tokens=6)
    np.testing.assert_array_equal(got, want)


def test_sampling_seeded_equal_and_reproducible(gqa):
    ids = _ids(2, 2, 8)
    kw = dict(max_new_tokens=5, temperature=0.8, top_k=10, seed=42)
    got, want = _both(gqa, ids, **kw)
    np.testing.assert_array_equal(got, want)
    again = gqa[1].generate(ids, **kw).numpy()
    np.testing.assert_array_equal(got, again)
    assert (got >= 0).all() and (got < 256).all()


def test_sampling_unseeded_follows_the_global_walk(gqa):
    ids = _ids(3, 3, 9)
    jrandom.seed(77)
    prng.seed(77)
    got, want = _both(gqa, ids, max_new_tokens=6, temperature=1.0)
    np.testing.assert_array_equal(got, want)


def test_cache_shorter_than_max_positions(gqa):
    got, want = _both(gqa, _ids(3, 1, 4), max_new_tokens=4,
                      max_cache_len=16)
    np.testing.assert_array_equal(got, want)


def test_eos_rows_padded_with_eos(gqa):
    ids = _ids(4, 2, 10)
    free = gqa[1].generate(ids, max_new_tokens=10).numpy()
    eos = int(free[0, 3])           # row 0 stops at its 4th token
    got, want = _both(gqa, ids, max_new_tokens=10, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    stop = list(free[0]).index(eos)
    assert (got[0, stop:] == eos).all()


def test_cache_overflow_rejected(gqa):
    ids = _ids(4, 1, 8)
    with pytest.raises(ValueError, match="KV cache") as ours:
        gqa[1].generate(ids, max_new_tokens=10, max_cache_len=10)
    with pytest.raises(ValueError, match="KV cache") as ref:
        gqa[0].generate(paddle.to_tensor(ids), max_new_tokens=10,
                        max_cache_len=10)
    assert str(ours.value) == str(ref.value)


def test_program_counts_equal_and_reused():
    """Two calls at one shape record no new program the second time, and
    each side's cache holds the same keys with the same counts (the
    attention name, part of the key, differs: jnp there, pallas here)."""
    jm, tm = _pair(16)
    ids = _ids(5, 2, 8)
    for _ in range(2):
        _both((jm, tm), ids, max_new_tokens=21)
        ours = {k[:4] if k[0] == "ragged" else k: v._cache_size()
                for k, v in tm._serving_jit.items()}
        ref = {k[:4] if k[0] == "ragged" else k: v._cache_size()
               for k, v in jm._serving_jit.items()}
        assert ours == ref
    assert ours[("prefill",)] == 1
    # 20 decode tokens after the prefill's: one 16-tick step, one 4-tick
    assert {k[3] for k in ours if k[0] == "ragged"} == {16, 4}
