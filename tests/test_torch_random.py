"""The port's global key walk against the JAX package's, on the CPU.

``fold_in`` (``LlamaForCausalLM.generate`` gives row ``i`` the key
``fold_in(base, i)``), ``seed``, ``next_key`` (a request without a seed
or key, and ``generate`` without a seed, draw from the global generator)
and ``get_rng_state``/``set_rng_state`` must give the same uint32 words
as ``paddle_tpu.core.random`` over ``jax.random`` under the repository's
``jax_threefry_partitionable=True``. Every comparison is exact.
"""
import jax
import numpy as np
import pytest

import paddle_tpu  # noqa: F401  (sets the package's jax config)
from paddle_tpu.core import random as jrandom
from paddle_tpu_torch.core import random as prng

SEEDS = [0, 1, 7, 1234, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
DATA = [0, 1, 2, 3, 17, 255, 65535, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 7,
        3_000_000_000, 2 ** 32 - 1]


def _j(key):
    return np.asarray(key, np.uint32).astype(np.int64).tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bit_exact(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    assert _j(jk) == tk.tolist()
    for d in DATA:
        assert prng.fold_in(tk, d).tolist() == \
            _j(jax.random.fold_in(jk, d)), d


def test_fold_in_chains_and_rows():
    """generate's per-row keys, and a fold of a folded key."""
    jk, tk = jax.random.PRNGKey(5), prng.PRNGKey(5)
    for i in range(64):
        assert prng.fold_in(tk, i).tolist() == _j(jax.random.fold_in(jk, i))
    jk2 = jax.random.fold_in(jax.random.fold_in(jk, 9), 2 ** 31 + 1)
    tk2 = prng.fold_in(prng.fold_in(tk, 9), 2 ** 31 + 1)
    assert tk2.tolist() == _j(jk2)


@pytest.mark.parametrize("seed", [0, 3, 42, 2 ** 32 - 1])
def test_seed_then_next_key_walk(seed):
    jrandom.seed(seed)
    prng.seed(seed)
    for _ in range(12):
        assert prng.next_key().tolist() == _j(jrandom.next_key())
    assert prng.get_rng_state().tolist() == _j(jrandom.get_rng_state())


def test_seed_also_seeds_numpy():
    prng.seed(11)
    a = np.random.rand(3)
    jrandom.seed(11)
    b = np.random.rand(3)
    assert a.tolist() == b.tolist()


def test_rng_state_round_trip():
    jrandom.seed(8)
    prng.seed(8)
    jrandom.next_key(), prng.next_key()
    state = jrandom.get_rng_state()
    want = [_j(jrandom.next_key()) for _ in range(4)]
    prng.set_rng_state(np.asarray(state, np.uint32).astype(np.int64))
    assert [prng.next_key().tolist() for _ in range(4)] == want
    saved = prng.get_rng_state()
    a = prng.next_key().tolist()
    prng.set_rng_state(saved)
    assert prng.next_key().tolist() == a
