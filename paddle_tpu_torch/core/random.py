"""Counter-based PRNG keys, bit-compatible with the JAX package's key walk.

The serving engine gives every request a ``[2]`` uint32 key and advances
it by one split per sampled token (``serving/decode.py``), so a request's
stream depends only on its own key. The JAX package draws those keys with
``jax.random`` under the partitionable threefry
(``jax_threefry_partitionable=True``); this module reproduces the same
functions in torch integer ops so a seeded request samples the same
tokens here as there:

- :func:`PRNGKey` — ``[0, seed & 0xffffffff]``, what ``jax.random.PRNGKey``
  builds with 64-bit types off (the JAX package's setting);
- :func:`split` — threefry2x32 of the key over a 2x32-bit iota (the
  ``_threefry_split_foldlike`` rule);
- :func:`fold_in` — threefry2x32 of the key over ``(0, data)``;
- :func:`random_bits` — ``bits1 ^ bits2`` of the same hash;
- :func:`uniform` / :func:`gumbel` / :func:`categorical` — the float32
  mantissa trick and the Gumbel-max argmax of ``jax.random``.

torch has no uint32 arithmetic, so a uint32 value lives in an int64
tensor and every add and shift is masked back to 32 bits. All functions
take and return such int64 tensors on whatever device the key lies on.

The process-global generator of ``paddle_tpu/core/random.py`` is here too:
:func:`seed` resets it (``paddle.seed``), :func:`next_key` draws a fresh
key by splitting it, and :func:`get_rng_state` / :func:`set_rng_state`
read and replace its key. The engine draws from it for a request that
carries neither a seed nor a key, and ``LlamaForCausalLM.generate`` for
a call without a seed.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def PRNGKey(seed, device="cpu"):
    """Key of an integer seed, as ``jax.random.PRNGKey`` builds it with
    64-bit types off: the seed is taken modulo 2**32, the high word is 0."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key, data):
    """``jax.random.fold_in``: a new key from ``key [2]`` and the integer
    ``data`` (taken as uint32), threefry2x32 of the key over the count
    pair ``(0, data)``."""
    key = torch.as_tensor(key, dtype=torch.int64)
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(key[0]),
                        torch.full_like(key[0], int(data) & _M32))
    return torch.stack([a, b])


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counts ``(x1, x2)`` under key
    ``(k1, k2)``; all four broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def _hash_iota(keys, n):
    """threefry2x32 of each key in ``keys [..., 2]`` over the counts
    ``0..n-1`` (high word 0): returns ``(bits1, bits2)``, each ``[..., n]``."""
    k1 = keys[..., 0:1]
    k2 = keys[..., 1:2]
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(keys, num=2):
    """``jax.random.split`` of every key in ``keys [..., 2]``: returns
    ``[..., num, 2]``. A batch of keys splits row by row, like
    ``jax.vmap(jax.random.split)``."""
    bits1, bits2 = _hash_iota(keys, num)
    return torch.stack([bits1, bits2], dim=-1)


def random_bits(keys, n):
    """32 random bits per position ``0..n-1`` for each key: ``[..., n]``."""
    bits1, bits2 = _hash_iota(keys, n)
    return bits1 ^ bits2


def uniform(keys, n, minval=0.0, maxval=1.0):
    """float32 uniforms in ``[minval, maxval)``, ``[..., n]``: the 23 high
    random bits become the mantissa of a float in [1, 2), minus one."""
    bits = random_bits(keys, n)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys, n):
    """Standard Gumbel noise, ``jax.random.gumbel``'s default "low" mode."""
    return -torch.log(-torch.log(uniform(keys, n, minval=_TINY)))


def categorical(keys, logits):
    """One draw per row of ``logits [R, V]`` under ``keys [R, 2]``: the
    Gumbel-max trick of ``jax.random.categorical``. Returns ``[R]`` int64.

    The random bits are exact; the float ``log`` may round differently
    from XLA's in the last place, which can flip a draw only where two
    perturbed logits tie to within that rounding."""
    g = gumbel(keys, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)


class _GlobalGenerator:
    """The process-global key: created from seed 0 on first use, split by
    every :func:`next_key`."""

    def __init__(self, seed=0):
        self._key = None
        self._seed = int(seed)
        self._lock = threading.Lock()

    def _ensure(self):
        if self._key is None:
            self._key = PRNGKey(self._seed)

    def manual_seed(self, seed):
        with self._lock:
            self._key = PRNGKey(seed)
            self._seed = int(seed)

    def next_key(self):
        with self._lock:
            self._ensure()
            self._key, sub = split(self._key)
            return sub

    def get_state(self):
        with self._lock:
            self._ensure()
            return self._key.clone()

    def set_state(self, key):
        with self._lock:
            self._key = torch.as_tensor(key, dtype=torch.int64).clone()


_GENERATOR = _GlobalGenerator(0)


def seed(s):
    """Reset the global generator to ``PRNGKey(s)`` and seed numpy's
    global generator with ``s`` modulo 2**32, as ``paddle.seed`` does."""
    _GENERATOR.manual_seed(s)
    np.random.seed(int(s) % (2 ** 32))
    return _GENERATOR


def next_key():
    """A fresh key: the second half of a split of the global key, which
    keeps the first half."""
    return _GENERATOR.next_key()


def get_rng_state():
    return _GENERATOR.get_state()


def set_rng_state(state):
    _GENERATOR.set_state(state)
