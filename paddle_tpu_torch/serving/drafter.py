"""Draft-token proposers for speculative decoding — the port's own copy of
``paddle_tpu/serving/drafter.py``.

Speculative decode splits each decode advance into a cheap PROPOSE and one
batched VERIFY: a :class:`Drafter` guesses the next ``k`` tokens of a
running sequence from host-visible state, the engine scores all ``k + 1``
positions in one ragged-span forward through the paged block tables
(``decode._spec_verify_impl``), accepts the longest matching prefix, and
rolls rejected K/V back by truncating the slot's private block tail
(``PagedKVCache.truncate``). The drafter is host-side policy: it never
touches the KV pool, and a wrong guess costs only the packed positions the
verify span spent — never a wrong token (acceptance is exact match against
the target model's own samples, so streams equal speculation off).

- :class:`NgramDrafter` — model-free prompt lookup: match the longest
  recent n-gram of the sequence's history (prompt + generated tokens)
  against an earlier occurrence and propose its continuation. The
  engine's default.
- :class:`ModelDrafter` — a separate LLaMA draft model proposing greedily
  through the port's cold prefill program (``decode._prefill_impl``) at
  pow2-padded lengths, once per proposed token. Drafting with the target
  model itself is the always-accept oracle.
"""
from __future__ import annotations

import functools

import numpy as np

_EMPTY = np.zeros(0, np.int32)


def _history(seq):
    """The sequence's known token history — prompt plus every ACCEPTED
    generated token (drafts enter ``seq.tokens`` only once verified, so a
    restore recomputes from exactly this)."""
    if seq.tokens:
        return np.concatenate(
            [seq.prompt, np.asarray(seq.tokens, np.int32)])
    return np.asarray(seq.prompt, np.int32)


class Drafter:
    """Interface: ``propose(seq, k)`` returns up to ``k`` draft token ids
    (1-D int32, possibly empty) guessing the sequence's next tokens.
    Called on the engine-driver thread once per running slot per
    speculative step; returning fewer than ``k`` (or none) is always safe
    and shrinks the verify span."""

    def propose(self, seq, k):
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Prompt-lookup n-gram drafter (model-free).

    Finds the longest ``n``-gram (``max_ngram`` down to ``min_ngram``)
    ending the history that also occurs EARLIER in it, and proposes the
    continuation after the most recent such occurrence. Without a match
    the verify span is a plain decode row.
    """

    def __init__(self, max_ngram=3, min_ngram=1):
        if int(min_ngram) < 1 or int(max_ngram) < int(min_ngram):
            raise ValueError(
                f"need max_ngram >= min_ngram >= 1, got "
                f"max_ngram={max_ngram}, min_ngram={min_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, seq, k):
        k = int(k)
        if k <= 0:
            return _EMPTY
        hist = _history(seq)
        L = int(hist.shape[0])
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if L < n + 1:
                continue        # history too short for this n + 1 cont.
            tail = hist[L - n:]
            win = np.lib.stride_tricks.sliding_window_view(hist, n)
            hits = np.nonzero((win == tail).all(axis=1))[0]
            hits = hits[hits < L - n]   # exclude the tail itself
            if hits.size:
                i = int(hits[-1])       # most recent earlier occurrence
                return hist[i + n:i + n + k].astype(np.int32, copy=True)
        return _EMPTY


class ModelDrafter(Drafter):
    """Greedy proposals from a separate LLaMA-family draft model.

    Each proposed token is one cold prefill of the history through the
    port's ``_prefill_impl`` (the flash forward on a card), its length
    padded to a power of two (at least 8, at most the model's
    ``max_position_embeddings``), as the reference pads it. ``jit_cache``
    follows the engine's shared-cache idiom: the program lives under the
    ``("draft",)`` key, which the engine's ``prefill_compilations()``
    never counts.
    """

    def __init__(self, model, jit_cache=None):
        from ..models.llama import llama_decode_params
        c = model.config
        params, tied = llama_decode_params(model)
        self._params = [params]       # the programs' one-shard form
        self._consts = dict(
            nh=c.num_attention_heads, nkv=c.num_key_value_heads,
            hd=c.head_dim, eps=float(c.rms_norm_eps),
            theta=float(c.rope_theta), tied=tied,
            decode_attn=c.decode_attention)
        self._jit = jit_cache if jit_cache is not None else {}
        self._max_len = int(c.max_position_embeddings)

    def _fn(self):
        key = ("draft",)
        if key not in self._jit:
            from .decode import _prefill_impl
            from .engine import _Program
            self._jit[key] = _Program(functools.partial(_prefill_impl,
                                                        **self._consts))
        return self._jit[key]

    def propose(self, seq, k):
        hist = _history(seq)
        out = []
        for _ in range(int(k)):
            L = int(hist.shape[0])
            if L >= self._max_len:
                break
            pad = min(max(8, 1 << (L - 1).bit_length()), self._max_len)
            ids = np.zeros((1, pad), np.int32)
            ids[0, :L] = hist
            _, _, tok0, _ = self._fn()(
                self._params, ids, np.asarray([L], np.int32),
                np.zeros((1, 2), np.int64), np.zeros(1, np.float32),
                np.zeros(1, np.int32))
            t = int(tok0.cpu()[0])
            out.append(t)
            hist = np.append(hist, np.int32(t))
        return np.asarray(out, np.int32)
