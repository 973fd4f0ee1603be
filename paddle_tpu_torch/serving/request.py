"""Request / sequence state for the continuous-batching engine (the
port's own copy of ``paddle_tpu/serving/request.py``; the port imports
nothing of the JAX package).

A :class:`GenerationRequest` is the immutable user order (prompt +
decoding knobs); a :class:`Sequence` is its mutable in-flight state —
queue position, cache slot, generated tokens, finish reason. The split
mirrors the request/sequence separation in the Orca / vLLM schedulers
(PAPERS.md): the scheduler owns Sequences, users hold Requests.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional

import numpy as np

_next_request_id = itertools.count()


@dataclass(frozen=True)
class GenerationRequest:
    """One generation order.

    ``prompt`` is a 1-D int array/list of token ids. Sampling is greedy
    when ``temperature <= 0``, else top-k temperature sampling
    (``top_k <= 0`` = no top-k filter). ``eos_token_id`` enables early
    exit; ``None`` always decodes ``max_new_tokens`` tokens. Randomness
    comes from ``seed`` (or ``prng_key``, a ``[2]`` uint32 key, for
    callers that manage keys); with both unset the engine draws a key
    from the global generator (``core/random.next_key``) at submit time.

    ``timeout_s`` is a wall-clock deadline measured from submit time:
    the engine retires the sequence with ``finish_reason="timeout"`` at
    the first step boundary past it — queued (never admitted) or
    mid-decode (slot freed) alike. ``None`` = no deadline.

    ``priority_class`` names the request's tenant tier: it must resolve
    against the engine's class table at validate time (an unknown name is
    a ValueError, the HTTP 400). ``None`` rides the table's default
    class.
    """
    prompt: object
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    eos_token_id: Optional[int] = None
    seed: Optional[int] = None
    prng_key: object = None
    timeout_s: Optional[float] = None
    priority_class: Optional[str] = None


#: the closed finish_reason vocabulary (OpenAI-style names): "stop" =
#: EOS hit, "length" = token budget spent, "cancelled" = caller cancel,
#: "timeout" = deadline expired, "error" = the request itself faulted
#: (a poisoned request isolated by the gateway's crash-recovery
#: bisection, or an unrecoverable engine failure) — the ONLY reason
#: under which output may be lost.
FINISH_REASONS = ("stop", "length", "cancelled", "timeout", "error")


class Sequence:
    """In-flight state of one request inside the engine.

    ``tokens`` holds ONLY generated ids (the first entry is the token
    sampled from the prefill logits). ``status`` walks
    queued -> [prefilling ->] running -> finished; ``prefilling`` is the
    chunked-prefill state (README "Chunked prefill"): the sequence holds
    a KV slot and ``prefilled`` prompt rows are installed, but no token
    has been sampled yet — the engine advances it one chunk per step
    until the final chunk's logits produce token 0. Short prompts skip
    the state entirely. ``finish_reason`` is one of
    :data:`FINISH_REASONS`. ``deadline`` is the absolute
    ``time.monotonic()`` instant derived from the request's
    ``timeout_s`` at submit time (``None`` = no deadline).
    """

    __slots__ = ("request", "request_id", "prompt", "tokens", "status",
                 "finish_reason", "slot", "key", "deadline",
                 "prefix_nodes", "prefix_hit_tokens", "prefilled",
                 "work", "restore_point", "queue_tick", "launches", "pclass",
                 "t_submit", "t_admitted", "t_first_token",
                 "t_last_token", "t_finish",
                 "trace_mark", "trace_phase", "trace_chunk_i",
                 "trace_accepts")

    def __init__(self, request: GenerationRequest, key, deadline=None):
        self.request = request
        self.request_id = next(_next_request_id)
        self.prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        self.tokens = []
        self.status = "queued"
        self.finish_reason = None
        self.slot = None
        self.key = key
        self.deadline = deadline
        # prefix-cache state: the trie nodes this sequence's admission
        # matched and pinned (released at retirement), and the prompt
        # tokens they cover (0 = cold prefill)
        self.prefix_nodes = []
        self.prefix_hit_tokens = 0
        # chunked-prefill resume offset: prompt rows whose KV is already
        # installed (cache-hit prefix + completed chunks). Block-aligned
        # by construction while prefilling.
        self.prefilled = 0
        # recovery-by-recompute state (engine.restore): ``work`` is the
        # token content the prefill paths install — the prompt for a
        # fresh sequence, prompt + tokens[:-1] for one preempted (the
        # LAST generated token's KV is never in the cache, so it
        # re-enters as the resumed decode input). ``restore_point`` is
        # len(tokens) at the last restore — 0 means a normal install,
        # > 0 tells the engine the first "sampled" token is already known
        # and already streamed.
        self.work = self.prompt
        self.restore_point = 0
        # FIFO seniority stamp, set by FIFOScheduler.submit: the queue
        # position authority when an aborted admission is unwound
        self.queue_tick = None
        # serving programs this request has ridden (the cost columns of
        # the gateway's /debug/requests): +1 per prefill, chunk or decode
        # call whose packed rows or slot included it; recompute after a
        # preemption or a rebuild is charged too
        self.launches = 0
        # the resolved priority class (policy/classes.py), set by
        # engine.submit; None only for a sequence built outside an engine
        self.pclass = None
        # latency stamps (the engine's clock): submit, first slot claim
        # (kept across preemption), first token, last accepted token,
        # retirement — what ttft_s / queue_wait_s / tpot_s derive from
        self.t_submit = None
        self.t_admitted = None
        self.t_first_token = None
        self.t_last_token = None
        self.t_finish = None
        # request-lifecycle tracing (profiler/tracing.py): the clock mark
        # the current phase started at, the phase's span name
        # (queued|prefill|decode|preempted|recovered, kept with tracing
        # off so a capture opened mid-flight names the next span right),
        # the index of the next prefill_chunk[i] span, and the
        # acceptance length of each verify span a speculative engine
        # recorded while tracing (the decode span's args, at most 512)
        self.trace_mark = None
        self.trace_phase = "queued"
        self.trace_chunk_i = 0
        self.trace_accepts = []

    # ------------------------------------------------------- SLO latencies
    @property
    def ttft_s(self):
        """Submit-to-first-token seconds (None until the first token)."""
        if self.t_submit is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def queue_wait_s(self):
        """Submit-to-slot-claim seconds (None until admitted)."""
        if self.t_submit is None or self.t_admitted is None:
            return None
        return self.t_admitted - self.t_submit

    @property
    def tpot_s(self):
        """Time-per-output-token: (finish - first token) / (n - 1),
        the steady-state decode cadence this request observed. None
        until finished, or with fewer than two tokens (a one-token
        request has no inter-token gap)."""
        if self.t_first_token is None or self.t_finish is None \
                or len(self.tokens) < 2:
            return None
        return (self.t_finish - self.t_first_token) \
            / (len(self.tokens) - 1)

    @property
    def done(self) -> bool:
        return self.status == "finished"

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def work_len(self) -> int:
        """Length of the prefill work content (== ``prompt_len`` unless
        the sequence was restored for recovery-by-recompute)."""
        return int(self.work.shape[0])

    @property
    def remaining(self) -> int:
        """Decode steps still needed (0 when the budget is spent)."""
        return max(self.request.max_new_tokens - len(self.tokens), 0)

    def output_ids(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)

    def __repr__(self):
        return (f"Sequence(id={self.request_id}, status={self.status}, "
                f"slot={self.slot}, generated={len(self.tokens)}/"
                f"{self.request.max_new_tokens})")


class GenerationResult:
    """One finished request's output: the generated ids plus the
    ``finish_reason`` the engine retired it with.

    Array-like on purpose: ``__array__``/``__len__``/``__iter__`` make
    it a drop-in for the bare ``np.ndarray`` that
    ``ContinuousBatchingEngine.generate()`` used to return
    (``np.stack(outs)``, ``np.pad(out, ...)``, ``len(out)`` all keep
    working), while gateways and tests can read ``.finish_reason``.
    """

    __slots__ = ("ids", "finish_reason", "request_id")

    def __init__(self, ids, finish_reason, request_id):
        self.ids = np.asarray(ids, np.int32)
        self.finish_reason = finish_reason
        self.request_id = request_id

    def __array__(self, dtype=None, copy=None):
        return self.ids if dtype is None else self.ids.astype(dtype)

    def __len__(self):
        return len(self.ids)

    def __iter__(self):
        return iter(self.ids)

    def __getitem__(self, i):
        return self.ids[i]

    def tolist(self):
        return self.ids.tolist()

    def __repr__(self):
        return (f"GenerationResult(id={self.request_id}, "
                f"finish_reason={self.finish_reason!r}, "
                f"ids={self.ids.tolist()})")
