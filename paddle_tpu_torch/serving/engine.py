"""Continuous-batching engine on the default serving geometry, in PyTorch.

The port of ``paddle_tpu/serving/engine.py``'s ``ContinuousBatchingEngine``
with its default settings: a paged KV pool (:class:`~.kv_cache.
PagedKVCache`), no prefix cache, chunked prefill (``prefill_chunk=512``)
and the unified ragged step (``ragged_step=True``): every :meth:`step`
admits queued requests into free slots (short prompts take one bucketed
cold prefill per group, long prompts enter chunked prefill), then runs ONE
unified step — every running slot a span-1 decode row, every planned
prefill chunk a span-n row of one packed buffer — with up to
``decode_chunk`` fused decode ticks when nothing else is pending, and
retires sequences at EOS or their token budget.

Two more decode programs ride the same engine:

- ``fused_tick=True``: every tail tick of the unified step is ONE launch
  of the fused-tick kernel (``kernels/fused_decode_tick.py``) instead of
  the scanned per-layer stack;
- ``paged_attn=False``: the dense-slot engine — a :class:`~.kv_cache.
  SlotKVCache`, one-shot cold prefill (``prefill_chunk`` is validated,
  then ignored; ``ragged_step`` is ignored), and each step one call of
  ``decode._decode_steps_impl`` over the dense-cache decode kernel.

Offline use::

    engine = ContinuousBatchingEngine(model, num_slots=8)
    outs = engine.generate([GenerationRequest(prompt=ids, ...), ...])

The constructor takes the JAX engine's arguments in its order. Every
value off the ported path raises ``NotImplementedError`` naming the
ROADMAP item that ports it.

The surface the serving gateway (``serving/server``) and
``LlamaForCausalLM.generate`` read is the reference's: the streaming
hooks ``on_token`` / ``on_finish`` / ``on_policy_preempt``, the span
``tracer`` and the ``cost`` observatory (each site guarded by
``_tr()`` / ``_co()``, one attribute check when off), the injectable
``step_clock`` the SLO stamps read, ``restore`` / ``evict`` for recovery
by recompute, and the program cache: every serving program is handed out
of ``jit_cache`` under the reference's key, and
:meth:`decode_compilations` / :meth:`prefill_compilations` count the
argument signatures each key ran with — eager PyTorch compiles nothing,
so these are the trace counts the JAX engine reports for the same
traffic.

While the kernels are on (``FLAGS_use_cuda_kernels`` on, the config's
``decode_attention`` ``"pallas"`` and the model on CUDA) the constructor
holds the model's head geometry, and for the fused tick its widths,
against every kernel the chosen engine launches, so an engine the
kernels cannot serve raises before it admits a request.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..core import random as prng
from ..flags import get_flag
from ..kernels import decode as dense_decode
from ..kernels import flash, fused_decode_tick, paged_decode, \
    ragged_attention
from ..kernels._launch import check_head_dim
from ..models.llama import llama_decode_params
from ..profiler.tracing import NULL_SPAN
from .decode import _decode_steps_impl, _prefill_impl, _ragged_step_impl
from .kv_cache import PagedKVCache, PoolExhausted, SlotKVCache
from .policy import ClassTable
from .request import GenerationRequest, GenerationResult, Sequence
from .scheduler import FIFOScheduler


def _not_ported(knob, item):
    raise NotImplementedError(
        f"{knob} is not ported to paddle_tpu_torch yet (ROADMAP {item}); "
        f"this engine serves the default geometry only")


def _kernels_on(params, config):
    """Whether the engine's programs launch the CUDA kernels: the flag on,
    the config's ``decode_attention`` ``"pallas"``, the weights on CUDA."""
    return (get_flag("FLAGS_use_cuda_kernels")
            and config.decode_attention == "pallas"
            and params["embed"].device.type == "cuda")


def _signature(arg):
    """The part of one program argument a JAX trace is keyed on: shape
    and dtype of an array or tensor (the parameter dict is the model's,
    fixed for a cache)."""
    if isinstance(arg, (np.ndarray, torch.Tensor)):
        return tuple(arg.shape), str(arg.dtype)
    return None


class _Program:
    """One serving program of the jit cache: the eager function plus the
    argument signatures it has run with. Where the JAX engine caches a
    jitted function whose ``_cache_size()`` counts its traces (one per
    signature), the port records the signatures, so the counts — and the
    compile-once contract that reads them — are the reference's."""

    __slots__ = ("fn", "signatures")

    def __init__(self, fn):
        self.fn = fn
        self.signatures = set()

    def _cache_size(self):
        return len(self.signatures)

    def __call__(self, *args):
        self.signatures.add(tuple(_signature(a) for a in args))
        return self.fn(*args)


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a LLaMA-family model.

    ``model`` is a :class:`~paddle_tpu_torch.models.llama.LlamaForCausalLM`;
    the engine runs on the model's device, and its attention follows
    ``FLAGS_use_cuda_kernels`` (on: the CUDA kernels on a CUDA model,
    their plain versions on a CPU one; off: the plain versions).

    ``prefix_block_size`` is the KV block size (the JAX engine's name for
    it, kept so both engines take the same arguments).

    ``prefill_chunk`` bounds TTFT under mixed traffic: a prompt longer
    than it is prefilled ``prefill_chunk`` tokens per step (rounded up to
    a block multiple) through the unified step, beside the decode rows.
    The per-step chunk grant adapts to a measured tokens-per-second EWMA
    (``headroom_mult`` decode-steps' worth of time, capped at
    ``prefill_chunk``); ``headroom_mult=None`` pins it at the cap.
    """

    def __init__(self, model, num_slots=8, max_seq_len=None, decode_chunk=8,
                 prefill_bucketing="pow2", jit_cache=None,
                 prefix_cache=False, prefix_blocks=None,
                 prefix_block_size=32, paged_attn=True,
                 prefill_chunk=512, ragged_step=True, headroom_mult=2.0,
                 step_clock=None, spec_decode=False, spec_k=4,
                 drafter=None, decode_ticks=1, kv_dtype=None,
                 quantize_weights=False, quantize_activations=False,
                 tp=1, collective_dtype="fp",
                 host_tier_bytes=0, priority_classes=None,
                 fused_tick=False, collective_overlap=False):
        c = model.config
        if c.decode_attention not in ("pallas", "jnp"):
            raise ValueError(
                f"decode_attention must be 'pallas' or 'jnp', got "
                f"{c.decode_attention!r}")
        if prefill_bucketing not in ("pow2", "exact"):
            raise ValueError(
                f"prefill_bucketing must be 'pow2' or 'exact', got "
                f"{prefill_bucketing!r}")
        if prefix_blocks is not None:
            _not_ported("prefix_blocks", "Queue A step 9 (prefix cache)")
        if drafter is not None:
            _not_ported("drafter", "Queue A step 9 (spec decode)")
        if collective_dtype not in ("fp", "int8"):
            raise ValueError(
                f"collective_dtype must be 'fp' or 'int8', got "
                f"{collective_dtype!r}")
        if collective_dtype != "fp":
            _not_ported(f"collective_dtype={collective_dtype!r}",
                        "Queue A step 10 (tensor parallel)")
        if prefix_cache:
            _not_ported("prefix_cache", "Queue A step 9 (prefix cache)")
        if spec_decode:
            _not_ported("spec_decode", "Queue A step 9 (spec decode)")
        if int(decode_ticks) != 1:
            _not_ported("decode_ticks > 1", "Queue A step 9 (multi-tick)")
        if kv_dtype is not None:
            _not_ported("kv_dtype", "Queue A step 9 (quantized serving)")
        if quantize_weights or quantize_activations:
            _not_ported("quantize_weights/quantize_activations",
                        "Queue A step 9 (quantized serving)")
        if int(tp) != 1:
            _not_ported("tp > 1", "Queue A step 10 (tensor parallel)")
        if collective_overlap:
            _not_ported("collective_overlap",
                        "Queue A step 10 (tensor parallel)")
        if int(host_tier_bytes):
            _not_ported("host_tier_bytes", "Queue A step 9 (host tier)")
        self.classes = ClassTable.coerce(priority_classes)
        if self.classes.doc() != ClassTable.single().doc():
            _not_ported("priority_classes other than the neutral table",
                        "Queue A step 9 (serving/policy)")
        self._paged = bool(paged_attn)
        # the unified ragged step is the paged engine's; the dense engine
        # ignores ragged_step, as the reference does
        self._ragged = self._paged and bool(ragged_step)
        self._fused_tick = bool(fused_tick)
        if self._fused_tick and not self._ragged:
            raise ValueError(
                "fused_tick=True requires the unified ragged paged "
                "engine (paged_attn=True, ragged_step=True): the fused "
                "program is the packed-span tick body, and the dense / "
                "two-program paths never grew its dispatch site")
        if self._paged and not ragged_step:
            _not_ported("ragged_step=False",
                        "Queue A step 9 (two-program step)")
        self.model = model
        self.config = c
        self._bucketing = prefill_bucketing
        self.num_slots = int(num_slots)
        self.max_seq_len = int(max_seq_len or c.max_position_embeddings)
        self._params, self._tied = llama_decode_params(model)
        if _kernels_on(self._params, c):
            self._check_kernel_limits()
        bs = int(prefix_block_size)
        if bs < 1:
            raise ValueError(f"prefix_block_size must be >= 1, got {bs}")
        if self._paged:
            self.cache = PagedKVCache(
                c.num_hidden_layers, self.num_slots, self.max_seq_len,
                c.num_key_value_heads, c.head_dim,
                dtype=self._params["embed"].dtype, block_size=bs,
                device=model.device)
        else:
            self.cache = SlotKVCache(
                c.num_hidden_layers, self.num_slots, self.max_seq_len,
                c.num_key_value_heads, c.head_dim,
                dtype=self._params["embed"].dtype, device=model.device)
        self._kv_dtype = str(self._params["embed"].dtype).replace(
            "torch.", "")
        # chunked prefill (paged only: the dense cache has no block tables
        # to resume through, so its prefill stays one-shot). The chunk
        # rounds UP to a block multiple so every non-final chunk boundary
        # is block-aligned
        self._chunk = None
        if prefill_chunk and int(prefill_chunk) < 1:
            # validated on both engines: an A/B toggle of paged_attn must
            # not turn a hard error into a silent no-op
            raise ValueError(
                f"prefill_chunk must be >= 1 (or None/0 to disable), "
                f"got {int(prefill_chunk)}")
        if self._paged and prefill_chunk:
            self._chunk = -(-int(prefill_chunk) // bs) * bs
        # the packed token buffer: num_slots decode rows plus the chunk
        # cap, when a prompt long enough to chunk can exist at all
        chunkable = self._chunk is not None and self._chunk < self.max_seq_len
        self._token_budget = self.num_slots + (self._chunk if chunkable
                                               else 0)
        if headroom_mult is not None and float(headroom_mult) <= 0:
            raise ValueError(
                f"headroom_mult must be > 0 (or None for fixed-cap chunk "
                f"pacing), got {headroom_mult}")
        self._headroom_mult = (None if headroom_mult is None
                               else float(headroom_mult))
        self._clock = step_clock if step_clock is not None \
            else time.perf_counter
        # the current step's start reading of step_clock: the SLO stamps
        # quantize to it, so a step reads its clock exactly twice
        self._stamp_t = None
        self._tps_ewma = None
        self._dt_decode_ewma = None
        self.scheduler = FIFOScheduler(decode_chunk)
        self._slots = [None] * self.num_slots
        self._last_tok = np.zeros(self.num_slots, np.int32)
        self._temps = np.zeros(self.num_slots, np.float32)
        self._topks = np.zeros(self.num_slots, np.int32)
        # per-slot PRNG keys: uint32 values held in int64 (core/random.py)
        self._keys = np.zeros((self.num_slots, 2), np.int64)
        # serving programs, shareable across engines of one model so a
        # rebuilt engine counts as one program (model.generate and the
        # gateway's factory pass the model-level dict)
        self._jit = jit_cache if jit_cache is not None else {}
        self._fktag = ("fk",) if self._fused_tick else ()
        # the prefix-copy and multi-tick counters stay 0 on the ported
        # path; the gateway's series read them as the reference's do
        self.stats = {"steps": 0, "decode_calls": 0, "decode_steps": 0,
                      "slot_steps": 0, "active_slot_steps": 0,
                      "prefills": 0, "prefill_tokens": 0,
                      "prefill_copy_dispatches": 0,
                      "prefill_chunks": 0, "chunk_tokens": 0,
                      "unified_steps": 0, "mtick_syncs": 0, "mtick_ticks": 0,
                      "headroom": self._chunk or 0, "headroom_tps": 0.0,
                      "last_step_duration_s": 0.0, "last_step_tokens": 0,
                      "tokens_generated": 0, "cancelled": 0, "timeouts": 0,
                      "preemptions": 0, "restores": 0}
        # the prefix cache is not ported (Queue A step 9): the gateway
        # reads None, as from a reference engine built without one
        self.prefix_cache = None
        # fault-injection hook: called with the engine at the top of every
        # step attempt; a PoolExhausted it raises is repaired by
        # preemption, anything else propagates
        self.fault_hook = None
        # request-lifecycle tracer (profiler/tracing.py) and cost
        # observatory (profiler/cost.py): None in a bare engine; the
        # gateway installs one of each on every engine it builds
        self.tracer = None
        self.cost = None
        # streaming hooks, run on the thread driving step():
        # on_token(seq, token) for every generated token, on_finish(seq)
        # once per sequence whatever its finish reason (cancel()
        # included); on_policy_preempt never fires on the neutral table
        self.on_token = None
        self.on_finish = None
        self.on_policy_preempt = None

    @property
    def fused_tick(self) -> bool:
        """Whether every tail tick of the unified step is ONE fused-tick
        kernel launch instead of the scanned per-layer stack."""
        return self._fused_tick

    @property
    def ragged_step(self) -> bool:
        return self._ragged

    @property
    def prefill_chunk(self) -> int:
        """The chunk the engine runs (block-rounded), 0 when off."""
        return self._chunk or 0

    @property
    def kv_dtype(self) -> str:
        """The pool's storage dtype name (``"float32"``/``"bfloat16"``)."""
        return self._kv_dtype

    # the ported path's fixed values of the reference's serving knobs
    spec_decode = False
    spec_k = 0
    decode_ticks = 1
    tp = 1
    collective_dtype = "fp"
    collective_overlap = False
    quantize_weights = False
    quantize_activations = False

    @property
    def num_active(self) -> int:
        """Slots in use (the /metrics active-slots gauge)."""
        return self.num_slots - self.cache.num_free

    def release(self):
        """Drop the KV storage of a dead engine, so a rebuild does not
        hold two pools; host bookkeeping stays readable."""
        self.cache.release()

    def _check_kernel_limits(self):
        """Raise unless every kernel this engine launches takes the model:
        the flash forward (cold prefill); then ragged attention and paged
        decode, or ragged attention and the fused tick (any ``num_slots``),
        or dense decode."""
        c = self.config
        nh, nkv, hd = (c.num_attention_heads, c.num_key_value_heads,
                       c.head_dim)
        check_head_dim("flash", hd, flash.HEAD_DIMS)
        if not self._paged:
            dense_decode.check_limits(nh, nkv, hd)
            return
        ragged_attention.check_limits(nh, nkv, hd)
        if self._fused_tick:
            fused_decode_tick.check_limits(nh, nkv, hd, c.hidden_size,
                                           c.intermediate_size,
                                           c.vocab_size)
        else:
            paged_decode.check_limits(nh, nkv, hd)

    # ------------------------------------------------------------- tracing
    def _tr(self):
        """The recording tracer, or None — the guard of every trace site."""
        t = self.tracer
        return t if (t is not None and t.enabled) else None

    def _co(self):
        """The active cost observatory, or None — the guard of every
        cost site."""
        c = self.cost
        return c if (c is not None and c.enabled) else None

    def _wrap_prog(self, key, fn, host_out):
        """Every program accessor hands out through here, so with the
        observatory on every program call is counted once. ``host_out``
        names the results the engine fetches to host."""
        co = self._co()
        if co is None:
            return fn
        return co.wrap(key, fn, host_out=host_out)

    def _trace_phase_end(self, tr, seq, args=None):
        """Close the sequence's current lifecycle span on its request
        lane and restart the mark."""
        tr.complete(seq.trace_phase, seq.trace_mark,
                    tid=tr.req_tid(seq.request_id), args=args)
        seq.trace_mark = tr.now()

    def _tspan(self, name, args=None):
        tr = self._tr()
        if tr is None:
            return NULL_SPAN
        return tr.span(name, args=args)

    # ------------------------------------------------------------ programs
    def _fn_consts(self):
        c = self.config
        return dict(nh=c.num_attention_heads, nkv=c.num_key_value_heads,
                    hd=c.head_dim, eps=float(c.rms_norm_eps),
                    theta=float(c.rope_theta), tied=self._tied,
                    decode_attn=c.decode_attention)

    def _program(self, key, fn, host_out, **kw):
        if key not in self._jit:
            self._jit[key] = _Program(functools.partial(
                fn, **kw, **self._fn_consts()))
        return self._wrap_prog(key, self._jit[key], host_out)

    def _prefill_fn(self):
        # host reads tok0 (result 2)
        return self._program(("prefill",), _prefill_impl, (2,))

    def _ragged_fn(self, n_steps):
        # the full packed geometry (num_slots AND token budget) keys the
        # program, as in the reference; host reads tokens and tick-0 keys
        key = ("ragged", self.num_slots, self._token_budget, int(n_steps),
               self.config.decode_attention) + self._fktag
        return self._program(key, _ragged_step_impl, (2, 3),
                             n_steps=int(n_steps), fused=self._fused_tick)

    def _decode_fn(self, n_steps):
        key = ("decode", int(n_steps), self.config.decode_attention)
        return self._program(key, _decode_steps_impl, (0,),
                             n_steps=int(n_steps))

    def decode_compilations(self) -> int:
        """Decode-program signatures of THIS engine's kind (the
        compile-once hook): one per ``(num_slots, token_budget,
        n_steps)`` on the unified engine, one per ``n_steps`` on the
        dense one, however sampling knobs, budgets, tables and span
        mixes vary — the JAX engine's trace count."""
        if self._ragged:
            return sum(fn._cache_size() for key, fn in self._jit.items()
                       if key[0] == "ragged"
                       and key[1] == self.num_slots
                       and key[2] == self._token_budget
                       and key[5:] == self._fktag)
        return sum(fn._cache_size() for key, fn in self._jit.items()
                   if key[0] == "decode" and key[3:] == ())

    def prefill_compilations(self) -> int:
        """Cold-prefill signatures: one per (padded group, bucket)."""
        return sum(fn._cache_size() for key, fn in self._jit.items()
                   if key == ("prefill",))

    # ------------------------------------------------------------- intake
    def _key_for(self, request):
        if request.prng_key is not None:
            return np.asarray(request.prng_key, np.int64).reshape(2)
        if request.seed is not None:
            return prng.PRNGKey(int(request.seed)).numpy()
        return prng.next_key().numpy()

    def validate(self, request):
        """Raise the submit-time errors without mutating engine state."""
        if not isinstance(request, GenerationRequest):
            raise TypeError(
                f"submit() takes a GenerationRequest, got "
                f"{type(request).__name__}")
        prompt_len = int(np.asarray(request.prompt).reshape(-1).shape[0])
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if int(request.max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {request.max_new_tokens}")
        if prompt_len + int(request.max_new_tokens) > self.max_seq_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds the KV cache length "
                f"({self.max_seq_len}); raise max_seq_len or generate "
                f"fewer tokens")
        if request.timeout_s is not None and float(request.timeout_s) <= 0:
            raise ValueError(
                f"timeout_s must be > 0, got {request.timeout_s}")
        if request.priority_class is not None and \
                request.priority_class != self.classes.default:
            _not_ported(f"priority_class={request.priority_class!r}",
                        "Queue A step 9 (serving/policy)")

    def submit(self, request) -> Sequence:
        """Queue a request; returns its live Sequence handle."""
        self.validate(request)
        deadline = (time.monotonic() + float(request.timeout_s)
                    if request.timeout_s is not None else None)
        seq = Sequence(request, key=self._key_for(request), deadline=deadline)
        seq.pclass = self.classes.resolve(request.priority_class)
        seq.t_submit = self._clock()
        tr = self._tr()
        if tr is not None:
            seq.trace_mark = tr.now()
        self.scheduler.submit(seq)
        return seq

    def cancel(self, seq: Sequence) -> bool:
        """Retire a sequence with ``finish_reason="cancelled"`` — queued,
        mid-chunked-prefill or running. Must be called from the thread
        driving :meth:`step`. Returns False if it already finished."""
        if seq.done:
            return False
        if seq.status == "queued":
            if not self.scheduler.remove(seq):
                return False
        self.stats["cancelled"] += 1
        self._finish(seq, "cancelled", [])
        return True

    # ------------------------------------------------------------ stepping
    def _bucket(self, plen):
        if self._bucketing == "exact":
            return plen
        return min(max(8, 1 << (plen - 1).bit_length()), self.max_seq_len)

    def _admit_group(self, seqs, finished):
        """Admit a batch: a prompt longer than ``prefill_chunk`` claims its
        slot and enters chunked prefill; the rest take the cold path (ONE
        prefill call per prompt-length bucket)."""
        tr = self._tr()
        for seq in seqs:
            if tr is not None:
                # close the waiting span (queued, or preempted/recovered)
                self._trace_phase_end(tr, seq,
                                      args={"prefix_hit_tokens": 0})
            seq.trace_phase = "prefill"
        cold = []
        for seq in seqs:
            if self._chunk and seq.work_len > self._chunk:
                self._enter_chunked_prefill(seq)
            else:
                cold.append(seq)
        if cold:
            self._admit_cold(cold, finished)

    def _enter_chunked_prefill(self, seq):
        """Claim a slot for a long prompt without prefilling it yet: the
        prompt arrives chunk by chunk through the unified step."""
        slot = self.cache.alloc()
        seq.slot = slot
        seq.prefilled = 0
        self.cache.lengths[slot] = 0
        seq.status = "prefilling"
        if seq.t_admitted is None:
            seq.t_admitted = self._stamp_now()
        self._slots[slot] = seq
        self.scheduler.enter_prefill(seq)

    def _admit_cold(self, seqs, finished):
        by_bucket = {}
        for seq in seqs:
            by_bucket.setdefault(self._bucket(seq.work_len), []).append(seq)
        for s_pad, group in sorted(by_bucket.items()):
            G = len(group)
            Gp = 1 << (G - 1).bit_length()
            ids = np.zeros((Gp, s_pad), np.int32)
            lens = np.ones(Gp, np.int32)  # pad rows: 1 valid token
            temps = np.zeros(Gp, np.float32)
            topks = np.zeros(Gp, np.int32)
            keys = np.zeros((Gp, 2), np.int64)
            for i, seq in enumerate(group):
                ids[i, :seq.work_len] = seq.work
                lens[i] = seq.work_len
                temps[i] = float(seq.request.temperature)
                topks[i] = int(seq.request.top_k)
                keys[i] = np.asarray(seq.key)
            with self._tspan("prefill_launch",
                             args={"bucket": s_pad, "group": G}):
                pk, pv, tok0s, keys2 = self._prefill_fn()(
                    self._params, ids, lens, keys, temps, topks)
                tok0s = tok0s.cpu().numpy()
            keys2 = keys2.numpy()
            for i, seq in enumerate(group):
                seq.launches += 1       # rode this bucket's prefill
                slot = self.cache.alloc()
                seq.slot = slot   # before the write: a PoolExhausted
                # raised by the block growth must leave the claimed slot
                # findable for _abort_admission
                self.cache.write_prefill(slot, pk[:, i], pv[:, i],
                                         seq.work_len)
                self._install_seq(seq, slot, tok0s[i], keys2[i],
                                  seq.work_len, finished)

    def _advance_chunk(self, seq, n, tok0, key0, finished):
        """Per-chunk completion bookkeeping; ``tok0``/``key0`` are the
        chunk row's sample and advanced key, consumed only when this
        chunk completes the prompt."""
        slot, end = seq.slot, seq.prefilled + n
        seq.launches += 1               # rode this chunk's call
        self.stats["prefill_chunks"] += 1
        self.stats["chunk_tokens"] += n
        tr = self._tr()
        if tr is not None:
            tr.complete(f"prefill_chunk[{seq.trace_chunk_i}]",
                        seq.trace_mark, tid=tr.req_tid(seq.request_id),
                        args={"tokens": n, "offset": seq.prefilled})
            seq.trace_mark = tr.now()
            seq.trace_chunk_i += 1
        self.cache.lengths[slot] = end
        seq.prefilled = end
        if end == seq.work_len:
            self.scheduler.leave_prefill(seq)
            self._install_seq(seq, slot, tok0, key0, seq.work_len, finished)

    def _install_seq(self, seq, slot, tok0, key2, prefilled_tokens,
                     finished):
        """Post-prefill slot bookkeeping shared by the cold and chunked
        paths. A RESTORED sequence (``restore_point > 0``, recompute after
        preemption) adopts no sampled output: it resumes from its last
        streamed token with the key snapshot taken when it was
        displaced."""
        req = seq.request
        seq.slot = slot
        seq.status = "running"
        if seq.t_admitted is None:
            seq.t_admitted = self._stamp_now()
        tr = self._tr()
        if tr is not None:
            self._trace_phase_end(
                tr, seq, args={"prefix_hit_tokens": 0,
                               "restored": bool(seq.restore_point)})
        seq.trace_phase = "decode"
        self._slots[slot] = seq
        self._temps[slot] = float(req.temperature)
        self._topks[slot] = int(req.top_k)
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += int(prefilled_tokens)
        if seq.restore_point:
            self._last_tok[slot] = int(seq.tokens[-1])
            self._keys[slot] = np.asarray(seq.key, np.int64)
            return
        seq.tokens = [int(tok0)]
        self._last_tok[slot] = seq.tokens[0]
        self._keys[slot] = np.asarray(key2, np.int64)
        self.stats["tokens_generated"] += 1
        self._emit(seq, seq.tokens[0])
        self._maybe_finish(seq, finished)

    def _maybe_finish(self, seq, finished):
        req = seq.request
        t = seq.tokens[-1]
        if req.eos_token_id is not None and t == int(req.eos_token_id):
            self._finish(seq, "stop", finished)
        elif len(seq.tokens) >= int(req.max_new_tokens):
            self._finish(seq, "length", finished)

    def _finish(self, seq, reason, finished):
        if seq.status == "prefilling":
            self.scheduler.leave_prefill(seq)
        seq.status = "finished"
        seq.finish_reason = reason
        seq.t_finish = self._stamp_now()
        tr = self._tr()
        if tr is not None:
            self._trace_phase_end(
                tr, seq, args={"finish_reason": reason,
                               "tokens": len(seq.tokens)})
            tr.instant("finished", tid=tr.req_tid(seq.request_id),
                       args={"finish_reason": reason})
        slot = seq.slot
        if slot is not None and self._slots[slot] is seq:
            self._release_slot(slot)
        finished.append(seq)
        if self.on_finish is not None:
            self.on_finish(seq)

    def _release_slot(self, slot):
        """Slot teardown shared by retirement and preemption: reset the
        slot's knobs (a stale temperature would keep the sampler off its
        all-greedy fast path) and free its blocks."""
        self._slots[slot] = None
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._last_tok[slot] = 0
        self.cache.free(slot)

    def _expire_deadlines(self, seqs, finished):
        """Retire every sequence whose deadline has passed, queued or
        running."""
        now = time.monotonic()
        for seq in seqs:
            if seq.done or seq.deadline is None or now < seq.deadline:
                continue
            if seq.status == "queued" and not self.scheduler.remove(seq):
                continue
            self.stats["timeouts"] += 1
            self._finish(seq, "timeout", finished)

    def _stamp_now(self):
        """The current step's start reading inside a step, a fresh clock
        reading outside one (submit, cancel)."""
        return self._stamp_t if self._stamp_t is not None \
            else self._clock()

    def _emit(self, seq, token):
        if seq.t_first_token is None:
            seq.t_first_token = self._stamp_now()
        seq.t_last_token = self._stamp_now()
        if self.on_token is not None:
            self.on_token(seq, token)

    @torch.inference_mode()
    def step(self):
        """Admit + this step's chunk grant + decode, as ONE unified step,
        + retire. Runs under ``torch.inference_mode()``: the model's
        parameters are trainable, and serving records no graph. Returns
        every sequence this step finished, deadline expiries included.

        A :class:`~.kv_cache.PoolExhausted` raised in the step body is
        repaired here: the half-done admission goes back to the queue,
        the youngest slot-holding sequence is preempted by recompute, and
        the step retries without re-admitting. Anything else the
        ``fault_hook`` or the step raises propagates to the driver (the
        gateway's supervisor)."""
        t0 = self._clock()
        self._stamp_t = t0
        tr = self._tr()
        ts0 = tr.now() if tr is not None else None
        co = self._co()
        cost0 = co.snapshot() if co is not None else None
        finished = []
        self._expire_deadlines(
            list(self.scheduler.queue)
            + [s for s in self._slots if s is not None], finished)
        step_tokens, had_chunks = 0, False
        admitted = []
        for attempt in range(self.num_slots + 2):
            try:
                if self.fault_hook is not None:
                    self.fault_hook(self)
                if attempt == 0:
                    admitted = self.scheduler.admissions(self.cache.num_free)
                    if admitted:
                        if co is not None:
                            co.set_phase("admit")
                        with self._tspan("admit",
                                         args={"n": len(admitted)}):
                            self._admit_group(admitted, finished)
                if self._ragged:
                    step_tokens, had_chunks = self._unified_step(finished)
                else:
                    step_tokens, had_chunks = self._dense_step(finished)
                break
            except PoolExhausted:
                self._abort_admission(admitted)
                admitted = []
                if not self._preempt_youngest():
                    self._stamp_t = None
                    raise
            except BaseException:
                # no popped-but-uninstalled sequence may be stranded
                self._abort_admission(admitted)
                self._stamp_t = None
                raise
        self.stats["steps"] += 1
        self._record_step(self._clock() - t0, step_tokens, had_chunks)
        self._stamp_t = None
        if co is not None:
            co.set_phase(None)
        if tr is not None:
            tr.complete("step", ts0,
                        args={"step": self.stats["steps"] - 1,
                              "tokens": step_tokens,
                              "chunks": bool(had_chunks)})
            # counter tracks on the step timeline: pool occupancy and
            # table pressure, and this step's dispatch/transfer deltas
            if self._paged:
                tr.counter("kv_blocks", self.cache.occupancy())
                tr.counter("block_table_fill",
                           {"fill": round(self.cache.table_fill(), 6)})
            if co is not None:
                d = co.delta(cost0)
                tr.counter("dispatches",
                           {"per_step": d["dispatches"],
                            "compiles": d["compiles"]})
                tr.counter("transfer_bytes",
                           {"h2d": d["h2d_bytes"],
                            "d2h": d["d2h_bytes"]})
        return finished

    # ----------------------------------------------------- fault recovery
    def _abort_admission(self, seqs):
        """Unwind a half-done admission: every popped sequence not yet
        installed goes back to the queue HEAD in its FIFO order, its
        claimed slot freed."""
        tr = self._tr()
        for seq in sorted(seqs, key=lambda s: -s.queue_tick):
            if seq.status != "queued":
                continue
            if seq.slot is not None:
                if self._slots[seq.slot] is None:
                    self.cache.free(seq.slot)
                seq.slot = None
            if seq.trace_phase == "prefill":
                # back to a fresh queued span; the aborted attempt stays
                # visible as the closed span before it
                if tr is not None:
                    tr.instant("admission_aborted",
                               tid=tr.req_tid(seq.request_id))
                seq.trace_phase = "queued"
                seq.trace_mark = tr.now() if tr is not None else None
            self.scheduler.requeue_front(seq)

    def _preempt_youngest(self) -> bool:
        """PoolExhausted repair: displace the youngest slot-holding
        sequence. Returns False when there is none."""
        victims = [s for s in self._slots if s is not None and not s.done]
        if not victims:
            return False
        self._preempt(max(victims, key=lambda s: s.request_id))
        return True

    def _displace(self, seq, reason):
        """Slot teardown shared by preemption and :meth:`evict`: free the
        slot now and snapshot its current key (what the next decode tick
        would have sampled with), so a recompute resumes the same walk.
        A mid-recompute sequence keeps the snapshot it carries. Leaves the
        sequence slotless and unqueued."""
        slot = seq.slot
        tr = self._tr()
        if tr is not None:
            self._trace_phase_end(
                tr, seq, args={reason: True, "tokens": len(seq.tokens)})
            tr.instant(reason, tid=tr.req_tid(seq.request_id),
                       args={"slot": slot})
        if seq.status == "prefilling":
            self.scheduler.leave_prefill(seq)
        if seq.tokens and seq.status == "running":
            seq.key = self._keys[slot].copy()
        self._release_slot(slot)
        seq.slot = None

    def _preempt(self, seq):
        """Preemption by recompute: displace the sequence and re-queue it
        here through :meth:`restore`. Nothing is emitted; consumers see a
        pause."""
        self.stats["preemptions"] += 1
        self._displace(seq, "preempted")
        self.restore(seq)
        seq.trace_phase = "preempted"   # restore() named it "recovered"

    def evict(self, seq: Sequence) -> bool:
        """Remove a live sequence from this engine for re-admission by
        another engine's :meth:`restore` (same displacement as
        preemption, but ownership leaves the engine). A queued sequence
        is simply dequeued. Must be called from the thread driving
        :meth:`step`. Returns False for a finished sequence or one this
        engine does not hold."""
        if seq.done:
            return False
        if seq.status == "queued":
            return self.scheduler.remove(seq)
        if seq.slot is None or self._slots[seq.slot] is not seq:
            return False
        self._displace(seq, "evicted")
        seq.status = "queued"   # slotless, awaiting the target's restore
        return True

    def restore(self, seq: Sequence) -> bool:
        """Re-enqueue a live sequence for recovery by recompute (crash
        recovery and preemption both land here): its KV is rebuilt by
        prefilling ``prompt + tokens[:-1]``, after which decode resumes
        from the last generated token with the saved key walk, so the
        continuation is the one the sequence would have produced and no
        consumer sees a replayed token. Must be called from the thread
        driving :meth:`step`. Returns False for a finished sequence."""
        if seq.done:
            return False
        seq.status = "queued"
        seq.slot = None
        seq.prefilled = 0
        seq.restore_point = len(seq.tokens)
        tr = self._tr()
        seq.trace_phase = "recovered"
        seq.trace_mark = tr.now() if tr is not None else None
        if seq.tokens:
            seq.work = np.concatenate(
                [seq.prompt, np.asarray(seq.tokens[:-1], np.int32)])
        else:
            seq.work = seq.prompt
        self.stats["restores"] += 1
        self.scheduler.submit(seq)
        return True

    # ------------------------------------------------- headroom budgeting
    def _record_step(self, dt, tokens, had_chunks):
        """Feed the step's duration and processed tokens into the stats
        and the headroom EWMAs the adaptive chunk grant derives from."""
        self.stats["last_step_duration_s"] = float(dt)
        self.stats["last_step_tokens"] = int(tokens)
        if tokens <= 0 or dt <= 0:
            return
        a = 0.2
        if had_chunks:
            tps = tokens / dt
            self._tps_ewma = tps if self._tps_ewma is None \
                else (1 - a) * self._tps_ewma + a * tps
            self.stats["headroom_tps"] = self._tps_ewma
        else:
            self._dt_decode_ewma = dt if self._dt_decode_ewma is None \
                else (1 - a) * self._dt_decode_ewma + a * dt

    def _prefill_budget(self):
        """This step's chunk-token grant: ``headroom_tps x headroom_mult x
        decode-only step time`` minus the decode rows sharing the step,
        clamped to ``[1, prefill_chunk]``; the fixed cap until both EWMAs
        have a reading, or with ``headroom_mult=None``."""
        cap = self._chunk
        if self._headroom_mult is None or self._tps_ewma is None \
                or self._dt_decode_ewma is None:
            self.stats["headroom"] = cap
            return cap
        n_dec = sum(1 for s in self._slots
                    if s is not None and s.status == "running")
        afford = int(self._tps_ewma * self._headroom_mult
                     * self._dt_decode_ewma) - n_dec
        budget = max(1, min(cap, afford))
        self.stats["headroom"] = budget
        return budget

    # -------------------------------------------------------- unified step
    def _unified_step(self, finished):
        """ONE call for everything this step advances: every running slot
        a span-1 decode row, every planned prefill chunk a span-n row of
        the packed buffer (``decode._ragged_step_impl``). Pure-decode
        steps fuse ``choose_num_steps`` ticks. Returns
        ``(tokens_processed, had_chunks)`` for the headroom EWMAs."""
        tr = self._tr()
        tp0 = tr.now() if tr is not None else None
        co = self._co()
        if co is not None:
            co.set_phase("plan")
        plan = []
        if self._chunk and self.scheduler.num_prefilling:
            plan = self.scheduler.prefill_plan(self._prefill_budget(),
                                               self.cache.block_size,
                                               cap=self._chunk)
        active = [s for s in self._slots
                  if s is not None and s.status == "running"]
        if not active and not plan:
            return 0, False
        n = self.scheduler.choose_num_steps(active) if active else 1
        R, T = self.num_slots, self._token_budget
        ids = np.zeros(T, np.int32)
        seg = np.full(T, R, np.int32)       # sentinel: dead packed rows
        pos = np.zeros(T, np.int32)
        qstart = np.zeros(R, np.int32)
        qlen = np.zeros(R, np.int32)
        kvlen = np.zeros(R, np.int32)
        dec_mask = np.zeros(R, np.int32)
        temps = np.zeros(R, np.float32)
        topks = np.zeros(R, np.int32)
        keys = self._keys.copy()
        cursor = self._pack_decode_rows(n, ids, seg, pos, qstart, qlen,
                                        kvlen, dec_mask, temps, topks)
        chunk_rows, cursor = self._pack_chunk_rows(
            plan, cursor, ids, seg, pos, qstart, qlen, kvlen, keys,
            temps, topks)
        if tr is not None:
            # plan: the chunk grant + span packing; launch: the one
            # program + the host transfer that fences it; host-accept:
            # token and chunk bookkeeping
            tr.complete("plan", tp0,
                        args={"rows": len(active), "chunks": len(plan),
                              "fused_steps": n})
            tl0 = tr.now()
        if co is not None:
            co.set_phase("launch")
        pool = self.cache.pool
        _, _, toks, keys_t0, keys_fin = self._ragged_fn(n)(
            self._params, pool.k, pool.v, self.cache.tables, ids, seg, pos,
            qstart, qlen, kvlen, dec_mask, keys, temps, topks)
        toks_np = toks.cpu().numpy()        # [n, R]
        keys_t0_np = keys_t0.numpy()
        self.stats["unified_steps"] += 1
        if co is not None:
            co.set_phase("host-accept")
        if tr is not None:
            tr.complete("launch", tl0,
                        args={"packed_tokens": cursor, "fused_steps": n})
            th0 = tr.now()
        if active:
            # decode rows adopt the post-tail key walk; chunk/idle rows
            # keep their host key (a final chunk adopts its tick-0 key
            # inside _install_seq below)
            self._keys = np.where(dec_mask[:, None] > 0, keys_fin.numpy(),
                                  self._keys)
        for slot, seq, ntok, final in chunk_rows:
            self._advance_chunk(seq, ntok, toks_np[0, slot],
                                keys_t0_np[slot], finished)
        if active:
            self.stats["decode_calls"] += 1
            self.stats["decode_steps"] += n
            self.stats["slot_steps"] += n * self.num_slots
            for slot in range(self.num_slots):
                s = self._slots[slot]
                if s is not None and dec_mask[slot]:
                    s.launches += 1     # rode this step's one program
            self._accept_decode_rows(toks_np, n, dec_mask, finished)
        if tr is not None:
            tr.complete("host-accept", th0,
                        args={"emitted": (n * len(active) if active
                                          else 0)})
        return cursor + (n - 1) * len(active), bool(chunk_rows)

    def _dense_step(self, finished):
        """The dense engine's step: the decode half of the reference's
        two-program step (a dense engine never has a chunk plan): ONE
        call of ``decode._decode_steps_impl`` over every slot, fusing
        ``choose_num_steps`` ticks. Returns ``(tokens_processed,
        had_chunks)``."""
        tr = self._tr()
        tp0 = tr.now() if tr is not None else None
        co = self._co()
        if co is not None:
            co.set_phase("plan")
        active = [s for s in self._slots
                  if s is not None and s.status == "running"]
        n = self.scheduler.choose_num_steps(active) if active else 0
        if tr is not None:
            tr.complete("plan", tp0,
                        args={"rows": len(active), "chunks": 0,
                              "fused_steps": n})
            tl0 = tr.now()
        if not active:
            return 0, False
        if co is not None:
            co.set_phase("launch")
        toks, nk, nv, keys = self._decode_fn(n)(
            self._params, self.cache.k, self.cache.v, self._last_tok,
            self.cache.lengths, self._keys, self._temps, self._topks)
        self.cache.update(nk, nv)
        self._keys = keys.numpy()
        toks_np = toks.cpu().numpy()
        if co is not None:
            co.set_phase("host-accept")
        if tr is not None:
            tr.complete("launch", tl0, args={"fused_steps": n})
            th0 = tr.now()
        self.stats["decode_calls"] += 1
        self.stats["decode_steps"] += n
        self.stats["slot_steps"] += n * self.num_slots
        for s in active:
            s.launches += 1             # rode this one decode call
        # every running slot rode the call; the accept skips slots whose
        # sequence finished at an earlier tick
        self._accept_decode_rows(toks_np, n,
                                 np.ones(self.num_slots, np.int32), finished)
        if tr is not None:
            tr.complete("host-accept", th0,
                        args={"emitted": n * len(active)})
        return n * len(active), False

    def _pack_decode_rows(self, n, ids, seg, pos, qstart, qlen, kvlen,
                          dec_mask, temps, topks):
        """Pack every RUNNING slot's span-1 decode row into the packed
        buffer, pre-growing its table for the ``n`` fused ticks. Returns
        the cursor past the packed decode rows."""
        lens = self.cache.lengths
        cursor = 0
        for slot, s in enumerate(self._slots):
            if s is None or s.status != "running":
                continue
            self.cache.ensure_capacity(slot, int(lens[slot]) + n)
            qstart[slot] = cursor
            qlen[slot] = 1
            kvlen[slot] = int(lens[slot]) + 1
            dec_mask[slot] = 1
            ids[cursor] = self._last_tok[slot]
            seg[cursor] = slot
            pos[cursor] = int(lens[slot])
            temps[slot] = self._temps[slot]
            topks[slot] = self._topks[slot]
            cursor += 1
        return cursor

    def _accept_decode_rows(self, toks_np, n, dec_mask, finished):
        """Host-accept of the fused ticks' ``[n, R]`` token block, tick
        major; a slot whose sequence finished at an earlier tick is
        skipped from then on. Returns tokens emitted."""
        emitted = 0
        for i in range(n):
            for slot in range(self.num_slots):
                seq = self._slots[slot]
                if seq is None or seq.status != "running" \
                        or not dec_mask[slot]:
                    continue
                t = int(toks_np[i, slot])
                seq.tokens.append(t)
                self.cache.lengths[slot] += 1
                self._last_tok[slot] = t
                self.stats["active_slot_steps"] += 1
                self.stats["tokens_generated"] += 1
                emitted += 1
                self._emit(seq, t)
                self._maybe_finish(seq, finished)
        return emitted

    def _pack_chunk_rows(self, plan, cursor, ids, seg, pos, qstart, qlen,
                         kvlen, keys, temps, topks):
        """Pack this step's planned prefill chunks into the packed buffer.
        A chunk row samples (and advances its key) only on its FINAL
        chunk, so the stream equals a one-shot prefill's. Returns
        ``(chunk_rows, cursor)``."""
        chunk_rows = []                     # (slot, seq, n_tokens, final)
        for seq, ntok in plan:
            slot, off = seq.slot, seq.prefilled
            self.cache.ensure_capacity(slot, off + ntok)
            final = off + ntok == seq.work_len
            qstart[slot] = cursor
            qlen[slot] = ntok
            kvlen[slot] = off + ntok
            ids[cursor:cursor + ntok] = seq.work[off:off + ntok]
            seg[cursor:cursor + ntok] = slot
            pos[cursor:cursor + ntok] = np.arange(off, off + ntok,
                                                  dtype=np.int32)
            keys[slot] = np.asarray(seq.key, np.int64)
            if final:
                temps[slot] = float(seq.request.temperature)
                topks[slot] = int(seq.request.top_k)
            chunk_rows.append((slot, seq, ntok, final))
            cursor += ntok
        return chunk_rows, cursor

    def has_work(self) -> bool:
        return bool(self.scheduler.num_queued
                    or any(s is not None for s in self._slots))

    # ------------------------------------------------------------- offline
    def generate(self, requests):
        """Submit all, run to completion, return each request's
        :class:`GenerationResult` in submission order."""
        seqs = [self.submit(r) for r in requests]
        while self.has_work():
            self.step()
        return [GenerationResult(s.output_ids(), s.finish_reason,
                                 s.request_id) for s in seqs]
