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

Offline use::

    engine = ContinuousBatchingEngine(model, num_slots=8)
    outs = engine.generate([GenerationRequest(prompt=ids, ...), ...])

Every knob off the default geometry raises ``NotImplementedError`` naming
the ROADMAP item that ports it. The JAX engine's tracer and cost
observatory hooks are not ported yet (ROADMAP Queue A step 8).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core import random as prng
from ..models.llama import llama_decode_params
from .decode import _prefill_impl, _ragged_step_impl
from .kv_cache import PagedKVCache, PoolExhausted
from .request import GenerationRequest, GenerationResult, Sequence
from .scheduler import FIFOScheduler


def _not_ported(knob, item):
    raise NotImplementedError(
        f"{knob} is not ported to paddle_tpu_torch yet (ROADMAP {item}); "
        f"this engine serves the default geometry only")


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
                 prefix_cache=False, prefix_block_size=32, paged_attn=True,
                 prefill_chunk=512, ragged_step=True, headroom_mult=2.0,
                 spec_decode=False, decode_ticks=1, kv_dtype=None,
                 quantize_weights=False, quantize_activations=False, tp=1,
                 host_tier_bytes=0, priority_classes=None, fused_tick=False,
                 collective_overlap=False):
        c = model.config
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
        if priority_classes is not None:
            _not_ported("priority_classes",
                        "Queue A step 9 (serving/policy)")
        if fused_tick:
            _not_ported("fused_tick", "Queue B item 4 (fused decode tick)")
        if not paged_attn:
            _not_ported("paged_attn=False",
                        "Queue A step 11 (dense-slot path)")
        if not ragged_step:
            _not_ported("ragged_step=False",
                        "Queue A step 9 (two-program step)")
        self.model = model
        self.config = c
        self.num_slots = int(num_slots)
        self.max_seq_len = int(max_seq_len or c.max_position_embeddings)
        self._params, self._tied = llama_decode_params(model)
        bs = int(prefix_block_size)
        if bs < 1:
            raise ValueError(f"prefix_block_size must be >= 1, got {bs}")
        self.cache = PagedKVCache(
            c.num_hidden_layers, self.num_slots, self.max_seq_len,
            c.num_key_value_heads, c.head_dim,
            dtype=self._params["embed"].dtype, block_size=bs,
            device=model.device)
        # chunked prefill: the chunk rounds UP to a block multiple so
        # every non-final chunk boundary is block-aligned
        self._chunk = None
        if prefill_chunk and int(prefill_chunk) < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 (or None/0 to disable), "
                f"got {int(prefill_chunk)}")
        if prefill_chunk:
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
        # the current step's start reading: latency stamps quantize to it
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
        # seeds for requests that carry neither seed nor key
        self._seed_rng = np.random.default_rng()
        self.stats = {"steps": 0, "decode_calls": 0, "decode_steps": 0,
                      "slot_steps": 0, "active_slot_steps": 0,
                      "prefills": 0, "prefill_tokens": 0,
                      "prefill_chunks": 0, "chunk_tokens": 0,
                      "unified_steps": 0,
                      "headroom": self._chunk or 0, "headroom_tps": 0.0,
                      "last_step_duration_s": 0.0, "last_step_tokens": 0,
                      "tokens_generated": 0, "cancelled": 0, "timeouts": 0,
                      "preemptions": 0, "restores": 0}
        # fault-injection hook: called with the engine at the top of every
        # step attempt; a PoolExhausted it raises is repaired by
        # preemption, anything else propagates
        self.fault_hook = None

    # ------------------------------------------------------------ programs
    def _fn_consts(self):
        c = self.config
        return dict(nh=c.num_attention_heads, nkv=c.num_key_value_heads,
                    hd=c.head_dim, eps=float(c.rms_norm_eps),
                    theta=float(c.rope_theta), tied=self._tied)

    # ------------------------------------------------------------- intake
    def _key_for(self, request):
        if request.prng_key is not None:
            return np.asarray(request.prng_key, np.int64).reshape(2)
        seed = request.seed
        if seed is None:
            seed = int(self._seed_rng.integers(0, 2 ** 32))
        return prng.PRNGKey(int(seed)).numpy()

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
        if request.priority_class is not None:
            _not_ported("priority_class", "Queue A step 9 (serving/policy)")

    def submit(self, request) -> Sequence:
        """Queue a request; returns its live Sequence handle."""
        self.validate(request)
        deadline = (time.monotonic() + float(request.timeout_s)
                    if request.timeout_s is not None else None)
        seq = Sequence(request, key=self._key_for(request), deadline=deadline)
        seq.t_submit = time.perf_counter()
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
        return min(max(8, 1 << (plen - 1).bit_length()), self.max_seq_len)

    def _admit_group(self, seqs, finished):
        """Admit a batch: a prompt longer than ``prefill_chunk`` claims its
        slot and enters chunked prefill; the rest take the cold path (ONE
        prefill call per prompt-length bucket)."""
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
            pk, pv, tok0s, keys2 = _prefill_impl(
                self._params, ids, lens, keys, temps, topks,
                **self._fn_consts())
            tok0s = tok0s.cpu().numpy()
            keys2 = keys2.numpy()
            for i, seq in enumerate(group):
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
        self.stats["prefill_chunks"] += 1
        self.stats["chunk_tokens"] += n
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
        self._emit(seq)
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
        slot = seq.slot
        if slot is not None and self._slots[slot] is seq:
            self._release_slot(slot)
        finished.append(seq)

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
        return self._stamp_t if self._stamp_t is not None \
            else time.perf_counter()

    def _emit(self, seq):
        if seq.t_first_token is None:
            seq.t_first_token = self._stamp_now()
        seq.t_last_token = self._stamp_now()

    @torch.inference_mode()
    def step(self):
        """Admit + this step's chunk grant + decode, as ONE unified step,
        + retire. Runs under ``torch.inference_mode()``: the model's
        parameters are trainable, and serving records no graph. Returns every sequence this step finished, deadline
        expiries included.

        A :class:`~.kv_cache.PoolExhausted` raised in the step body is
        repaired here: the half-done admission goes back to the queue,
        the youngest slot-holding sequence is preempted by recompute, and
        the step retries without re-admitting."""
        t0 = time.perf_counter()
        self._stamp_t = t0
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
                        self._admit_group(admitted, finished)
                step_tokens, had_chunks = self._unified_step(finished)
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
        self._record_step(time.perf_counter() - t0, step_tokens, had_chunks)
        self._stamp_t = None
        return finished

    # ----------------------------------------------------- fault recovery
    def _abort_admission(self, seqs):
        """Unwind a half-done admission: every popped sequence not yet
        installed goes back to the queue HEAD in its FIFO order, its
        claimed slot freed."""
        for seq in sorted(seqs, key=lambda s: -s.queue_tick):
            if seq.status != "queued":
                continue
            if seq.slot is not None:
                if self._slots[seq.slot] is None:
                    self.cache.free(seq.slot)
                seq.slot = None
            self.scheduler.requeue_front(seq)

    def _preempt_youngest(self) -> bool:
        """PoolExhausted repair: displace the youngest slot-holding
        sequence. Returns False when there is none."""
        victims = [s for s in self._slots if s is not None and not s.done]
        if not victims:
            return False
        self._preempt(max(victims, key=lambda s: s.request_id))
        return True

    def _preempt(self, seq):
        """Preemption by recompute: free the slot, snapshot the slot's
        key (what its next tick would have sampled with) and re-queue the
        sequence through :meth:`restore`."""
        self.stats["preemptions"] += 1
        slot = seq.slot
        if seq.status == "prefilling":
            self.scheduler.leave_prefill(seq)
        if seq.tokens and seq.status == "running":
            seq.key = self._keys[slot].copy()
        self._release_slot(slot)
        seq.slot = None
        self.restore(seq)

    def restore(self, seq: Sequence) -> bool:
        """Re-enqueue a live sequence for recovery by recompute: its KV is
        rebuilt by prefilling ``prompt + tokens[:-1]``, after which decode
        resumes from the last generated token with the saved key walk.
        Returns False for an already-finished sequence."""
        if seq.done:
            return False
        seq.status = "queued"
        seq.slot = None
        seq.prefilled = 0
        seq.restore_point = len(seq.tokens)
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
        pool = self.cache.pool
        _, _, toks, keys_t0, keys_fin = _ragged_step_impl(
            self._params, pool.k, pool.v, self.cache.tables, ids, seg, pos,
            qstart, qlen, kvlen, dec_mask, keys, temps, topks, n_steps=n,
            **self._fn_consts())
        toks_np = toks.cpu().numpy()        # [n, R]
        keys_t0_np = keys_t0.numpy()
        self.stats["unified_steps"] += 1
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
            self._accept_decode_rows(toks_np, n, dec_mask, finished)
        return cursor + (n - 1) * len(active), bool(chunk_rows)

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
                self._emit(seq)
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
