"""Admission + step-size policy for the continuous-batching engine (the
port's own copy of ``paddle_tpu/serving/scheduler.py``'s
``FIFOScheduler``).

Orca-style iteration-level scheduling (PAPERS.md): the schedulable unit
is ONE decode step, so a request can join or leave the batch between any
two steps. The FIFO policy here does two jobs:

- **Admission**: pop queued sequences into free cache slots, oldest
  first, at the top of every engine step.
- **Prefill budgeting** (chunked prefill, README "Chunked prefill"):
  sequences whose uncovered prompt exceeds the engine's
  ``prefill_chunk`` enter a PREFILLING pipeline instead of running one
  monopolizing device call; :meth:`FIFOScheduler.prefill_plan` hands
  the engine at most ``budget`` prompt tokens of that backlog per step,
  oldest sequence first, with non-final chunk boundaries aligned to the
  KV block size — so every step still runs the fused decode tick for
  all live slots and no decode batch ever waits behind an entire long
  prompt.
- **Chunk fusion**: when nothing schedulable can change for a while
  (queue empty, no prefill backlog), tell the engine to run several
  decode steps in one engine step (the fused tail ticks of the
  unified step) — the largest power of two fitting both ``decode_chunk``
  and every active sequence's remaining budget. This amortizes per-step
  host work (admission, packing, token accept) without ever delaying
  an admission or a pending prefill chunk: any queued request or
  in-flight prefill forces single-stepping. Step sizes stay in
  ``{1, 2, 4, …, decode_chunk}``.

EOS is the one event a fused chunk cannot see coming; a sequence that
hits EOS mid-chunk wastes the chunk's tail tokens (they are computed and
discarded). That is the standard multi-step-scheduling trade — bound it
by keeping ``decode_chunk`` modest, or set it to 1 to disable fusion.
"""
from __future__ import annotations

import itertools
from collections import deque


class FIFOScheduler:
    """First-come-first-served admission; fused chunks when safe."""

    def __init__(self, decode_chunk: int = 8):
        self.decode_chunk = max(int(decode_chunk), 1)
        self.queue = deque()
        self.prefilling = deque()   # admitted, mid-chunked-prefill (FIFO)
        self._plan_carry = 0        # sub-block budget owed to the plan head
        self._intake = itertools.count()  # FIFO seniority stamps

    def submit(self, seq):
        # the tick, not request_id, is the queue-order authority: a
        # sequence re-enqueued for recovery (engine.restore) keeps its
        # old id but arrives at its NEW queue position
        seq.queue_tick = next(self._intake)
        self.queue.append(seq)

    @property
    def num_queued(self) -> int:
        return len(self.queue)

    @property
    def num_prefilling(self) -> int:
        return len(self.prefilling)

    # ------------------------------------------------- chunked prefill
    def enter_prefill(self, seq):
        """Admission handed ``seq`` a slot but its uncovered prompt is
        too long for one call: queue it for per-step chunking."""
        self.prefilling.append(seq)

    def leave_prefill(self, seq) -> bool:
        """Drop a sequence from the prefill pipeline (final chunk done,
        cancellation, or deadline expiry). Returns whether it was
        there. An emptied pipeline clears the plan carry eagerly: the
        engine stops calling :meth:`prefill_plan` while nothing is
        prefilling, so without this a sub-block grant banked against a
        cancelled prompt would leak into a LATER unrelated prompt's
        first chunk grant."""
        try:
            self.prefilling.remove(seq)
            if not self.prefilling:
                self._plan_carry = 0
            return True
        except ValueError:
            return False

    def prefill_plan(self, budget: int, align: int = 1, cap=None):
        """This step's chunk assignments: ``[(seq, n_tokens), ...]``,
        oldest PREFILLING sequence first, spending at most ``budget``
        prompt tokens total. A sequence's chunk is capped at its
        remaining uncovered prompt; a NON-final chunk end is rounded
        down to an ``align`` (KV block size) boundary so a partially
        prefilled prompt is always a whole-block prefix plus a host
        resume offset — leftover budget smaller than one block stops
        the plan rather than splitting a block. A grant too small to
        release even one block is not LOST, though: it carries to the
        next step's plan head (capped at one block), so a throttled
        per-step budget — e.g. the engine's headroom-adaptive grant
        under heavy decode load — still accumulates into whole-block
        progress instead of starving the pipeline behind one misaligned
        prompt. Sequences stay queued until :meth:`leave_prefill`; FIFO
        order is never reshuffled, so a long prompt cannot be starved
        by later arrivals. ``cap`` bounds the carried total: the
        engine's packed token buffer is
        sized for at most ``cap`` chunk tokens per step, so a banked
        carry must never push a full-cap grant past it — the carry only
        ever matters when the grant is throttled BELOW the cap."""
        budget = int(budget) + self._plan_carry
        if cap is not None:
            budget = min(budget, int(cap))
        self._plan_carry = 0
        plan = []
        for seq in self.prefilling:
            if budget <= 0:
                break
            # work_len, not prompt_len: a sequence restored for
            # recovery-by-recompute chunks through prompt + generated
            # content (engine.restore), a fresh one through its prompt
            remaining = seq.work_len - seq.prefilled
            n = min(budget, remaining)
            if n < remaining:           # non-final: block-align the cut
                n -= (seq.prefilled + n) % align
                if n <= 0:
                    break
            plan.append((seq, n))
            budget -= n
        if not plan and self.prefilling:
            # blocked head: bank the sub-block grant for the next step
            self._plan_carry = min(budget, int(align))
        return plan

    def spec_grants(self, wants, budget):
        """Per-slot DRAFT-token grants for a speculative verify step: each
        running slot's verify span spends ``1 + grant`` positions of the
        step's packed buffer, and the drafts share its headroom with the
        chunk grant — ``budget`` is what the chunk plan left. Greedy in
        the given (slot) order, each grant capped at its row's request.
        Returns a list aligned with ``wants``."""
        b = max(int(budget), 0)
        grants = []
        for want in wants:
            g = min(max(int(want), 0), b)
            grants.append(g)
            b -= g
        return grants

    def admissions(self, num_free: int, hit_len_fn=None):
        """Sequences to admit this step: up to ``num_free`` from the FIFO
        head.

        ``hit_len_fn(seq) -> int`` is the prefix-cache lookup: the
        engine's hook records the hit, pins the matched chain (nothing
        this step does can evict it before install) and returns the
        covered token count, stored on ``seq.prefix_hit_tokens``. The
        admitted SET stays the FIFO head; with the hook the batch is then
        ordered by ascending uncovered length (a stable sort, so equal
        suffixes keep FIFO order). Without it, arrival order."""
        out = []
        while self.queue and len(out) < num_free:
            out.append(self.queue.popleft())
        if hit_len_fn is not None:
            for seq in out:
                seq.prefix_hit_tokens = int(hit_len_fn(seq))
            if len(out) > 1:
                # work_len: a restored sequence re-prefills its prompt
                # plus its generated tokens
                out.sort(key=lambda s: s.work_len - s.prefix_hit_tokens)
        return out

    def remove(self, seq) -> bool:
        """Drop a still-queued sequence (cancellation / deadline expiry
        before admission). Returns whether it was found."""
        try:
            self.queue.remove(seq)
            return True
        except ValueError:
            return False

    def requeue_front(self, seq):
        """Put an admission-aborted sequence back at the queue HEAD
        (the engine's PoolExhausted repair path): it was popped this
        step but never installed, so restoring its FIFO position keeps
        admission order deterministic under preemption retries."""
        self.queue.appendleft(seq)

    def choose_num_steps(self, active_seqs) -> int:
        """How many decode steps to fuse into the next device call:
        the largest power of two that fits both ``decode_chunk`` and
        every active sequence's remaining budget. Powers of two keep the
        compiled step-size set bounded (⊆ {1, 2, 4, …, decode_chunk})
        while letting a near-finished batch still fuse most of its tail
        instead of falling back to single-stepping. EOS-enabled
        sequences may finish early inside a chunk (tail discarded).
        In-flight chunked prefills also force single-stepping: fusing n
        decode ticks would delay the next prompt chunk by n-1 ticks,
        exactly the TTFT head-of-line blocking chunking exists to
        remove."""
        if self.decode_chunk == 1 or self.queue or self.prefilling \
                or not active_seqs:
            return 1
        m = min(s.remaining for s in active_seqs)
        n = 1
        while n * 2 <= min(m, self.decode_chunk):
            n *= 2
        return n

    def choose_decode_ticks(self, active_seqs, max_ticks: int) -> int:
        """How many decode ticks the next multi-tick step runs behind one
        host sync (engine ``decode_ticks > 1``). The tick count is a
        runtime argument with EOS/budget retirement masked on the device,
        so the choice is latency policy only:

        - a prefill backlog clamps it to 1 (n ticks would delay the next
          prompt chunk by n - 1 ticks);
        - a waiting queue shrinks it to the smallest active remaining
          budget, so the earliest guaranteed retirement lands on a sync
          boundary;
        - otherwise it runs to the largest active remaining budget,
          capped at ``max_ticks``: near-finished rows retire on the
          device mid-block.
        """
        if max_ticks <= 1 or self.prefilling or not active_seqs:
            return 1
        horizon = (min if self.queue else max)(
            s.remaining for s in active_seqs)
        return max(1, min(int(max_ticks), horizon))
