"""Deadline-aware admission: the :class:`PolicyScheduler` — the port's own
copy of ``paddle_tpu/serving/policy/admission.py``.

Extends the engine's :class:`~..scheduler.FIFOScheduler`
so that when a multi-class table is active, admission order becomes
(effective class rank, TTFT deadline slack, FIFO tick) instead of pure
FIFO, per-class slot headroom is enforced, and the scheduler can name
which queued requests are SLO-urgent enough to justify preempting
running best-effort work. Everything else — chunked-prefill budgeting,
spec grants, fused-step choice, the ``queue`` deque identity the
gateway snapshots — is inherited unchanged, and the queue object is
only ever mutated IN PLACE (``remove`` / ``append``), never replaced.

The scheduler reads time through an injected clock (the engine's own,
a :class:`~..faults.VirtualClock` in tests), so admission order and
urgency replay deterministically.

Effective rank = true class rank + ⌊waited / aging_s⌋ — the
anti-starvation rule: a batch request that has waited one aging
quantum competes like standard, two like latency, so best-effort
traffic always drains. Aging affects ADMISSION ORDER only; preemption
authority (:mod:`.victim`) always uses the true class rank.
"""
from __future__ import annotations

from .classes import ClassTable
from ..scheduler import FIFOScheduler


class PolicyScheduler(FIFOScheduler):
    """Class-and-deadline-aware admission over the FIFO baseline.

    ``table`` is the engine's :class:`~.classes.ClassTable`; ``clock``
    a zero-arg callable returning seconds (the engine's injected
    clock). ``slot_usage`` is a zero-arg callable returning
    ``{class_name: running_count}`` for the headroom ledger — the
    engine binds it to a walk of its slot array. ``urgency_frac`` is
    the fraction of a class's TTFT budget a queued request may burn
    waiting before it is URGENT (preemption-eligible): 0.5 means the
    policy moves at half the budget, leaving the other half for the
    victim's displacement and the prefill itself.
    """

    def __init__(self, decode_chunk=8, table=None, clock=None,
                 slot_usage=None, urgency_frac=0.5):
        super().__init__(decode_chunk)
        self.table = table if table is not None else ClassTable.single()
        self.clock = clock if clock is not None else (lambda: 0.0)
        self.slot_usage = slot_usage
        if not (0.0 < float(urgency_frac) <= 1.0):
            raise ValueError(
                f"urgency_frac must be in (0, 1], got {urgency_frac}")
        self.urgency_frac = float(urgency_frac)
        # guard-discipline: the scheduler records admission decisions
        # through the same nullable tracer idiom as the engine — the
        # engine syncs this alias at the top of every step
        self.tracer = None

    def _tr(self):
        """Tracer alias for this decision (None = recording off)."""
        return self.tracer

    # ------------------------------------------------------ priority core
    def _pclass(self, seq):
        pclass = getattr(seq, "pclass", None)
        return pclass if pclass is not None else self.table.resolve(None)

    def _waited(self, seq, now):
        t = getattr(seq, "t_submit", None)
        return max(0.0, now - t) if t is not None else 0.0

    def slack_s(self, seq, now=None):
        """TTFT deadline slack in seconds: target minus time already
        waited (negative = already past target; +inf = no target)."""
        if now is None:
            now = self.clock()
        pclass = self._pclass(seq)
        if pclass.ttft_slo_s is None:
            return float("inf")
        return pclass.ttft_slo_s - self._waited(seq, now)

    def effective_rank(self, seq, now):
        """True class rank plus the anti-starvation aging credit."""
        rank = self._pclass(seq).rank
        if self.table.aging_s:
            rank += int(self._waited(seq, now) / self.table.aging_s)
        return rank

    def _priority_key(self, now):
        """Admission sort key, most-deserving FIRST under ascending
        sort: (-effective rank, deadline slack, FIFO tick). Within a
        rank the tightest TTFT deadline goes first; with equal slack
        (e.g. two no-target classes at inf) seniority decides, which
        collapses to exact FIFO inside any single class."""
        def key(seq):
            return (-self.effective_rank(seq, now),
                    self.slack_s(seq, now),
                    getattr(seq, "queue_tick", 0))
        return key

    # -------------------------------------------------------- admission
    def admissions(self, num_free, hit_len_fn=None):
        """Pop up to ``num_free`` sequences in priority order, holding
        back reserved headroom.

        Headroom: a class with ``reserved_slots = k`` keeps
        ``max(0, k - running_k)`` slots off-limits to every OTHER
        class, so a best-effort flood can never occupy the whole
        engine. A class always admits into its own reservation first;
        admission of any class stops when the remaining free slots
        would dip below the headroom owed to everyone else. The
        admitted set is then handed to the same prefix-hit bookkeeping
        and uncovered-suffix ordering as the FIFO baseline, so slot
        assignment math downstream is unchanged."""
        tr = self._tr()
        now = self.clock()
        used = dict(self.slot_usage()) if self.slot_usage is not None else {}
        ordered = sorted(self.queue, key=self._priority_key(now))
        out = []
        for seq in ordered:
            if len(out) >= num_free:
                break
            pclass = self._pclass(seq)
            # headroom owed to OTHER classes after this admission
            owed = 0
            for c in self.table:
                if c.name == pclass.name or not c.reserved_slots:
                    continue
                owed += max(0, c.reserved_slots - used.get(c.name, 0))
            free_after = num_free - len(out) - 1
            if free_after < owed:
                if tr is not None:
                    tr.instant("policy.headroom_hold",
                               cls=pclass.name, owed=owed)
                continue    # later (lower-priority) classes may still fit
            out.append(seq)
            used[pclass.name] = used.get(pclass.name, 0) + 1
        for seq in out:
            self.queue.remove(seq)     # in place: gateway snapshots self.queue
        if hit_len_fn is not None:
            for seq in out:
                seq.prefix_hit_tokens = int(hit_len_fn(seq))
            if len(out) > 1:
                out.sort(key=lambda s: s.work_len - s.prefix_hit_tokens)
        return out

    # -------------------------------------------------------- preemption
    def urgent(self, now=None):
        """Queued sequences at risk of missing their TTFT target:
        waited past ``urgency_frac`` of the class budget. Sorted by the
        same priority key as admission, so the engine services the
        most-deserving urgency first. Requests with no TTFT target are
        never urgent — a class without a deadline never displaces
        anyone."""
        if now is None:
            now = self.clock()
        hot = []
        for seq in self.queue:
            pclass = self._pclass(seq)
            if pclass.ttft_slo_s is None:
                continue
            if self._waited(seq, now) >= pclass.ttft_slo_s * self.urgency_frac:
                hot.append(seq)
        hot.sort(key=self._priority_key(now))
        return hot
