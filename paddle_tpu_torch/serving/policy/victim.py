"""Preemption victim selection — the port's own copy of
``paddle_tpu/serving/policy/victim.py``.

When an SLO-urgent request cannot admit (no free KV slot and no
reclaimable headroom), the policy layer displaces running work through
the engine's preempt/restore path, which donates the victim's chain,
snapshots its PRNG key and re-derives the exact continuation, so a
victim's stream stays the same after it restores. This module only
decides WHO: pure functions of the slot array, no clock reads, no engine
state mutation, so victim choice replays deterministically under a
VirtualClock.

Ordering — (lowest class, most-recently-admitted, least-lost-work):

1. lowest class rank first — batch pays before standard, standard
   before latency, and NOTHING at or above the urgent request's own
   rank is ever a candidate (preemption authority is the true class
   rank, never the aged admission rank);
2. most-recently-admitted first — the newest admission has the least
   decode momentum and, under the aging rule, the most queue patience
   left when it re-queues;
3. least generated tokens first — preemption-by-recompute replays the
   victim's accepted tokens as prefill work, so fewer tokens lost is
   less recompute donated back;
4. highest request_id first — a pure determinism tiebreak.
"""
from __future__ import annotations


def victim_key(seq):
    """Sort key implementing the (lowest class, most-recently-admitted,
    least-lost-work) order; ``min()`` / ``sorted()`` over candidates
    picks the cheapest victim first."""
    pclass = getattr(seq, "pclass", None)
    rank = pclass.rank if pclass is not None else 0
    admitted = seq.t_admitted if seq.t_admitted is not None else 0.0
    return (rank, -admitted, len(seq.tokens), -seq.request_id)


def select_victims(slots, need, below_rank):
    """The ``need`` cheapest preemption victims among running
    sequences of class rank strictly below ``below_rank``.

    ``slots`` is the engine's slot array (None = free). Finished
    sequences are skipped — they release their slot at teardown without
    help. Returns fewer than ``need`` (possibly none) when the running
    set has nothing below the urgent rank: a latency burst can starve
    BEHIND other latency work, and that is correct — equals never
    displace equals, or two urgent requests would thrash each other's
    slots forever."""
    if need <= 0:
        return []
    candidates = []
    for seq in slots:
        if seq is None or seq.done:
            continue
        pclass = getattr(seq, "pclass", None)
        rank = pclass.rank if pclass is not None else 0
        if rank < below_rank:
            candidates.append(seq)
    candidates.sort(key=victim_key)
    return candidates[:need]
