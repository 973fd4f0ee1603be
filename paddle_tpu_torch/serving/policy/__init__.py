"""Multi-tenant SLO policy layer — the port of ``paddle_tpu/serving/policy``.

Priority classes with TTFT/TPOT targets (:mod:`.classes`),
deadline-aware admission with per-class headroom and anti-starvation
aging (:mod:`.admission`), and preemption victim selection
(:mod:`.victim`). Policy, not geometry: nothing here touches a program's
shapes or its cache key, and the default single-class table keeps the
engine on the plain FIFO scheduler.
"""
from .classes import DEFAULT_CLASS_NAME, ClassTable, PriorityClass
from .admission import PolicyScheduler
from .victim import select_victims, victim_key

__all__ = [
    "DEFAULT_CLASS_NAME",
    "ClassTable",
    "PriorityClass",
    "PolicyScheduler",
    "select_victims",
    "victim_key",
]
