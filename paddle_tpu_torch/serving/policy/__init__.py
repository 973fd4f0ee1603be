"""Multi-tenant SLO policy layer: the class table the gateway labels by
(:mod:`.classes`). The port serves the neutral single-class table only;
the admission and preemption policy that acts on an active table is
ROADMAP Queue A step 9 (serving/policy)."""
from .classes import ClassTable

__all__ = ["ClassTable"]
