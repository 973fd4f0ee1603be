"""Continuous-batching serving: the default unified ragged engine, its
fused-tick variant and the dense-slot engine (see engine.py), the fault
injection harness (faults.py) and the HTTP gateway (server/)."""
from .engine import ContinuousBatchingEngine  # noqa: F401
from .faults import (FatalFault, FaultPlan, TransientFault,  # noqa: F401
                     VirtualClock)
from .kv_cache import PagedKVCache, PoolExhausted, SlotKVCache  # noqa: F401
from .request import (FINISH_REASONS, GenerationRequest,  # noqa: F401
                      GenerationResult, Sequence)
from .scheduler import FIFOScheduler  # noqa: F401
