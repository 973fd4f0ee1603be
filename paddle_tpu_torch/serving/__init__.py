"""Continuous-batching serving: the default unified ragged engine, its
fused-tick, two-program, multi-tick and dense-slot variants (see
engine.py), the prefix cache (prefix_cache.py), the fault injection
harness (faults.py) and the HTTP gateway (server/)."""
from .block_manager import BlockManager  # noqa: F401
from .engine import ContinuousBatchingEngine  # noqa: F401
from .faults import (FatalFault, FaultPlan, TransientFault,  # noqa: F401
                     VirtualClock)
from .kv_cache import PagedKVCache, PoolExhausted, SlotKVCache  # noqa: F401
from .prefix_cache import PrefixCache  # noqa: F401
from .request import (FINISH_REASONS, GenerationRequest,  # noqa: F401
                      GenerationResult, Sequence)
from .scheduler import FIFOScheduler  # noqa: F401
