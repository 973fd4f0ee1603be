"""Continuous-batching serving: the default unified ragged engine, its
fused-tick, two-program, multi-tick, speculative and dense-slot variants
(see engine.py), the drafters (drafter.py), the prefix cache and its
host-RAM spill tier (prefix_cache.py), the multi-tenant policy (policy/),
the engine fleet (fleet/),
the fault injection harness (faults.py) and the HTTP gateway (server/)."""
from .block_manager import BlockManager  # noqa: F401
from .drafter import Drafter, ModelDrafter, NgramDrafter  # noqa: F401
from .engine import ContinuousBatchingEngine  # noqa: F401
from .faults import (FatalFault, FaultPlan, TransientFault,  # noqa: F401
                     VirtualClock)
from .kv_cache import PagedKVCache, PoolExhausted, SlotKVCache  # noqa: F401
from .policy import ClassTable, PolicyScheduler, PriorityClass  # noqa: F401
from .prefix_cache import HostTier, PrefixCache  # noqa: F401
from .request import (FINISH_REASONS, GenerationRequest,  # noqa: F401
                      GenerationResult, Sequence)
from .scheduler import FIFOScheduler  # noqa: F401
