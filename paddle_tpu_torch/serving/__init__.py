"""Continuous-batching serving on the default geometry (see engine.py)."""
from .engine import ContinuousBatchingEngine  # noqa: F401
from .kv_cache import PagedKVCache, PoolExhausted  # noqa: F401
from .request import (FINISH_REASONS, GenerationRequest,  # noqa: F401
                      GenerationResult, Sequence)
from .scheduler import FIFOScheduler  # noqa: F401
