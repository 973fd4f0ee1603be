"""Ref-counted physical block pool: the KV storage of the paged engine.

The port of ``paddle_tpu/serving/block_manager.py``'s ``BlockManager`` on
the default geometry: two device tensors ``[L, num_blocks, block_size,
Hkv, D]`` at the model dtype, plus host bookkeeping — a free-block
min-heap (lowest id first, deterministic) and a per-block reference
count. Live sequences reference blocks through per-slot block tables
(:class:`~.kv_cache.PagedKVCache`). The serving programs update the pool
tensors IN PLACE (``index_put_``), where the JAX package returned a new
array per program and donated the old one.

Quantized pools, the host spill tier and its staging buffers, and
tensor-parallel placement are not ported yet (ROADMAP Queue A step 9/10).
"""
from __future__ import annotations

import heapq

import numpy as np
import torch


class BlockManager:
    """Physical block pool: device tensors + free heap + refcounts."""

    def __init__(self, num_layers, num_blocks, block_size, num_kv_heads,
                 head_dim, dtype=torch.float32, device="cuda"):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        shape = (num_layers, self.num_blocks, self.block_size,
                 num_kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        #: bytes one block's K/V holds across all layers (the
        #: /debug/requests KV-bytes unit), fixed at construction so it
        #: stays readable after :meth:`release`
        self.block_nbytes = 2 * self.k.numel() * self.k.element_size() \
            // self.num_blocks
        #: scale-plane bytes per block: 0, the port's pools are unquantized
        self.scale_block_nbytes = 0
        self._free_heap = list(range(self.num_blocks))
        self._free_set = set(self._free_heap)
        self._ref = np.zeros(self.num_blocks, np.int32)

    # ---------------------------------------------------------- allocator
    @property
    def num_free(self) -> int:
        return len(self._free_set)

    @property
    def num_used(self) -> int:
        return self.num_blocks - self.num_free

    @property
    def num_shared(self) -> int:
        """Blocks with refcount >= 2 (the ``kv_blocks_shared`` gauge)."""
        return int((self._ref >= 2).sum())

    def release(self):
        """Drop the device storage (a dead engine's, before a rebuild
        allocates the next pool); the host bookkeeping stays readable."""
        self.k = self.v = None

    def alloc(self):
        """Claim a free block (lowest id first, deterministic); None when
        the pool is exhausted."""
        if not self._free_set:
            return None
        block = heapq.heappop(self._free_heap)
        self._free_set.discard(block)
        return block

    def free(self, block: int):
        if block in self._free_set:
            raise ValueError(f"block {block} double-freed")
        if self._ref[block]:
            raise ValueError(
                f"block {block} freed with refcount {int(self._ref[block])}")
        heapq.heappush(self._free_heap, block)
        self._free_set.add(block)

    # ---------------------------------------------------------- refcounts
    def ref(self, block: int):
        """Pin a block (the owning slot's reference)."""
        self._ref[block] += 1

    def unref(self, block: int) -> int:
        """Release one pin; returns the remaining count."""
        if self._ref[block] <= 0:
            raise ValueError(f"block {block} unref'd below zero")
        self._ref[block] -= 1
        return int(self._ref[block])

    def drop(self, block: int) -> bool:
        """Release one pin and return the block to the free heap iff the
        count hit zero. Returns whether the block was freed."""
        if self.unref(block) == 0:
            self.free(block)
            return True
        return False
