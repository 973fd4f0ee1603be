"""KV caches of the serving engine: the block-table cache of the paged
engine and the dense per-slot cache of the ``paged_attn=False`` engine
(:class:`SlotKVCache`).

The port of ``paddle_tpu/serving/kv_cache.py``'s :class:`PagedKVCache` on
the default geometry: the :class:`~.block_manager.BlockManager` pool IS
the cache. Each live slot owns a row of a host block table
``[num_slots, max_blocks]`` naming the physical pool blocks that spell its
logical cache; growth appends fresh private blocks lazily; retirement
drops the slot's blocks back to the pool. Host bookkeeping (tables,
lengths) stays numpy; the serving programs read the tables as int32
device tensors and write the pool tensors in place.

Table entries of an unmapped position hold the sentinel ``num_blocks``.
JAX drops a scatter to such an index (``mode="drop"``); ``index_put_``
would fault on it, so every writer here selects the live rows first.

The prefix-cache install/donate surface and the speculative ``truncate``
belong to engine features not ported yet (ROADMAP Queue A step 9).
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from .block_manager import BlockManager


class PoolExhausted(RuntimeError):
    """KV block pool exhausted: live sequences exceed the pool. Typed so
    the engine can catch it and preempt the youngest sequence by
    recompute instead of failing the step. Carries the pool occupancy
    snapshot at the failed allocation."""

    def __init__(self, live_blocks=0, pinned_blocks=0, free_blocks=0,
                 message=None):
        self.live_blocks = int(live_blocks)
        self.pinned_blocks = int(pinned_blocks)
        self.free_blocks = int(free_blocks)
        super().__init__(message or (
            f"KV block pool exhausted: live sequences exceed the pool "
            f"(live={self.live_blocks}, pinned={self.pinned_blocks}, "
            f"free={self.free_blocks}); size the pool to at least "
            f"num_slots * max_blocks"))


def _prefill_scatter_coords(table_row, prompt_len, block_size):
    """THE prefill scatter-coordinate rule: rows ``[0, prompt_len)`` map
    through the slot's block table to ``(physical block, row in block)``.
    Rows past ``prompt_len`` (bucket padding) are where JAX scatters to
    the sentinel and drops; here they are simply not returned."""
    pos = torch.arange(int(prompt_len), device=table_row.device)
    bi = torch.clamp(pos // block_size, max=table_row.shape[0] - 1)
    return table_row[bi].long(), pos % block_size


def _paged_write_prefill(pool_k, pool_v, pk, pv, table_row, prompt_len):
    """Scatter one prompt's K/V ``pk/pv [L, S_pad, Hkv, D]`` into the pool
    through its table row, in place; bucket padding past ``prompt_len``
    is never written."""
    phys, row = _prefill_scatter_coords(table_row, prompt_len,
                                        pool_k.shape[2])
    n = phys.shape[0]
    pool_k[:, phys, row] = pk[:, :n].to(pool_k.dtype)
    pool_v[:, phys, row] = pv[:, :n].to(pool_v.dtype)


class SlotKVCache:
    """Dense per-slot KV cache of the ``paged_attn=False`` engine — the
    port of ``paddle_tpu/serving/kv_cache.py``'s :class:`SlotKVCache`: one
    dense ``[L, num_slots, max_seq_len, Hkv, D]`` pair, one-shot prefill
    only. Writes are in place (JAX donated the old arrays instead), so
    :meth:`update` only checks that the decode program handed back the
    same tensors.

    The free-slot pool is a min-heap plus a membership set: ``alloc``
    takes the lowest free index, ``free`` raises on a double free."""

    def __init__(self, num_layers, num_slots, max_seq_len, num_kv_heads,
                 head_dim, dtype=torch.float32, device="cuda"):
        self.num_slots = int(num_slots)
        self.max_seq_len = int(max_seq_len)
        shape = (num_layers, self.num_slots, self.max_seq_len, num_kv_heads,
                 head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        # K/V bytes of one cached row across all layers
        self._row_nbytes = 2 * self.k.numel() * self.k.element_size() \
            // (self.num_slots * self.max_seq_len)
        self.lengths = np.zeros(self.num_slots, np.int32)
        self._free_heap = list(range(self.num_slots))
        self._free_set = set(self._free_heap)

    def release(self):
        """Drop the device storage (a dead engine's, before a rebuild
        allocates the next cache); the host bookkeeping stays readable."""
        self.k = self.v = None

    # ------------------------------------------------------------- slots
    @property
    def num_free(self) -> int:
        return len(self._free_set)

    def alloc(self):
        """Claim a free slot (lowest index first, deterministic)."""
        if not self._free_set:
            return None
        slot = heapq.heappop(self._free_heap)
        self._free_set.discard(slot)
        return slot

    def free(self, slot: int):
        if slot in self._free_set:
            raise ValueError(f"slot {slot} double-freed")
        self.lengths[slot] = 0
        heapq.heappush(self._free_heap, slot)
        self._free_set.add(slot)

    # ------------------------------------------------------------ writes
    def write_prefill(self, slot, pk, pv, prompt_len):
        """Install a prefilled prompt's K/V ``[L, S_pad, Hkv, D]`` into the
        leading rows of ``slot`` (in place). Rows past ``prompt_len`` hold
        bucket padding, masked by the length until decode overwrites
        them, as in the reference."""
        if pk.shape[1] > self.max_seq_len:
            raise ValueError(
                f"prefill length {pk.shape[1]} exceeds max_seq_len "
                f"{self.max_seq_len}")
        n = pk.shape[1]
        self.k[:, slot, :n] = pk.to(self.k.dtype)
        self.v[:, slot, :n] = pv.to(self.v.dtype)
        self.lengths[slot] = int(prompt_len)

    def update(self, new_k, new_v):
        """Adopt the decode program's cache: the same tensors, written in
        place (the reference adopts fresh arrays here)."""
        if new_k is not self.k or new_v is not self.v:
            raise ValueError("the decode program must return the cache "
                             "tensors it was given (in-place writes)")

    def slot_kv_bytes(self, slot) -> int:
        """Device bytes of the slot's valid rows (rows × per-row bytes)."""
        return int(self.lengths[slot]) * self._row_nbytes

    # ------------------------------------------------------ block copies
    def copy_block_in(self, slot, row0, pool, block_id):
        raise NotImplementedError(
            "SlotKVCache.copy_block_in belongs to the prefix cache, not "
            "ported to paddle_tpu_torch yet (ROADMAP Queue A step 9)")

    def copy_block_out(self, slot, row0, pool, block_id):
        raise NotImplementedError(
            "SlotKVCache.copy_block_out belongs to the prefix cache, not "
            "ported to paddle_tpu_torch yet (ROADMAP Queue A step 9)")


class PagedKVCache:
    """Block-table KV cache: slot allocator + host tables over a shared
    :class:`~.block_manager.BlockManager` pool.

    - ``alloc()`` / ``free(slot)`` — claim and release a slot; ``free``
      drops the slot's private blocks back to the pool.
    - ``ensure_capacity(slot, rows)`` — append private blocks until the
      table covers ``rows`` logical rows (raises :class:`PoolExhausted`
      when the pool runs dry).
    - ``write_prefill(slot, pk, pv, prompt_len)`` — install a cold
      prefill's K/V through the slot's table.
    """

    def __init__(self, num_layers, num_slots, max_seq_len, num_kv_heads,
                 head_dim, dtype=torch.float32, block_size=32, pool=None,
                 device="cuda"):
        bs = int(block_size)
        if bs < 1:
            raise ValueError(f"block_size must be >= 1, got {bs}")
        self.num_slots = int(num_slots)
        self.max_seq_len = int(max_seq_len)
        self.block_size = bs
        self.max_blocks = -(-self.max_seq_len // bs)
        if pool is None:
            pool = BlockManager(num_layers, self.num_slots * self.max_blocks,
                                bs, num_kv_heads, head_dim, dtype=dtype,
                                device=device)
        if pool.block_size != bs:
            raise ValueError(
                f"pool block_size {pool.block_size} != cache block_size "
                f"{bs}")
        if pool.num_blocks < self.num_slots * self.max_blocks:
            raise ValueError(
                f"pool of {pool.num_blocks} blocks cannot back "
                f"{self.num_slots} slots x {self.max_blocks} blocks of "
                f"live KV (worst case needs "
                f"{self.num_slots * self.max_blocks})")
        self.pool = pool
        self.sentinel = pool.num_blocks   # out-of-pool id: never written
        self.lengths = np.zeros(self.num_slots, np.int32)
        self.tables = np.full((self.num_slots, self.max_blocks),
                              self.sentinel, np.int32)
        self._n_blocks = np.zeros(self.num_slots, np.int32)
        self._free_heap = list(range(self.num_slots))
        self._free_set = set(self._free_heap)

    def release(self):
        """Drop the pool's device storage (see ``BlockManager.release``)."""
        self.pool.release()

    # ------------------------------------------------------------- slots
    @property
    def num_free(self) -> int:
        return len(self._free_set)

    def alloc(self):
        """Claim a free slot (lowest index first, deterministic)."""
        if not self._free_set:
            return None
        slot = heapq.heappop(self._free_heap)
        self._free_set.discard(slot)
        return slot

    def free(self, slot: int):
        """Release a slot's table; its private blocks drop back to the
        pool."""
        if slot in self._free_set:
            raise ValueError(f"slot {slot} double-freed")
        for j in range(int(self._n_blocks[slot])):
            self.pool.drop(int(self.tables[slot, j]))
        self.tables[slot, :] = self.sentinel
        self._n_blocks[slot] = 0
        self.lengths[slot] = 0
        heapq.heappush(self._free_heap, slot)
        self._free_set.add(slot)

    # ------------------------------------------------------------ tables
    def _alloc_block(self):
        b = self.pool.alloc()
        if b is None:
            pool = self.pool
            raise PoolExhausted(
                live_blocks=pool.num_used,
                pinned_blocks=int((pool._ref > 0).sum()),
                free_blocks=pool.num_free)
        self.pool.ref(b)             # the slot's ownership pin
        return b

    def ensure_capacity(self, slot, rows: int):
        """Append private blocks until the slot's table covers ``rows``
        logical rows (decode growth / prefill install)."""
        need = min(-(-int(rows) // self.block_size), self.max_blocks)
        n = int(self._n_blocks[slot])
        while n < need:
            self.tables[slot, n] = self._alloc_block()
            n += 1
            self._n_blocks[slot] = n

    def slot_block_ids(self, slot):
        """Physical block ids populating the slot's table, in order."""
        return [int(b) for b in self.tables[slot, :int(self._n_blocks[slot])]]

    # ------------------------------------------------------- occupancy
    def table_fill(self) -> float:
        """Fraction of the [num_slots, max_blocks] table grid populated —
        the ``kv_block_table_fill`` gauge."""
        return float(self._n_blocks.sum()) / float(
            self.num_slots * self.max_blocks)

    def occupancy(self) -> dict:
        """Pool occupancy: ``live`` = distinct blocks some slot table
        references, ``trie`` = allocated blocks no table references (0
        without a prefix cache), ``free`` = the pool's free heap."""
        refd = set()
        for slot in range(self.num_slots):
            refd.update(self.slot_block_ids(slot))
        live = len(refd)
        return {"live": live,
                "trie": max(self.pool.num_used - live, 0),
                "free": self.pool.num_free}

    def used_blocks(self) -> int:
        """Allocated (live + trie) blocks."""
        return self.pool.num_used

    def slot_kv_bytes(self, slot) -> int:
        """Bytes the slot's table holds (blocks x block bytes) — the
        ``/debug/requests`` cost column."""
        return int(self._n_blocks[slot]) * (
            self.pool.block_nbytes + self.pool.scale_block_nbytes)

    def bytes_per_token(self) -> float:
        """Bytes one cached token costs (block bytes / block size)."""
        return (self.pool.block_nbytes
                + self.pool.scale_block_nbytes) / self.block_size

    # ------------------------------------------------------------ writes
    def write_prefill(self, slot, pk, pv, prompt_len):
        """Install a prefilled prompt's K/V ``[L, S_pad, Hkv, D]`` into
        ``slot`` through its block table (in place)."""
        if pk.shape[1] > self.max_seq_len:
            raise ValueError(
                f"prefill length {pk.shape[1]} exceeds max_seq_len "
                f"{self.max_seq_len}")
        self.ensure_capacity(slot, int(prompt_len))
        p = self.pool
        row = torch.as_tensor(self.tables[slot]).to(p.k.device)
        _paged_write_prefill(p.k, p.v, pk, pv, row, int(prompt_len))
        self.lengths[slot] = int(prompt_len)
