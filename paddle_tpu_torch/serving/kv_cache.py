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

With a prefix cache (:mod:`.prefix_cache`) the paged cache installs a
hit by referencing the trie's block ids in the slot's table
(:meth:`PagedKVCache.install_prefix`, no copy) and frees a retiring slot
around the blocks the trie adopted (``free(slot, keep=...)``); the dense
cache copies blocks between its slots and the trie's pool
(:meth:`SlotKVCache.copy_block_in` / ``copy_block_out``). Speculative
decode rolls rejected draft rows back with :meth:`PagedKVCache.truncate`.
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


def quantize_kv_rows(x):
    """THE int8 write rule of the quantized pool: per-row-per-head
    symmetric quantization of K/V rows ``x [..., Hkv, D]`` → ``(q int8
    same shape, scale float32 [..., Hkv])``, ``scale = amax|x| / 127``
    over D. Each row quantizes on its own (nothing else in the pool
    changes its bits); an all-zero row has scale 0 and dequantizes to
    exact zeros. IEEE division by ``max(scale, 1e-30)`` and round half to
    even: the JAX function's bits."""
    xf = x.float()
    scale = torch.amax(xf.abs(), dim=-1) / 127.0
    q = torch.clamp(torch.round(xf / torch.clamp(scale, min=1e-30)[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale


#: float8_e4m3fn's largest finite value: the fp8 write rule saturates there
FP8_MAX = 448.0


def quantize_kv_rows_fp8(x):
    """THE fp8 write rule: ``x [..., Hkv, D]`` → ``float8_e4m3fn`` by a
    saturating cast (clipped to ±448 first: e4m3fn has no infinity, and
    its overflow is NaN), round to nearest even. No scale is computed:
    the pool's per-block planes stay the constant 1.0."""
    return torch.clamp(x.float(), -FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)


def store_view(t):
    """``t`` as the pool writes it: a float8 tensor as ``uint8`` over the
    same storage (CUDA's ``index_put_`` and ``where`` take no float8; the
    bits are the same), any other tensor as itself."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


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


def _paged_write_prefill_q(pool_k, pool_v, pool_ks, pool_vs, pk, pv,
                           table_row, prompt_len):
    """The int8 twin of :func:`_paged_write_prefill`: the prompt's rows
    quantize on write (:func:`quantize_kv_rows`), data and per-row scales
    landing at the same ``(block, row)`` coordinates."""
    phys, row = _prefill_scatter_coords(table_row, prompt_len,
                                        pool_k.shape[2])
    n = phys.shape[0]
    qk, sk = quantize_kv_rows(pk[:, :n])
    qv, sv = quantize_kv_rows(pv[:, :n])
    pool_k[:, phys, row] = qk
    pool_v[:, phys, row] = qv
    pool_ks[:, phys, row] = sk
    pool_vs[:, phys, row] = sv


def _paged_write_prefill_f8(pool_k, pool_v, pk, pv, table_row, prompt_len):
    """The fp8 twin: the same coordinates, the data alone written by the
    saturating cast (:func:`quantize_kv_rows_fp8`); the per-block scale
    planes are never touched."""
    phys, row = _prefill_scatter_coords(table_row, prompt_len,
                                        pool_k.shape[2])
    n = phys.shape[0]
    store_view(pool_k)[:, phys, row] = store_view(
        quantize_kv_rows_fp8(pk[:, :n]))
    store_view(pool_v)[:, phys, row] = store_view(
        quantize_kv_rows_fp8(pv[:, :n]))


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
        """Install a prefilled prompt's K/V ``[L, S_pad, Hkv, D]`` (as the
        cold prefill returns them: lists of one shard, the dense cache
        having no partition) into the leading rows of ``slot`` (in place).
        Rows past ``prompt_len`` hold bucket padding, masked by the length
        until decode overwrites them, as in the reference."""
        (pk,), (pv,) = pk, pv
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
        """Install pool block ``block_id`` into rows ``[row0, row0+bs)`` of
        ``slot`` (a prefix-cache hit), in place: one copy per K and V."""
        bs = pool.block_size
        self.k[:, slot, row0:row0 + bs] = pool.k[0][:, block_id]
        self.v[:, slot, row0:row0 + bs] = pool.v[0][:, block_id]

    def copy_block_out(self, slot, row0, pool, block_id):
        """Publish rows ``[row0, row0+bs)`` of ``slot`` into pool block
        ``block_id`` (sequence retirement), in place."""
        bs = pool.block_size
        pool.k[0][:, block_id] = self.k[:, slot, row0:row0 + bs]
        pool.v[0][:, block_id] = self.v[:, slot, row0:row0 + bs]


class PagedKVCache:
    """Block-table KV cache: slot allocator + host tables over a shared
    :class:`~.block_manager.BlockManager` pool.

    - ``alloc()`` / ``free(slot, keep=())`` — claim and release a slot;
      ``free`` drops the slot's private blocks back to the pool, except
      those in ``keep`` (donated to the prefix trie: they lose the slot's
      pin and stay allocated); shared prefix entries are forgotten (the
      engine releases their pins through ``PrefixCache.release``).
    - ``install_prefix(slot, block_ids)`` — a prefix-cache hit: the
      slot's leading entries reference the trie's blocks, no copy.
    - ``ensure_capacity(slot, rows)`` — append private blocks until the
      table covers ``rows`` logical rows, evicting unpinned trie blocks
      when the pool runs dry (raises :class:`PoolExhausted` when nothing
      is left); ``truncate(slot, rows)`` drops the private tail past
      ``rows`` again (the speculative rollback).
    - ``write_prefill(slot, pk, pv, prompt_len)`` — install a cold
      prefill's K/V through the slot's table (quantized on write on an
      int8 or fp8 pool).
    - ``kv_args()`` — the pool as the serving programs take it.
    """

    def __init__(self, num_layers, num_slots, max_seq_len, num_kv_heads,
                 head_dim, dtype=torch.float32, block_size=32, pool=None,
                 prefix_cache=None, device="cuda", kv_dtype=None):
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
                                kv_dtype=kv_dtype, device=device)
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
        if pool.kv_dtype != kv_dtype:
            raise ValueError(
                f"pool kv_dtype {pool.kv_dtype!r} != cache kv_dtype "
                f"{kv_dtype!r}")
        self.pool = pool
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype is not None
        self.fp8 = kv_dtype == "fp8"
        self.prefix_cache = prefix_cache  # evict-on-demand hook, or None
        self.sentinel = pool.num_blocks   # out-of-pool id: never written
        self.lengths = np.zeros(self.num_slots, np.int32)
        self.tables = np.full((self.num_slots, self.max_blocks),
                              self.sentinel, np.int32)
        self._n_blocks = np.zeros(self.num_slots, np.int32)  # populated
        self._n_shared = np.zeros(self.num_slots, np.int32)  # leading shared
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

    def free(self, slot: int, keep=()):
        """Release a slot's table. Blocks in ``keep`` (adopted by the
        prefix trie at publish) lose the slot's pin but stay allocated;
        every other private block drops back to the pool; shared prefix
        entries are forgotten (their pins are the engine's to
        release)."""
        if slot in self._free_set:
            raise ValueError(f"slot {slot} double-freed")
        for j in range(int(self._n_shared[slot]), int(self._n_blocks[slot])):
            b = int(self.tables[slot, j])
            if b in keep:
                self.pool.unref(b)
            else:
                self.pool.drop(b)
        self.tables[slot, :] = self.sentinel
        self._n_blocks[slot] = 0
        self._n_shared[slot] = 0
        self.lengths[slot] = 0
        heapq.heappush(self._free_heap, slot)
        self._free_set.add(slot)

    # ------------------------------------------------------------ tables
    def install_prefix(self, slot, block_ids):
        """Zero-copy prefix-hit install: the slot's leading table entries
        reference the published blocks. The caller holds their read pins
        (``PrefixCache.acquire`` at lookup)."""
        n = len(block_ids)
        if n > self.max_blocks:
            raise ValueError(
                f"prefix of {n} blocks exceeds the {self.max_blocks}-entry "
                f"table")
        for j, b in enumerate(block_ids):
            self.tables[slot, j] = int(b)
        self._n_blocks[slot] = n
        self._n_shared[slot] = n

    def _alloc_block(self):
        b = self.pool.alloc()
        while b is None and self.prefix_cache is not None \
                and self.prefix_cache._evict_one():
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

    def truncate(self, slot, rows: int):
        """Roll the slot's table back to cover exactly ``rows`` logical
        rows: every private tail block past ``ceil(rows / block_size)``
        drops back to the pool (the inverse of :meth:`ensure_capacity`, so
        ``num_free`` and the refcounts are what a never-grown slot shows).
        The speculative-decode rollback: a verify span appends draft K/V
        through the table, and rejected drafts hand their blocks back
        here.

        The keep count is clamped at the slot's installed shared prefix:
        trie blocks are never truncated (their pins are the engine's to
        release). Rows of a kept block past ``rows`` hold stale K/V that
        attention masks by length and the next append overwrites.
        ``lengths[slot]`` is clamped down to ``rows``. No device work."""
        keep = max(-(-int(rows) // self.block_size),
                   int(self._n_shared[slot]))
        n = int(self._n_blocks[slot])
        for j in range(keep, n):
            self.pool.drop(int(self.tables[slot, j]))
            self.tables[slot, j] = self.sentinel
        if keep < n:
            self._n_blocks[slot] = keep
        if int(self.lengths[slot]) > int(rows):
            self.lengths[slot] = int(rows)

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

    def occupancy_bytes(self) -> dict:
        """Pool occupancy in bytes, split by storage kind — the
        ``kv_pool_bytes{kind="kv|scales"}`` gauges and the
        ``serving_kv_bytes_per_token`` rate: ``used_*`` over allocated
        (live + trie) blocks, ``capacity_*`` over the whole pool,
        ``per_token`` the bytes one cached token costs. An unquantized
        pool reports ``scales`` 0."""
        used = self.used_blocks()
        kv_b, sc_b = self.pool.block_nbytes, self.pool.scale_block_nbytes
        return {
            "used_kv": used * kv_b,
            "used_scales": used * sc_b,
            "capacity_kv": self.pool.num_blocks * kv_b,
            "capacity_scales": self.pool.num_blocks * sc_b,
            "per_token": self.bytes_per_token(),
        }

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
        ``slot`` through its block table (in place). ``pk``/``pv`` are
        lists, each shard's head slice, and each lands in its shard's
        planes at the same coordinates."""
        if pk[0].shape[1] > self.max_seq_len:
            raise ValueError(
                f"prefill length {pk[0].shape[1]} exceeds max_seq_len "
                f"{self.max_seq_len}")
        self.ensure_capacity(slot, int(prompt_len))
        n = int(prompt_len)
        p = self.pool
        for s, (sk, sv) in enumerate(zip(pk, pv)):
            k, v = p.k[s], p.v[s]
            row = torch.as_tensor(self.tables[slot]).to(k.device)
            if self.fp8:
                _paged_write_prefill_f8(k, v, sk, sv, row, n)
            elif self.quantized:
                _paged_write_prefill_q(k, v, p.k_scale[s], p.v_scale[s], sk,
                                       sv, row, n)
            else:
                _paged_write_prefill(k, v, sk, sv, row, n)
        self.lengths[slot] = n

    def kv_args(self):
        """The pool as the serving programs take it: each side the list of
        its shards', a tensor each on a full-precision pool, a ``(data,
        scale)`` pair each on a quantized one — each side one argument, so
        the programs' signatures do not change."""
        p = self.pool
        if self.quantized:
            return list(zip(p.k, p.k_scale)), list(zip(p.v, p.v_scale))
        return list(p.k), list(p.v)
