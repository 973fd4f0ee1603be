"""Ref-counted physical block pool: the KV storage of the paged engine.

The port of ``paddle_tpu/serving/block_manager.py``'s ``BlockManager`` on
the default geometry: two device planes ``k``/``v`` ``[L, num_blocks,
block_size, Hkv, D]`` at the model dtype, each a list of one tensor a
shard (below), plus host bookkeeping — a free-block
min-heap (lowest id first, deterministic) and a per-block reference
count. Live sequences reference blocks through per-slot block tables
(:class:`~.kv_cache.PagedKVCache`). The serving programs update the pool
tensors IN PLACE (``index_put_``), where the JAX package returned a new
array per program and donated the old one.

The same pool backs the prefix cache (:mod:`.prefix_cache`): trie blocks
are allocated blocks no slot owns, pinned while a sequence reads them.

``kv_dtype`` picks the storage: None stores at the model dtype; ``"int8"``
stores int8 with per-row-per-head float32 scale planes ``k_scale`` /
``v_scale [L, num_blocks, block_size, Hkv]`` (zeros); ``"fp8"`` stores
``float8_e4m3fn`` with per-block planes ``[L, num_blocks, Hkv]`` (ones,
never written: e4m3's exponent is the per-value scale). The planes are
indexed by the same physical block id as the data, so every lifecycle
move (alloc, free, trie donation) carries a block's scales with it.

``tp`` (the tensor-parallel engine, ``serving/tp.py``) partitions the
pool on its head axis: every plane is a list of ``tp`` tensors (one at
``tp=1``), shard ``s`` holding heads ``[s * Hkv/tp, (s + 1) * Hkv/tp)``
of every block on ``device`` — int8's per-row planes split on their
axis 3, fp8's per-block planes on axis 2, as the reference's
``_pool_pspec`` shards them. The host bookkeeping (free heap, refcounts)
is one copy for all shards: every shard has the same block layout.

The host spill tier (:class:`~.prefix_cache.HostTier`) moves whole blocks
through :meth:`BlockManager.read_block` (device→host, into reusable
staging buffers — pinned host tensors on a card — scale planes included)
and :meth:`BlockManager.write_block` (host→device, IN PLACE into the pool
tensors, which the captured multi-tick tail and the fused tick hold and
which are therefore never rebound). A device→host copy is complete before
``read_block`` returns; a host→device copy is complete before its staging
buffers go back to the pool (:meth:`BlockManager.recycle_staging`).
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

#: every distinct tier transfer the pools ran: (direction, storage mode,
#: the pool planes' shapes and dtypes) — the signature set behind
#: :func:`tier_compilations`
_TIER_SIGNATURES = set()


def tier_compilations() -> int:
    """Distinct tier transfer signatures run so far: one per (direction,
    pool geometry, storage mode) however many blocks spill or readmit —
    the count the JAX package's ``kv_cache.tier_compilations`` reports
    (its fetch/inject programs trace once per geometry, the block id a
    runtime scalar)."""
    return len(_TIER_SIGNATURES)


def _bytes(t):
    """``t`` as the transfers move it: a float8 tensor as ``uint8`` over
    the same storage (same bits), any other tensor as itself."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


class StagingPool:
    """Reusable host buffers for tier spills, one free list per (plane,
    shape, dtype): :meth:`take` pops a free buffer or allocates the key's
    first (pinned when ``pin``, so the device→host copy is a direct DMA),
    :meth:`give` returns a spill's buffers once nothing can read them, and
    ``allocations`` counts real allocations per key — one per key in the
    steady state, not one per spill."""

    def __init__(self, pin=False):
        self.pin = bool(pin)
        self._free = {}          # (plane, shape, dtype str) -> [buffers]
        #: (plane, shape, dtype str) -> allocation count
        self.allocations = {}

    @staticmethod
    def _key(plane, shape, dtype):
        return (plane, tuple(int(s) for s in shape), str(dtype))

    def take(self, plane, shape, dtype):
        """A writable host buffer for the named plane (``k`` / ``v`` /
        scale) of the shape, reused when one is free."""
        key = self._key(plane, shape, dtype)
        free = self._free.get(key)
        if free:
            return free.pop()
        self.allocations[key] = self.allocations.get(key, 0) + 1
        return torch.empty(key[1], dtype=dtype, pin_memory=self.pin)

    def give(self, bufs):
        """Return a spill's buffers (a ``read_block``-shaped dict) to the
        free lists. Only once NOTHING can read them again."""
        for plane, b in bufs.items():
            self._free.setdefault(self._key(plane, b.shape, b.dtype),
                                  []).append(b)


class BlockManager:
    """Physical block pool: device tensors + free heap + refcounts."""

    def __init__(self, num_layers, num_blocks, block_size, num_kv_heads,
                 head_dim, dtype=torch.float32, kv_dtype=None,
                 device="cuda", tp=1):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if kv_dtype not in (None, "int8", "fp8"):
            raise ValueError(
                f"kv_dtype must be None (store at pool dtype), 'int8' or "
                f"'fp8', got {kv_dtype!r}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype is not None
        self.fp8 = kv_dtype == "fp8"
        self.tp = int(tp)
        if num_kv_heads % self.tp:
            raise ValueError(
                f"tp={self.tp} must divide num_kv_heads ({num_kv_heads})")
        #: the logical geometry, whatever the partition: layers, KV
        #: heads, head dim and storage dtype
        self.num_layers = int(num_layers)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.store_dtype = (torch.float8_e4m3fn if self.fp8
                            else torch.int8 if self.quantized else dtype)
        shards = [self._alloc(num_kv_heads // self.tp, device)
                  for _ in range(self.tp)]
        #: the planes, one tensor a shard (the scale planes None on an
        #: unquantized pool)
        self.k, self.v, self.k_scale, self.v_scale = (
            [sh[i] for sh in shards] if self.quantized or i < 2 else None
            for i in range(4))
        #: bytes one block's K/V data holds across all layers and shards
        #: (the /debug/requests KV-bytes unit), at the storage dtype; fixed
        #: at construction so it stays readable after :meth:`release`
        self.block_nbytes = 2 * sum(
            t.numel() * t.element_size() for t in self.k) // self.num_blocks
        #: bytes one block's scale planes hold across all layers and
        #: shards, K and V (0 on an unquantized pool): the
        #: ``kind="scales"`` gauge's unit
        self.scale_block_nbytes = 0 if self.k_scale is None else \
            2 * sum(t.numel() * 4 for t in self.k_scale) // self.num_blocks
        self._free_heap = list(range(self.num_blocks))
        self._free_set = set(self._free_heap)
        self._ref = np.zeros(self.num_blocks, np.int32)
        self._peak_used = 0
        # spill staging: per-shape reusable host buffers for read_block,
        # recycled by the tier's drop/readmit paths (recycle_staging);
        # the event marks the last host->device copy out of them
        self._cuda = self.k[0].is_cuda
        self.staging = StagingPool(pin=self._cuda)
        self._h2d_done = None

    def _alloc(self, hkv, device):
        """One shard's zeroed planes ``(k, v, k_scale, v_scale)`` over
        ``hkv`` heads (the scale planes None on an unquantized pool)."""
        shape = (self.num_layers, self.num_blocks, self.block_size, hkv,
                 self.head_dim)
        k = torch.zeros(shape, dtype=self.store_dtype, device=device)
        v = torch.zeros(shape, dtype=self.store_dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        if self.fp8:
            sshape = (self.num_layers, self.num_blocks, hkv)
            return k, v, torch.ones(sshape, **f32), torch.ones(sshape, **f32)
        if self.quantized:
            return (k, v, torch.zeros(shape[:-1], **f32),
                    torch.zeros(shape[:-1], **f32))
        return k, v, None, None

    # ---------------------------------------------------------- allocator
    @property
    def num_free(self) -> int:
        return len(self._free_set)

    @property
    def num_used(self) -> int:
        return self.num_blocks - self.num_free

    @property
    def peak_used(self) -> int:
        """High-water mark of :attr:`num_used`."""
        return self._peak_used

    @property
    def num_shared(self) -> int:
        """Blocks with refcount >= 2 (the ``kv_blocks_shared`` gauge)."""
        return int((self._ref >= 2).sum())

    def release(self):
        """Drop the device storage (a dead engine's, before a rebuild
        allocates the next pool); the host bookkeeping stays readable."""
        self.k = self.v = self.k_scale = self.v_scale = None

    def alloc(self):
        """Claim a free block (lowest id first, deterministic); None when
        the pool is exhausted."""
        if not self._free_set:
            return None
        block = heapq.heappop(self._free_heap)
        self._free_set.discard(block)
        self._peak_used = max(self._peak_used, self.num_used)
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
        """Pin a block (an owning slot's reference, or a sequence's read
        pin on a prefix-cache block)."""
        self._ref[block] += 1

    def unref(self, block: int) -> int:
        """Release one pin; returns the remaining count."""
        if self._ref[block] <= 0:
            raise ValueError(f"block {block} unref'd below zero")
        self._ref[block] -= 1
        return int(self._ref[block])

    def refcount(self, block: int) -> int:
        return int(self._ref[block])

    # --------------------------------------------------- tier transfers
    def _planes(self):
        """Every shard's planes a block spans, by name: shard 0's ``k``,
        ``v`` (and the scale planes), shard ``s``'s ``k.s``, ``v.s``,
        ...."""
        names = ("k", "v") + (("k_scale", "v_scale") if self.quantized
                              else ())
        return {f"{name}.{s}" if s else name: t for name in names
                for s, t in enumerate(getattr(self, name))}

    def _note_transfer(self, direction, planes):
        _TIER_SIGNATURES.add((direction, self.kv_dtype) + tuple(
            (name, tuple(t.shape), str(t.dtype))
            for name, t in planes.items()))

    def read_block(self, block: int) -> dict:
        """Copy one block device→host for the spill tier: staging buffers
        keyed like the pool's planes (``k``/``v`` ``[L, 1, bs, Hkv/tp, D]``
        and, on a quantized pool, ``k_scale``/``v_scale`` — the scale
        planes ride the same block id; every shard's, whose bytes add up
        to the block's once). The copy is
        complete when this returns: an event after the copies is waited
        on."""
        planes = self._planes()
        out = {}
        for name, t in planes.items():
            src = t[:, block:block + 1]
            buf = self.staging.take(name, src.shape, t.dtype)
            _bytes(buf).copy_(_bytes(src), non_blocking=self._cuda)
            out[name] = buf
        if self._cuda:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        self._note_transfer("d2h", planes)
        return out

    def write_block(self, block: int, bufs: dict):
        """Stream one spilled block's host buffers back into pool block
        ``block`` (readmission), in place: the pool tensors keep their
        storage, so the captured tail's and the fused tick's pointers stay
        valid. The copies are asynchronous; :meth:`recycle_staging` waits
        for them before the buffers are reused."""
        planes = self._planes()
        for name, t in planes.items():
            _bytes(t[:, block:block + 1]).copy_(_bytes(bufs[name]),
                                                non_blocking=self._cuda)
        if self._cuda:
            self._h2d_done = torch.cuda.Event()
            self._h2d_done.record()
        self._note_transfer("h2d", planes)

    def recycle_staging(self, bufs):
        """Hand a spill's staging buffers back for reuse once their tier
        entry is dead (dropped, replaced, or readmitted): the last
        host→device copy is waited on first, since a readmission may
        still be reading the buffers."""
        if self._h2d_done is not None:
            self._h2d_done.synchronize()
            self._h2d_done = None
        self.staging.give(bufs)

    def drop(self, block: int) -> bool:
        """Release one pin and return the block to the free heap iff the
        count hit zero. Returns whether the block was freed."""
        if self.unref(block) == 0:
            self.free(block)
            return True
        return False
