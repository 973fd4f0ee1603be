"""Automatic prefix caching: block-granular KV reuse across requests.

The port's own copy of ``paddle_tpu/serving/prefix_cache.py``'s
``PrefixCache`` and ``HostTier``. Published KV blocks are keyed by their
token content, so an admission whose prompt shares a cached block chain
skips the device work for every covered block:

- **Hash-trie**: each node is one ``block_size``-token block, keyed by its
  exact token tuple under its parent (the tuple IS the key, so different
  token content can never alias). A path root→node spells a prompt
  prefix.
- **Lookup** walks the trie over a prompt's full blocks and returns the
  longest cached chain, never covering the final prompt token (the engine
  needs its logits to sample token 0).
- **Acquire/release**: a matched chain is ref-pinned for the sequence's
  lifetime; retirement releases the pins.
- **Publish** (the dense engine): on retirement every full prompt block
  not already cached is copied slot→pool (``SlotKVCache.copy_block_out``)
  and inserted. Pool pressure evicts LRU zero-ref leaves; with every
  block pinned the publish is skipped, never failed.
- **Donation** (the paged engine, :meth:`PrefixCache.publish_donate`): a
  retiring sequence's full blocks, prompt and generated, are adopted by
  the trie in place, with no copy; a hit installs by referencing the
  block ids in the slot's table, so N holders share one block. Writes
  land at logical rows past the covered prefix, in privately owned tail
  blocks, so shared blocks are read and never written.
- **Host-RAM spill tier** (``host_tier_bytes > 0``): eviction stops
  meaning deletion. An evicted zero-ref leaf's block (scale planes
  included) spills device→host (``BlockManager.read_block``) into a
  :class:`HostTier` keyed by the block's root→node token path, under its
  own byte budget and LRU. A recording lookup whose walk runs off the
  resident frontier readmits the spilled continuation host→device
  (``BlockManager.write_block``, in place), each block re-allocated
  through the pool's ``alloc`` and eviction path and re-linked as a live
  trie node, then matched like any resident block. Spills and
  readmissions are recorded on the cost observatory's tier ledger
  (``record_tier``). The tier's chain digests address spilled chains for
  the fleet's cache plane (``serving/fleet/fleet.py`` ``_tier_warm``).

The trie is host work on the engine's driver thread (no locks); the tier
takes its own lock. The device work is the block copies, the tier
transfers and the suffix prefill program.
"""
from __future__ import annotations

import hashlib
import itertools
import threading

import numpy as np


class HostTier:
    """Host-RAM spill tier: evicted trie blocks' KV as host buffers (the
    pool's staging tensors; any object with ``nbytes`` will do).

    One entry per spilled block, keyed by the block's full root→node
    token path (a tuple of token tuples — the same content identity the
    trie uses, so readmission can never alias different tokens) and
    cross-indexed by a chain digest (sha1 over the path's tokens) for
    the fleet cache plane, where replicas compare chains without
    shipping token streams.

    Own LRU under its own byte budget: inserts stamp a fresh tick and
    evict minimum-tick entries until the tier fits. Evicting an entry
    cascades to its descendants — a spilled block whose parent is
    neither resident in the trie nor present in the tier can never be
    readmitted (readmission extends the trie frontier contiguously), so
    keeping orphans would be dead weight that lies to the byte gauge.

    Thread-safety: unlike the trie (driver-thread-only by engine
    contract), the tier is touched from fleet submit threads too (the
    cache plane exports/admits entries while the owning driver spills
    and readmits), so every method takes the instance lock. Buffers are
    immutable by convention — export hands out references, never
    copies, which is what makes the fleet's host-to-host transfer a
    pointer move within one process."""

    def __init__(self, capacity_bytes):
        self.capacity_bytes = int(capacity_bytes)
        # path -> [bufs, nbytes, tick, digest, shared]
        self._entries = {}
        self._by_digest = {}          # digest -> path
        self._tick = itertools.count(1)
        self._bytes = 0
        self._lock = threading.Lock()
        # staging recycler (BlockManager.recycle_staging): called with
        # a dead entry's buffers UNLESS the entry is shared — an
        # exported entry's buffers are referenced by a sibling tier
        # (the fleet cache plane's pointer-move transfer), so recycling
        # them here would hand the sibling the next spill's bytes
        self.on_recycle = None

    # ------------------------------------------------------------ digests
    @staticmethod
    def chain_digests(keys):
        """One digest per depth of a block-key chain: ``out[i]`` hashes
        ``keys[:i+1]``. Incremental (one pass for every depth) and
        content-only, so two replicas that never exchanged state compute
        identical digests for identical prefixes — the fleet cache
        plane's addressing scheme."""
        h = hashlib.sha1()
        out = []
        for key in keys:
            h.update(np.asarray(key, np.int64).tobytes())
            out.append(h.hexdigest())
        return out

    # ------------------------------------------------------------- access
    def _remove_locked(self, path):
        bufs, nbytes, _, digest, shared = self._entries.pop(path)
        self._bytes -= nbytes
        self._by_digest.pop(digest, None)
        return bufs, nbytes, shared

    def _recycle(self, bufs, shared):
        """Return a dead entry's buffers to the spill staging pool —
        unless a sibling tier still references them (class docstring's
        buffers-are-immutable convention: shared buffers are never
        reused, they just age out)."""
        cb = self.on_recycle
        if cb is not None and not shared:
            cb(bufs)

    def put(self, path, bufs, shared=False) -> int:
        """Insert (or refresh) one spilled block's buffers under
        ``path``; trims the tier back to budget and returns how many
        OTHER entries the trim dropped (the ``tier_evictions`` stat).
        The freshest entry carries the newest tick, so the trim reaps
        cold chains, not the spill that triggered it — unless the entry
        alone exceeds the whole budget, in which case it drops too (the
        tier degrades to empty, never over budget)."""
        path = tuple(path)
        nbytes = sum(int(b.nbytes) for b in bufs.values())
        digest = self.chain_digests(path)[-1]
        dropped = 0
        recycle = []
        with self._lock:
            if path in self._entries:
                old, _, old_shared = self._remove_locked(path)
                if old is not bufs:
                    recycle.append((old, old_shared))
            self._entries[path] = [bufs, nbytes, next(self._tick),
                                   digest, bool(shared)]
            self._by_digest[digest] = path
            self._bytes += nbytes
            while self._bytes > self.capacity_bytes and self._entries:
                victim = min(self._entries.items(),
                             key=lambda kv: kv[1][2])[0]
                # cascade: descendants of the victim become unreachable
                doomed = [p for p in self._entries
                          if p[:len(victim)] == victim]
                for p in doomed:
                    dead, _, dead_shared = self._remove_locked(p)
                    recycle.append((dead, dead_shared))
                    if p != path:
                        dropped += 1
        for dead, dead_shared in recycle:
            self._recycle(dead, dead_shared)
        return dropped

    def pop(self, path):
        """Remove and return ``(bufs, shared)`` for ``path``
        (readmission: the block is going back to HBM; a re-eviction
        re-spills it — ``shared`` must ride along so a degrade re-put
        keeps the sibling-referenced flag), or None."""
        with self._lock:
            if path not in self._entries:
                return None
            bufs, _, shared = self._remove_locked(path)
            return bufs, shared

    def has(self, path) -> bool:
        with self._lock:
            return tuple(path) in self._entries

    def export_digest(self, digest):
        """Fleet cache plane read: ``(path, bufs, nbytes)`` for the
        chain digest, by reference (buffers are immutable), touching
        the LRU tick — a chain siblings keep pulling stays warm. None
        when the digest is unknown (or was just evicted: the plane
        treats that as a miss and stops the transfer)."""
        with self._lock:
            path = self._by_digest.get(digest)
            if path is None:
                return None
            entry = self._entries[path]
            entry[2] = next(self._tick)
            # the export hands out buffer REFERENCES: from here on a
            # sibling tier may hold them, so this entry's buffers can
            # never be recycled into the local staging pool
            entry[4] = True
            return path, entry[0], entry[1]

    # ------------------------------------------------------------- intro
    @property
    def num_blocks(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def digest_table(self) -> dict:
        """Scrape-style snapshot for ``/fleet/cacheplane``: digest →
        {depth, nbytes}."""
        with self._lock:
            return {e[3]: {"depth": len(p), "nbytes": e[1]}
                    for p, e in self._entries.items()}



class _Node:
    """One cached block: a trie edge keyed by its token tuple."""

    __slots__ = ("tokens", "parent", "children", "block_id", "tick")

    def __init__(self, tokens, parent, block_id):
        self.tokens = tokens        # the block's exact token tuple
        self.parent = parent        # _Node or None (root-level block)
        self.children = {}          # token tuple -> _Node
        self.block_id = block_id    # index into the BlockManager pool
        self.tick = 0               # LRU stamp (updated on touch)


class PrefixCache:
    """Hash-trie over prompt token blocks + LRU eviction policy.

    Owns logical identity and lifecycle; the physical blocks live in the
    :class:`~.block_manager.BlockManager` passed in. ``max_blocks`` is
    the trie's residency budget on the paged engine, where the pool also
    backs live KV (None: bounded by the pool alone, the dense engine's
    case, where the pool IS the budget).
    """

    def __init__(self, pool, max_blocks=None, host_tier_bytes=0):
        self.pool = pool
        self.block_size = pool.block_size
        self.max_blocks = None if max_blocks is None else int(max_blocks)
        # the host-RAM spill tier: 0 keeps eviction = deletion; > 0 turns
        # eviction into a d2h spill and a lookup into a possible h2d
        # readmission
        self.host_tier_bytes = int(host_tier_bytes)
        if self.host_tier_bytes < 0:
            raise ValueError(
                f"host_tier_bytes must be >= 0, got {host_tier_bytes}")
        self.tier = (HostTier(self.host_tier_bytes)
                     if self.host_tier_bytes else None)
        if self.tier is not None:
            # dead tier entries hand their staging buffers back to the
            # pool's per-shape free lists
            self.tier.on_recycle = pool.recycle_staging
        # the cost observatory for the tier ledger, kept on the engine's
        # live observatory by its _co() guard
        self.cost = None
        self._root = {}              # token tuple -> _Node
        self._nodes = 0              # live trie nodes
        self._tick = itertools.count(1)
        self.stats = {"lookups": 0, "hits": 0, "misses": 0,
                      "hit_blocks": 0, "hit_tokens": 0,
                      "published_blocks": 0, "evictions": 0,
                      "skipped_publishes": 0, "donated_blocks": 0,
                      "spilled_blocks": 0, "tier_hits": 0,
                      "readmitted_blocks": 0, "tier_evictions": 0,
                      "tier_transfers": 0}

    # ------------------------------------------------------------- lookup
    def _blocks_of(self, prompt, max_tokens):
        """Token tuples of the prompt's full blocks within max_tokens."""
        prompt = np.asarray(prompt).reshape(-1)
        bs = self.block_size
        return [tuple(int(t) for t in prompt[i:i + bs])
                for i in range(0, (max_tokens // bs) * bs, bs)]

    def lookup(self, prompt, record=True):
        """Longest cached chain of full prompt blocks, as a list of nodes
        (possibly empty); never covers the final prompt token.
        ``record=False`` is a side-effect-free probe: stats and LRU ticks
        stay untouched, and nothing is readmitted from the host tier. A
        recording lookup that runs off the resident frontier readmits the
        spilled continuation first (:meth:`_readmit`)."""
        prompt = np.asarray(prompt).reshape(-1)
        matched = []
        children = self._root
        keys = self._blocks_of(prompt, len(prompt) - 1)
        for key in keys:
            node = children.get(key)
            if node is None:
                break
            matched.append(node)
            children = node.children
        if record and self.tier is not None and len(matched) < len(keys):
            self._readmit(matched, keys)
        if record:
            self.stats["lookups"] += 1
            if matched:
                tick = next(self._tick)   # touch-on-read keeps hot
                for node in matched:      # chains out of LRU's reach
                    node.tick = tick
                self.stats["hits"] += 1
                self.stats["hit_blocks"] += len(matched)
                self.stats["hit_tokens"] += len(matched) * self.block_size
            else:
                self.stats["misses"] += 1
        return matched

    def acquire(self, matched):
        """Pin a lookup's matched chain for a sequence's lifetime."""
        tick = next(self._tick)
        for node in matched:
            self.pool.ref(node.block_id)
            node.tick = tick

    def release(self, matched):
        """Drop a sequence's pins (exactly once, at retirement)."""
        for node in matched:
            self.pool.unref(node.block_id)

    # ---------------------------------------------------- host tier (spill)
    def _path_of(self, node):
        """The node's full root→node token path — its tier key."""
        path = []
        while node is not None:
            path.append(node.tokens)
            node = node.parent
        return tuple(reversed(path))

    def _spill(self, node):
        """Eviction's spill half: copy the doomed block's KV (and scale
        planes) device→host into the tier before the pool id is freed.
        Accounted on the tier ledger (``d2h``), never on the
        per-program transfer records."""
        bufs = self.pool.read_block(node.block_id)
        self.stats["tier_evictions"] += self.tier.put(
            self._path_of(node), bufs)
        self.stats["spilled_blocks"] += 1
        co = self.cost
        if co is not None:
            co.record_tier(
                "d2h", 1, sum(int(b.nbytes) for b in bufs.values()))

    def _readmit(self, matched, keys):
        """Readmission: the recording-lookup walk ran off the resident
        frontier — stream the spilled continuation back h2d, re-linking
        each block as a live trie node, and extend ``matched`` in place
        so the caller's acquire/install path sees readmitted blocks
        exactly like always-resident ones. Each block re-allocates
        through the same ``pool.alloc()`` + evict-on-demand path
        publishes use (the displaced LRU chains spill in turn), so the
        trie budget is displacement, not growth. Transient pins protect
        the chain being built — and the resident frontier leaf it hangs
        from — against this loop's own evictions; a pool exhausted by
        pins degrades to a partial readmit, never a failure."""
        pinned = []
        frontier = matched[-1] if matched else None
        if frontier is not None:
            # the frontier may be a zero-ref leaf; an eviction pass
            # below must not reap the node we are about to extend
            self.pool.ref(frontier.block_id)
        parent = frontier
        children = parent.children if parent is not None else self._root
        path = tuple(keys[:len(matched)])
        readmitted, nbytes = 0, 0
        try:
            for key in keys[len(matched):]:
                path = path + (key,)
                popped = self.tier.pop(path)
                if popped is None:
                    break
                bufs, buf_shared = popped
                block = self.pool.alloc()
                while block is None and self._evict_one():
                    block = self.pool.alloc()
                if block is None:      # everything pinned: degrade
                    self.tier.put(path, bufs, shared=buf_shared)
                    break
                self.pool.write_block(block, bufs)
                if not buf_shared:
                    # injected: the staging buffers are dead the moment
                    # the h2d completes — recycle_staging fences that
                    self.pool.recycle_staging(bufs)
                node = _Node(key, parent, block)
                node.tick = next(self._tick)
                children[key] = node
                self._nodes += 1
                self.pool.ref(node.block_id)
                pinned.append(node)
                matched.append(node)
                readmitted += 1
                nbytes += sum(int(b.nbytes) for b in bufs.values())
                children, parent = node.children, node
            if readmitted:
                self.stats["tier_hits"] += 1
                self.stats["readmitted_blocks"] += readmitted
                co = self.cost
                if co is not None:
                    co.record_tier("h2d", readmitted, nbytes)
                # trim back to the trie budget while the fresh chain is
                # still pinned: readmission displaces cold chains (which
                # spill in turn), it does not grow residency
                if self.max_blocks is not None:
                    while self._nodes > self.max_blocks \
                            and self._evict_one():
                        pass
        finally:
            for node in pinned:
                self.pool.unref(node.block_id)
            if frontier is not None:
                self.pool.unref(frontier.block_id)
        return matched

    # ------------------------------------------------------------ publish
    def publish(self, prompt, slot, kv_cache):
        """Insert every full prompt block into the trie, copying
        slot→pool for blocks not already cached (the dense engine). Runs
        at retirement, before the sequence's pins are released, so its
        own matched chain cannot be evicted mid-publish. Under pool
        pressure evicts LRU zero-ref leaves; skips (never fails) when
        nothing is evictable."""
        prompt = np.asarray(prompt).reshape(-1)
        bs = self.block_size
        children, parent = self._root, None
        tick = next(self._tick)
        walked = []  # this walk's own chain, pinned against its evictions
        try:
            for i, key in enumerate(self._blocks_of(prompt, len(prompt))):
                node = children.get(key)
                if node is None:
                    block = self.pool.alloc()
                    if block is None and self._evict_one():
                        block = self.pool.alloc()
                    if block is None:  # everything pinned: degrade
                        self.stats["skipped_publishes"] += 1
                        return
                    kv_cache.copy_block_out(slot, i * bs, self.pool, block)
                    node = _Node(key, parent, block)
                    children[key] = node
                    self._nodes += 1
                    self.stats["published_blocks"] += 1
                node.tick = tick
                # pin the chain so far: a later block's eviction pass must
                # never reap an earlier link of the chain being published
                self.pool.ref(node.block_id)
                walked.append(node)
                children, parent = node.children, node
        finally:
            for node in walked:
                self.pool.unref(node.block_id)

    def publish_donate(self, tokens, block_ids):
        """Paged-engine publish: insert every full token block by ADOPTING
        the retiring sequence's own pool block (an ownership handoff, no
        copy). ``tokens`` is the sequence's written row content (prompt
        plus generated tokens whose KV landed, capped by the engine at
        the slot's length); ``block_ids`` its table in logical order.

        Returns the set of adopted block ids: the caller hands their
        ownership pins to the trie (``PagedKVCache.free(keep=...)``).
        Blocks whose content is already cached are not adopted (the
        existing node wins). Needs no allocation, so it never evicts to
        make room and never fails; afterwards the trie is trimmed back to
        ``max_blocks`` by LRU eviction."""
        tokens = np.asarray(tokens).reshape(-1)
        children, parent = self._root, None
        tick = next(self._tick)
        walked = []
        donated = set()
        try:
            for i, key in enumerate(self._blocks_of(tokens, len(tokens))):
                if i >= len(block_ids):
                    break  # table shorter than the content (cancelled
                    # mid-chunked-prefill): donate what exists
                node = children.get(key)
                if node is None:
                    node = _Node(key, parent, int(block_ids[i]))
                    children[key] = node
                    self._nodes += 1
                    donated.add(int(block_ids[i]))
                    self.stats["published_blocks"] += 1
                    self.stats["donated_blocks"] += 1
                node.tick = tick
                self.pool.ref(node.block_id)
                walked.append(node)
                children, parent = node.children, node
        finally:
            for node in walked:
                self.pool.unref(node.block_id)
        # adopt first (the fresh chain carries the newest tick, so LRU
        # reaps older cold chains), then trim; pinned chains never evict,
        # so residency may exceed the budget until their pins release
        if self.max_blocks is not None:
            while self._nodes > self.max_blocks and self._evict_one():
                pass
        return donated

    # ----------------------------------------------------------- eviction
    def _iter_nodes(self):
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _evict_one(self) -> bool:
        """Evict the LRU (minimum-tick) zero-ref LEAF; False when nothing
        is evictable. Leaves first keeps every cached chain reachable from
        the root; ref(parent) >= ref(child) guarantees a zero-ref leaf
        exists whenever a zero-ref node does. With a host tier the block
        spills before its id is freed."""
        node = None
        for n in self._iter_nodes():
            if not n.children and self.pool.refcount(n.block_id) == 0 \
                    and (node is None or n.tick < node.tick):
                node = n
        if node is None:
            return False
        if self.tier is not None:
            self._spill(node)   # eviction = demotion, not deletion
        siblings = (node.parent.children if node.parent is not None
                    else self._root)
        del siblings[node.tokens]
        self.pool.free(node.block_id)
        self._nodes -= 1
        self.stats["evictions"] += 1
        return True

    # -------------------------------------------------------------- intro
    @property
    def num_cached_blocks(self) -> int:
        return self._nodes

    def hit_rate(self) -> float:
        n = self.stats["lookups"]
        return self.stats["hits"] / n if n else 0.0
