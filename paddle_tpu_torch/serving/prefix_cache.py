"""Automatic prefix caching: block-granular KV reuse across requests.

The port's own copy of ``paddle_tpu/serving/prefix_cache.py``'s
``PrefixCache`` (the host-RAM spill tier, ``HostTier``, is not ported:
ROADMAP Queue A step 9, host tier). Published KV blocks are keyed by
their token content, so an admission whose prompt shares a cached block
chain skips the device work for every covered block:

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

Everything here is host work on the engine's driver thread (no locks);
the device work is the block copies and the suffix prefill program.
"""
from __future__ import annotations

import itertools

import numpy as np


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
        if int(host_tier_bytes):
            raise NotImplementedError(
                "host_tier_bytes is not ported to paddle_tpu_torch yet "
                "(ROADMAP Queue A step 9 (host tier))")
        self.pool = pool
        self.block_size = pool.block_size
        self.max_blocks = None if max_blocks is None else int(max_blocks)
        self.host_tier_bytes = 0
        # the spill tier and its cost ledger are not ported: the gateway
        # reads None here, as from a reference cache built without a tier
        self.tier = None
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
        stay untouched."""
        prompt = np.asarray(prompt).reshape(-1)
        matched = []
        children = self._root
        for key in self._blocks_of(prompt, len(prompt) - 1):
            node = children.get(key)
            if node is None:
                break
            matched.append(node)
            children = node.children
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
        exists whenever a zero-ref node does."""
        node = None
        for n in self._iter_nodes():
            if not n.children and self.pool.refcount(n.block_id) == 0 \
                    and (node is None or n.tick < node.tick):
                node = n
        if node is None:
            return False
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
