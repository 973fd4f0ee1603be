"""One replica of the engine fleet — the port of
``paddle_tpu/serving/fleet/replica.py``: a supervised gateway plus the
fleet-side bookkeeping the router and the ``/debug/fleet`` table read.

A replica IS a :class:`~paddle_tpu_torch.serving.server.ServingGateway`
— its own paged pool, prefix trie, scheduler, supervisor, tracer and
cost observatory — shared-nothing except for the model's weights, the
serving programs' records (the fleet hands same-geometry replicas one
``jit_cache`` dict) and the fleet's shared metrics registry (each
replica registers through a ``registry.labeled(replica=...)`` view, so
one ``/metrics`` scrape covers the fleet with every series labeled by
replica).

The load/affinity accessors here are scrape-style reads of host
bookkeeping the replica's driver thread writes (ints and short lists
under the GIL — the same discipline as the gateway's scrape-time
gauges): the router calls them from submit threads while the driver
steps.
"""
from __future__ import annotations

import numpy as np


class FleetReplica:
    """Fleet-side handle for one supervised engine replica."""

    def __init__(self, index, gateway):
        self.index = int(index)
        self.gateway = gateway
        #: router admission flag — False while draining (live work
        #: migrates out, new work routes around it)
        self.accepting = True
        #: set by the fleet's failover hook when this replica's driver
        #: died past its restart budget (its live requests were
        #: re-admitted on siblings)
        self.dead = False

    # ------------------------------------------------------------ signals
    @property
    def alive(self) -> bool:
        return not self.dead and not self.gateway.closed

    @property
    def routable(self) -> bool:
        return self.alive and self.accepting

    @property
    def state(self) -> str:
        """``dead`` | ``draining`` | the gateway's health state
        (``ok``/``degraded``/``recovering``) — the ``/debug/fleet``
        state column."""
        if self.dead:
            return "dead"
        if not self.accepting or self.gateway.closed:
            return "draining"
        return self.gateway.health_state

    def live_kv_blocks(self) -> int:
        """Distinct pool blocks live slots reference (paged), or the
        dense equivalent (active slots × per-slot block budget is
        meaningless there, so active slots stand in) — the KV half of
        the load signal."""
        eng = self.gateway.engine
        if getattr(eng, "_paged", False):
            return int(eng.cache.occupancy()["live"])
        return int(eng.num_active)

    def free_kv_blocks(self) -> int:
        eng = self.gateway.engine
        if getattr(eng, "_paged", False):
            return int(eng.cache.pool.num_free)
        return int(eng.cache.num_free)

    def load(self) -> int:
        """The router's load scalar: live KV blocks + waiting-room
        depth. Both are monotone in how long a new admission would
        wait, and both are already maintained host-side — reading them
        costs two ints."""
        return self.live_kv_blocks() + int(self.gateway.queue_depth)

    def can_hold(self, request) -> bool:
        """Whether this replica's engine can hold ``request`` to
        completion — the ``engine.validate`` KV-length bound, checked
        fleet-side so routing, failover and migration never place a
        request on a replica whose ``max_seq_len`` is too small for it
        (per-replica geometries are a feature; an oversized adoption
        would crash the target's driver mid-recompute and cascade)."""
        try:
            need = (int(np.asarray(request.prompt).reshape(-1).shape[0])
                    + int(request.max_new_tokens))
        except Exception:
            return True         # malformed: let validate() raise the 400
        return need <= self.gateway.engine.max_seq_len

    def prefix_match_tokens(self, prompt) -> int:
        """Longest cached-prefix coverage (tokens) this replica's trie
        holds for ``prompt`` — a side-effect-free probe
        (``lookup(record=False)``: no stats, no LRU touches), so
        routing never perturbs the hit/miss accounting the bench
        banks."""
        pc = self.gateway.engine.prefix_cache
        if pc is None or prompt is None:
            return 0
        try:
            return pc.block_size * len(pc.lookup(prompt, record=False))
        except Exception:
            return 0        # racing a driver-side trie mutation: cold

    def tier_match_tokens(self, prompt) -> int:
        """Tokens of ``prompt`` this replica's OWN host tier could
        readmit beyond the trie frontier: the contiguous run of
        spilled blocks continuing the trie match (README "Tiered KV
        prefix cache": capacity-aware placement).
        The affinity router adds it to :meth:`prefix_match_tokens`, so
        a chain that spilled under pool pressure still attracts its
        prefix family to the replica that HOLDS it (a host-RAM readmit)
        instead of a sibling that would pull it host-to-host over the
        cache plane. Side-effect-free like the trie probe; 0 on
        tierless replicas, so every tierless routing order is
        unchanged."""
        pc = self.gateway.engine.prefix_cache
        if pc is None or prompt is None or pc.tier is None:
            return 0
        try:
            # len-1 bound like every admission-side probe: a lookup
            # never covers the final prompt token (the suffix prefill
            # needs one token to sample from)
            keys = pc._blocks_of(prompt, len(prompt) - 1)
            covered = len(pc.lookup(prompt, record=False))
            n = 0
            for depth in range(covered, len(keys)):
                if not pc.tier.has(keys[:depth + 1]):
                    break
                n += 1
            return pc.block_size * n
        except Exception:
            return 0        # racing a driver-side tier mutation: cold

    def class_counts(self) -> dict:
        """Per-class occupancy ``{class_name: count}`` over this
        replica's engine-held work — running/prefilling slots plus the
        scheduler queue (the gateway intake is not yet classed). A
        scrape-style read like :meth:`load`."""
        eng = self.gateway.engine
        counts = {}
        try:
            seqs = [s for s in eng._slots if s is not None and not s.done]
            seqs += [s for s in eng.scheduler.queue
                     if getattr(s, "done", False) is False]
            for seq in seqs:
                pclass = getattr(seq, "pclass", None)
                name = pclass.name if pclass is not None \
                    else eng.classes.default
                counts[name] = counts.get(name, 0) + 1
        except Exception:
            return counts   # racing a driver-side mutation: partial
        return counts

    def class_pressure(self, request) -> int:
        """The load on this replica that could NOT be displaced for
        ``request``: engine-held work of class rank >= the request's
        resolved rank (equals never displace equals), plus the unclassed
        gateway intake. The class-headroom router's primary signal — a
        latency request never lands on a replica saturated with
        equal-or-higher-rank work while a sibling holds preemptible
        batch load."""
        eng = self.gateway.engine
        try:
            rank = eng.classes.resolve(
                getattr(request, "priority_class", None)).rank
        except ValueError:
            rank = 0        # unknown class 400s at submit; rank moot
        pressure = int(self.gateway.queue_depth) \
            - int(eng.scheduler.num_queued)
        pressure = max(pressure, 0)     # intake-only share of the queue
        try:
            seqs = [s for s in eng._slots if s is not None and not s.done]
            seqs += list(eng.scheduler.queue)
            for seq in seqs:
                pclass = getattr(seq, "pclass", None)
                if pclass is None or pclass.rank >= rank:
                    pressure += 1
        except Exception:
            pass            # racing a driver-side mutation: partial
        return pressure

    # --------------------------------------------------------- debug table
    def row(self) -> dict:
        """One ``/debug/fleet`` row — state + the router's live signals
        + the cost-attribution columns, computed exactly as the
        ``/metrics``/``/debug/profile`` surfaces compute them (same
        carried-counter reads, same dispatches-per-decoded-token
        formula), so the fleet table can never disagree with the
        per-replica scrape."""
        gw = self.gateway
        eng = gw.engine
        row = {
            "replica": self.index,
            "state": self.state,
            "accepting": bool(self.accepting),
            "num_slots": int(eng.num_slots),
            "active_slots": int(eng.num_active),
            "queue_depth": int(gw.queue_depth),
            "live_kv_blocks": self.live_kv_blocks(),
            "free_kv_blocks": self.free_kv_blocks(),
            "load": self.load(),
            "tokens_generated": int(gw._stat("tokens_generated")),
            "restarts": int(gw.restarts),
            "last_rebuild_age_s": (
                None if gw.last_restart_at is None
                else round(gw._clock() - gw.last_restart_at, 3)),
        }
        if gw.cost is not None:
            row["dispatches"] = int(gw.cost.totals["dispatches"])
            row["dispatches_per_decoded_token"] = round(
                gw.cost.totals["dispatches"]
                / max(gw._stat("tokens_generated"), 1), 4)
        if eng.prefix_cache is not None:
            hits = gw._pc_stat("hits")
            misses = gw._pc_stat("misses")
            row["prefix_hits"] = int(hits)
            row["prefix_hit_rate"] = round(
                hits / max(hits + misses, 1), 4)
            if eng.prefix_cache.tier is not None:
                # the cache-plane columns (README "Tiered KV prefix
                # cache"), same carried reads as /fleet/cacheplane
                row["tier_blocks"] = eng.prefix_cache.tier.num_blocks
                row["tier_hits"] = int(gw._pc_stat("tier_hits"))
                row["tier_transfers_in"] = int(
                    gw._pc_stat("tier_transfers"))
        if eng.classes.active:
            # per-class occupancy + the policy counters (README
            # "Multi-tenant SLO serving") — present only with a
            # multi-class table, so a policy-off fleet table is
            # unchanged
            row["classes"] = self.class_counts()
            row["policy_preemptions"] = int(
                gw._stat("policy_preemptions"))
        return row

    def __repr__(self):
        return (f"FleetReplica(index={self.index}, state={self.state}, "
                f"load={self.load()})")
