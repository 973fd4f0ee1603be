"""Request routing policy for the engine fleet — the port of
``paddle_tpu/serving/fleet/router.py`` (README "Engine fleet"): pure
host code, the reference's policies and tie-breaks unchanged.

One gateway fronts N shared-nothing engine replicas; the router decides
which replica admits each request. Two signals matter at fleet scale
(the Gemma-on-TPU serving study and the AlpaServe-style placement
results, PAPERS.md: routing/replication policy — not the kernel —
dominates fleet goodput):

- **Load**: a replica's live KV blocks plus its waiting-room depth —
  the same occupancy the engine's own admission control and /metrics
  gauges read. Routing to the least-loaded replica bounds queue wait.
- **Prefix affinity**: each replica owns its own prefix trie, so a
  request routed away from the replica that cached its prompt prefix
  re-prefills from scratch. Affinity routing sends a request to the
  replica with the LONGEST cached prefix — but only within a LOAD BAND
  of the least-loaded replica, so cache hits survive fan-out without
  letting one hot prefix melt a single replica.

Policies are pure host-side functions of the replicas' current
signals: no clock reads, no randomness — under a
:class:`~paddle_tpu_torch.serving.faults.VirtualClock` (or any fixed load
state) a submission order routes identically on every replay, which is
what makes the fleet chaos matrix deterministic. Ties break toward the
LOWEST replica index, always.

``rank()`` returns the full preference order (best first): the fleet
retries down the list when a replica's waiting room is full, so a
burst sheds sideways before it 429s.
"""
from __future__ import annotations

import itertools


class Router:
    """Policy base: rank replicas for one request, best first."""

    name = "base"

    def rank(self, request, replicas):
        raise NotImplementedError

    def route(self, request, replicas):
        """The chosen replica (rank head), or None with nothing
        routable."""
        order = self.rank(request, replicas)
        return order[0] if order else None


class RoundRobinRouter(Router):
    """Rotate admissions across replicas in index order — the
    load-blind, affinity-blind baseline the fleet bench compares
    against."""

    name = "round-robin"

    def __init__(self):
        self._turn = itertools.count()

    def rank(self, request, replicas):
        reps = sorted(replicas, key=lambda r: r.index)
        if not reps:
            return []
        k = next(self._turn) % len(reps)
        return reps[k:] + reps[:k]


class LeastLoadedRouter(Router):
    """Route to the replica with the lowest load — live KV blocks +
    waiting-room depth (:meth:`~.replica.FleetReplica.load`). Ties
    break to the lowest replica index (deterministic, pinned by
    tests)."""

    name = "least-loaded"

    def rank(self, request, replicas):
        return sorted(replicas, key=lambda r: (r.load(), r.index))


class PrefixAffinityRouter(Router):
    """Least-loaded composed with prefix affinity: among the replicas
    whose load is within ``band`` of the minimum (the load band), the
    longest cached-prefix match wins — so a warm trie keeps attracting
    its prefix family and the aggregate hit-rate survives fan-out —
    while a replica loaded past the band is skipped no matter how warm
    its trie is (affinity must never invert into a hot spot). Within
    the band ties break by load, then index; out-of-band replicas rank
    after the band by plain least-loaded order.

    ``band`` is in load units (KV blocks + queued requests). ``0``
    restricts affinity to exact-minimum-load replicas; the default 16
    tolerates roughly one mid-flight request of imbalance.
    """

    name = "affinity"

    def __init__(self, band=16):
        if int(band) < 0:
            raise ValueError(f"band must be >= 0, got {band}")
        self.band = int(band)

    def rank(self, request, replicas):
        reps = list(replicas)
        if not reps:
            return []
        loads = {r.index: r.load() for r in reps}
        floor = min(loads.values())
        in_band = [r for r in reps if loads[r.index] - floor <= self.band]
        out = [r for r in reps if loads[r.index] - floor > self.band]
        prompt = getattr(request, "prompt", None)
        # capacity-aware placement: a replica's warmth is its trie
        # coverage PLUS what its own host tier could readmit in place —
        # so a chain that spilled under pool pressure still attracts its
        # prefix family to the replica HOLDING it (host-RAM readmit)
        # instead of a sibling that would pull the chain host-to-host
        # over the cache plane after placement. Tierless replicas probe
        # 0, leaving every tierless routing order unchanged (duck-typed:
        # stubs without the tier probe contribute 0).
        def warmth(r):
            tier = getattr(r, "tier_match_tokens", None)
            return (r.prefix_match_tokens(prompt)
                    + (tier(prompt) if tier is not None else 0))
        in_band.sort(key=lambda r: (-warmth(r), loads[r.index], r.index))
        out.sort(key=lambda r: (loads[r.index], r.index))
        return in_band + out


class ClassHeadroomRouter(Router):
    """Class-aware placement (README "Multi-tenant SLO serving"): rank
    by the replica's CLASS PRESSURE for this request — the load that
    could not be displaced for it (work of equal-or-higher class rank
    plus unclassed intake, :meth:`~.replica.FleetReplica.class_pressure`)
    — then by total load, then index. A latency request routes to the
    replica whose occupancy is mostly preemptible batch work (low
    pressure) over an equally-busy sibling running latency work (high
    pressure), so a burst lands where the policy scheduler can actually
    clear slots for it; batch requests see every slot as pressure and
    degrade to plain least-loaded. With no class table every request
    resolves to one rank and this IS least-loaded routing.

    ``rebalance``/``drain_replica`` are the matching actuator: drain a
    replica of best-effort load to absorb a latency burst, and the
    pressure signal immediately steers the burst at it.
    """

    name = "class-headroom"

    def rank(self, request, replicas):
        return sorted(replicas,
                      key=lambda r: (r.class_pressure(request),
                                     r.load(), r.index))


#: CLI / serve_fleet() name -> constructor
ROUTERS = {
    RoundRobinRouter.name: RoundRobinRouter,
    LeastLoadedRouter.name: LeastLoadedRouter,
    PrefixAffinityRouter.name: PrefixAffinityRouter,
    ClassHeadroomRouter.name: ClassHeadroomRouter,
}


def make_router(policy, **kw) -> Router:
    """Build a router from its policy name (``round-robin`` |
    ``least-loaded`` | ``affinity`` | ``class-headroom``); a
    :class:`Router` instance passes through unchanged."""
    if isinstance(policy, Router):
        return policy
    try:
        return ROUTERS[str(policy)](**kw)
    except KeyError:
        raise ValueError(
            f"unknown router policy {policy!r}; choose from "
            f"{sorted(ROUTERS)}") from None
