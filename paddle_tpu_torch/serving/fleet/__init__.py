"""Engine fleet — the port of ``paddle_tpu/serving/fleet``: replicated
serving with prefix-affinity routing, failover to a sibling and live
request migration (README "Engine fleet").

Public surface:

- :class:`EngineFleet` — N supervised engine replicas (each a
  gateway: own paged pool, prefix trie, scheduler, supervisor) behind
  one routing front door, with program records shared per pool
  geometry, one ``replica``-labeled metrics registry, failover of a
  dead replica's live requests to siblings, and live migration /
  drain / rebalance built on ``engine.evict()`` + ``restore()``;
- :class:`FleetReplica` — one replica's fleet-side handle (router
  signals + the ``/debug/fleet`` row);
- :class:`Router` / :class:`RoundRobinRouter` /
  :class:`LeastLoadedRouter` / :class:`PrefixAffinityRouter` /
  :class:`ClassHeadroomRouter` / :func:`make_router` — the pluggable
  routing policies (``class-headroom`` routes by per-replica
  non-displaceable class pressure — README "Multi-tenant SLO
  serving").

The HTTP surface (``--replicas N`` / ``serve_fleet()``: routed
``/v1/completions``, ``GET /debug/fleet``, ``POST /fleet/drain`` and
``POST /fleet/rebalance``) lives in
:mod:`paddle_tpu_torch.serving.server.httpd`.
"""
from .fleet import EngineFleet
from .replica import FleetReplica
from .router import (ClassHeadroomRouter, LeastLoadedRouter,
                     PrefixAffinityRouter, RoundRobinRouter, Router,
                     make_router)

__all__ = [
    "EngineFleet", "FleetReplica", "Router", "RoundRobinRouter",
    "LeastLoadedRouter", "PrefixAffinityRouter", "ClassHeadroomRouter",
    "make_router",
]
