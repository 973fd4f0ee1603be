"""Async serving gateway: streaming HTTP front-end over the
continuous-batching engine — the port of ``paddle_tpu/serving/server``.

Two layers (both stdlib-only):

- :mod:`.gateway` — :class:`ServingGateway`, the engine-driver thread
  plus a thread-safe front door handing back per-token
  :class:`TokenStream` iterators, with cancellation, deadlines,
  bounded-queue admission control, graceful drain and the supervised
  driver (fault classification, rebuild and recovery by recompute,
  poison bisection);
- :mod:`.httpd` — :class:`ServingHTTPServer` / :func:`serve`, the
  OpenAI-style HTTP surface (``POST /v1/completions`` blocking + SSE,
  ``GET /healthz``, ``GET /metrics`` in Prometheus text format, and
  the debug surface ``GET /debug/trace``, ``/debug/requests`` and
  ``/debug/profile``).

Run one with ``python -m paddle_tpu_torch.serving.server`` (on the card
by default; ``--device cpu`` asks for the CPU); ``--replicas N`` (or
:func:`serve_fleet`) serves an engine fleet (``serving/fleet``) behind
the same surface plus ``/debug/fleet``, ``/fleet/cacheplane``,
``POST /fleet/drain`` and ``POST /fleet/rebalance``.
"""
from .gateway import (GatewayClosedError, QueueFullError, ServingGateway,
                      TokenStream, TraceBusyError, WatchdogTimeout)
from .httpd import ServingHTTPServer, serve, serve_fleet

__all__ = [
    "ServingGateway", "TokenStream", "QueueFullError",
    "GatewayClosedError", "WatchdogTimeout", "TraceBusyError",
    "ServingHTTPServer", "serve", "serve_fleet",
]
