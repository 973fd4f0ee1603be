"""Serving observability of the port: the span tracer (:mod:`.tracing`),
the Prometheus registry (:mod:`.metrics`), the device-boundary cost
observatory (:mod:`.cost`) and the Chrome-trace reader behind
``python -m paddle_tpu_torch.profiler trace.json`` (:mod:`.chrometrace`).
The JAX package's XPlane reader (``jax.profiler`` trace directories) is
not ported: ROADMAP Queue A step 14."""
from __future__ import annotations

from . import cost, metrics, tracing  # noqa: F401
from .cost import CostObservatory  # noqa: F401
from .tracing import SpanTracer  # noqa: F401
