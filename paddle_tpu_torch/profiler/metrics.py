"""Prometheus text exposition for the serving gateway, and the card's
peak rate — the port's own copy of ``paddle_tpu/profiler/metrics.py``'s
registry half (:class:`Counter` / :class:`Gauge` / :class:`Histogram`
collected by a :class:`MetricsRegistry`, and the bucket ladders the
gateway's histograms use). Dependency-free: the gateway's
``GET /metrics`` renders through it.

:func:`peak_flops_per_chip` is the one device-aware function: the JAX
package reads a TPU generation's bf16 peak; here the card's name comes
from ``torch.cuda.get_device_name()`` and the table holds the H100's
dense bf16 peak (NVIDIA's data sheet, SXM part). A card the table does
not know raises rather than assume a rate.
"""
from __future__ import annotations

import threading

#: dense bf16 peak FLOP/s by card name (NVIDIA data sheet, no sparsity)
PEAK_FLOPS = {
    "h100": 989e12,
}


def peak_flops_per_chip(device=None) -> float:
    """The dense bf16 peak of CUDA device ``device`` (default: the
    current one). Raises for a card the table does not know."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("peak_flops_per_chip needs a CUDA device")
    name = torch.cuda.get_device_name(device)
    for k, v in PEAK_FLOPS.items():
        if k in name.lower():
            return v
    raise ValueError(f"no peak rate known for {name!r}; known cards: "
                     f"{sorted(PEAK_FLOPS)}")

# --------------------------------------------------- prometheus exposition
# Text format per the Prometheus exposition spec v0.0.4: one HELP + TYPE
# comment per metric family, then one sample line per (label set), with
# histograms expanded to cumulative ``_bucket{le=...}`` series plus
# ``_sum``/``_count``. No client_golang-style background machinery — a
# scrape renders the current values under one registry lock.

def _escape_help(s):
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s):
    return (str(s).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_value(v):
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _label_str(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    """Base: one metric family, keyed by label values. Thread-safe —
    the serving gateway increments from its driver thread while HTTP
    handler threads render scrapes."""

    kind = None

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series = {}  # label-items tuple -> value/state

    def _key(self, labels):
        return tuple(sorted(labels.items()))

    def expose(self):
        """Exposition lines for this family (HELP/TYPE + samples).
        Samples render UNDER the lock: a histogram's counts/sum/count
        must come from one consistent instant or a concurrent observe()
        can produce a non-cumulative (corrupt-looking) scrape."""
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            for key, state in sorted(self._series.items()):
                lines.extend(self._sample_lines(dict(key), state))
        return lines

    def _sample_lines(self, labels, state):
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing value (e.g. total tokens generated).

    ``set_fn`` registers a callable sampled at scrape time, for counters
    whose source of truth is an existing monotonic count elsewhere (the
    serving gateway points the prefix-cache hit/miss/eviction counters
    at the cache's own stats dict this way). The callable must be
    monotonically non-decreasing — Prometheus counter semantics — and a
    series is either incremented or fn-backed, never both."""

    kind = "counter"

    def inc(self, value=1, **labels):
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = self._key(labels)
        with self._lock:
            cur = self._series.get(key, 0)
            if callable(cur):
                raise ValueError(
                    f"counter {self.name} series is scrape-time (set_fn); "
                    f"inc() would fork its source of truth")
            self._series[key] = cur + value

    def set_fn(self, fn, **labels):
        key = self._key(labels)
        with self._lock:
            cur = self._series.get(key)
            if cur is not None and not callable(cur) and cur != 0:
                # the registry dedupes by name, so a second component
                # can reach a counter someone else already inc()'d;
                # silently replacing its accumulated count would scrape
                # as a spurious counter reset
                raise ValueError(
                    f"counter {self.name} series already holds "
                    f"incremented value {cur}; set_fn() would discard it")
            self._series[key] = fn

    def value(self, **labels):
        with self._lock:
            v = self._series.get(self._key(labels), 0)
        return v() if callable(v) else v

    def _sample_lines(self, labels, state):
        v = state() if callable(state) else state
        return [f"{self.name}{_label_str(labels)} {_fmt_value(v)}"]


class Gauge(_Metric):
    """Point-in-time value (e.g. queue depth, active slots). ``set_fn``
    registers a callable sampled at scrape time so the gauge can't go
    stale between updates."""

    kind = "gauge"

    def set(self, value, **labels):
        with self._lock:
            self._series[self._key(labels)] = value

    def inc(self, value=1, **labels):
        key = self._key(labels)
        with self._lock:
            cur = self._series.get(key, 0)
            self._series[key] = (cur() if callable(cur) else cur) + value

    def dec(self, value=1, **labels):
        self.inc(-value, **labels)

    def set_fn(self, fn, **labels):
        with self._lock:
            self._series[self._key(labels)] = fn

    def value(self, **labels):
        with self._lock:
            v = self._series.get(self._key(labels), 0)
        return v() if callable(v) else v

    def _sample_lines(self, labels, state):
        v = state() if callable(state) else state
        return [f"{self.name}{_label_str(labels)} {_fmt_value(v)}"]


# request latencies span ~ms (CPU tiny model) to minutes (long decodes)
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0, 60.0, 120.0)

# time-to-first-token ladder (``serving_ttft_seconds``): TTFT is the
# latency chunked prefill exists to bound, so its low end needs sub-ms
# resolution (a CPU tiny-model decode tick is ~1 ms; a healthy TTFT on
# real chips is tens of ms) while the tail still distinguishes a
# 1 s stall from a 10 s one.
TTFT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# engine-step duration ladder (``serving_step_duration_seconds``): one
# unified serving step is ~sub-ms on real chips and tens of ms on the
# CPU tiny models; the top distinguishes a chunk-heavy 1 s step from a
# wedged 10 s one. These observations are the same signal the engine's
# headroom EWMAs (the adaptive chunk budget) read.
STEP_BUCKETS = (0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                0.1, 0.25, 0.5, 1.0, 2.5, 10.0)

# time-per-output-token ladder (``serving_tpot_seconds``): the
# steady-state decode cadence one request observes — (finish - first
# token) / (tokens - 1). Sub-ms resolution at the bottom (a healthy
# TPOT on real chips is single-digit ms; the CPU tiny models sit at
# ~1-30 ms), a tail that separates a 100 ms-per-token crawl from a
# seconds-per-token stall. This histogram is the SLO substrate the
# multi-tenant scheduler's TPOT targets will read (ROADMAP item b).
TPOT_BUCKETS = (0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                0.1, 0.25, 0.5, 1.0, 2.5, 10.0)

# queue-wait ladder (``serving_queue_wait_seconds``): submit-to-slot
# latency — the admission-control half of TTFT (TTFT = queue wait +
# prefill). Same sub-ms-to-tens-of-seconds span as the TTFT ladder: an
# uncontended admission is instant, a saturated waiting room is
# seconds, and the top separates "waited a while" from "starved".
QUEUE_WAIT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                      0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# speculative-decode acceptance-length ladder
# (``serving_spec_accept_length``): tokens emitted per verify span, 1 =
# nothing accepted (the guaranteed correction token), spec_k + 1 = a
# fully accepted draft; whole-number bounds, one count a bucket
SPEC_ACCEPT_BUCKETS = (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 12.0, 16.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (latency distributions).

    :meth:`quantile` estimates order statistics from the bucket counts
    (the ``histogram_quantile``-style interpolation) — good enough for
    p95 acceptance gates (scripts/bench_chunked.py) without recording
    raw observations.
    """

    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        b = sorted(float(x) for x in buckets)
        if not b:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.buckets = tuple(b)

    def observe(self, value, **labels):
        key = self._key(labels)
        with self._lock:
            state = self._series.get(key)
            if state is None:
                state = {"counts": [0] * len(self.buckets),
                         "sum": 0.0, "count": 0}
                self._series[key] = state
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    state["counts"][i] += 1
            state["sum"] += value
            state["count"] += 1

    def quantile(self, q, **labels):
        """Estimate the ``q``-quantile (0 < q <= 1) from the bucket
        counts, Prometheus ``histogram_quantile`` style: find the
        bucket the target rank lands in and interpolate linearly inside
        it (lower edge = previous bucket bound, 0 below the first).
        Observations above the last finite bucket clamp to that bound —
        same behavior as PromQL, and the reason the ladder's top bucket
        should sit above any latency you care to distinguish. Returns
        0.0 for an empty series."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"quantile q must be in (0, 1], got {q}")
        with self._lock:
            state = self._series.get(self._key(labels))
            if state is None or not state["count"]:
                return 0.0
            counts = list(state["counts"])
            total = state["count"]
        target = q * total
        prev_count, lower = 0, 0.0
        for ub, c in zip(self.buckets, counts):
            if c >= target:
                if c == prev_count:   # empty bucket can't be hit; guard
                    return ub
                frac = (target - prev_count) / (c - prev_count)
                return lower + (ub - lower) * frac
            prev_count, lower = c, ub
        return self.buckets[-1]       # rank beyond the last finite bound

    def _sample_lines(self, labels, state):
        lines = []
        for ub, c in zip(self.buckets, state["counts"]):
            bl = dict(labels, le=_fmt_value(ub))
            lines.append(f"{self.name}_bucket{_label_str(bl)} {c}")
        bl = dict(labels, le="+Inf")
        lines.append(f"{self.name}_bucket{_label_str(bl)} {state['count']}")
        lines.append(f"{self.name}_sum{_label_str(labels)} "
                     f"{_fmt_value(state['sum'])}")
        lines.append(f"{self.name}_count{_label_str(labels)} "
                     f"{state['count']}")
        return lines


class _BoundMetric:
    """A metric family viewed through a fixed label set: every
    operation merges the bound labels into its call — the mechanism
    behind the fleet's ``replica=\"i\"`` series (one shared registry,
    N gateways, no series collisions). Explicit per-call labels win on
    a key clash (they are more specific)."""

    __slots__ = ("_metric", "_labels")

    def __init__(self, metric, labels):
        self._metric = metric
        self._labels = dict(labels)

    @property
    def name(self):
        return self._metric.name

    @property
    def buckets(self):
        return self._metric.buckets

    def _merge(self, labels):
        return {**self._labels, **labels}

    def inc(self, value=1, **labels):
        return self._metric.inc(value, **self._merge(labels))

    def dec(self, value=1, **labels):
        return self._metric.dec(value, **self._merge(labels))

    def set(self, value, **labels):
        return self._metric.set(value, **self._merge(labels))

    def set_fn(self, fn, **labels):
        return self._metric.set_fn(fn, **self._merge(labels))

    def observe(self, value, **labels):
        return self._metric.observe(value, **self._merge(labels))

    def value(self, **labels):
        return self._metric.value(**self._merge(labels))

    def quantile(self, q, **labels):
        return self._metric.quantile(q, **self._merge(labels))


class _LabeledRegistry:
    """A :class:`MetricsRegistry` view that stamps every series
    registered through it with fixed labels (see
    :meth:`MetricsRegistry.labeled`). Families are still created in —
    and rendered by — the underlying registry, so N views over one
    registry expose one coherent ``/metrics`` document with each
    component's series distinguished by its labels."""

    def __init__(self, base, labels):
        self._base = base
        self._labels = dict(labels)

    def counter(self, name, help=""):
        return _BoundMetric(self._base.counter(name, help), self._labels)

    def gauge(self, name, help=""):
        return _BoundMetric(self._base.gauge(name, help), self._labels)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS):
        return _BoundMetric(self._base.histogram(name, help,
                                                 buckets=buckets),
                            self._labels)

    def labeled(self, **labels):
        return _LabeledRegistry(self._base, {**self._labels, **labels})

    def render(self) -> str:
        return self._base.render()


class MetricsRegistry:
    """Named collection of metric families; ``render()`` is the whole
    ``GET /metrics`` response body."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _register(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}")
                return m
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name, help="") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name, help="",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def render(self) -> str:
        with self._lock:
            fams = [self._metrics[k] for k in sorted(self._metrics)]
        lines = []
        for m in fams:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def labeled(self, **labels) -> _LabeledRegistry:
        """A view of this registry that stamps every series registered
        through it with ``labels`` — how the engine-fleet gives each
        replica's gateway its own ``replica=\"i\"`` series in ONE
        shared registry (one ``/metrics`` scrape covers the fleet, and
        each replica's carried counter bases stay per-replica, so any
        single replica rebuild keeps every series monotonic)."""
        return _LabeledRegistry(self, labels)
