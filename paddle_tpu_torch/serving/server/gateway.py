"""Async request gateway over the continuous-batching engine — the port
of ``paddle_tpu/serving/server/gateway.py``.

The engine is single-threaded by contract (``step()`` mutates slot
state, host length mirrors, and jitted-program caches with no locks).
This module makes it servable without breaking that contract: ONE
driver thread owns the engine and pumps ``step()``; every other thread
talks to the gateway through a thread-safe front door —

- :meth:`ServingGateway.submit` enqueues a request from any thread and
  hands back a :class:`TokenStream`, a per-token iterator fed by the
  engine's ``on_token`` callback the moment each token reaches the
  host;
- :meth:`TokenStream.cancel` flags a request from any thread; the
  driver applies it between steps via ``engine.cancel`` — the KV slot
  frees mid-decode and the ragged decode kernel skips it from the next
  step on, so cancellation costs nothing;
- admission control is a bounded waiting-room: submissions past
  ``max_queue`` raise :class:`QueueFullError` (the HTTP layer's 429)
  instead of growing an unbounded backlog;
- :meth:`ServingGateway.shutdown` drains gracefully — the front door
  closes, in-flight sequences run to completion, then the driver
  exits (or ``drain=False`` cancels everything in flight).

Deadlines ride on the engine itself (``GenerationRequest.timeout_s``,
checked at step boundaries), so a request expires whether it is queued
or mid-decode, and the gateway just observes the ``"timeout"`` finish.

The driver loop is SUPERVISED (README "Fault tolerance & chaos
testing"): an exception out of ``engine.step()`` no longer kills
serving forever. The supervisor classifies each step failure —

- **transient** (:class:`~..faults.TransientFault`, or any type in
  ``transient_types``): retry the same engine with bounded backoff; a
  streak past ``max_transient_retries`` escalates to fatal;
- **hung**: a step whose measured duration (injectable ``clock``)
  overran ``watchdog_deadline_s`` — treated as fatal, and externally
  visible either way through the
  ``serving_watchdog_last_step_age_seconds`` gauge and ``/healthz``;
- **fatal** (everything else): rebuild the engine via
  ``engine_factory`` and RECOVER every in-flight request by recompute
  — each live sequence's prompt + generated-so-far tokens are known
  host-side, so ``engine.restore()`` re-enqueues them as (chunked)
  prefills and streams continue byte-identically for greedy requests;
  the factory shares the model-level jit cache, so the rebuilt engine
  counts no new program (``decode_compilations()`` stays 1). The dead
  engine's KV storage is released BEFORE the factory runs, so a rebuild
  never holds two pools on the card.

If a fault recurs while the last recovery's readmissions are still
live, the supervisor assumes a POISON request is pinned to the crash
and bisects the readmitted set: half re-enters, half parks outside the
engine; the half the fault follows keeps shrinking until a single
culprit remains, which is the ONLY request failed
(``finish_reason="error"`` — SSE clients get a final error event,
blocking clients a JSON 500) while every bystander — parked or
readmitted — runs to completion. ``max_restarts`` bounds the total
rebuild budget; past it the gateway gives up and strands with errors
(the pre-supervision behavior).

The compile-once property survives serving AND recovery: the gateway
adds no device-side work, so ``decode_compilations()`` stays at one per
``(num_slots, token_budget, n_steps)`` no matter the HTTP traffic mix
or how many times the engine was rebuilt — pinned by
tests/test_torch_server.py and tests/test_torch_faults.py.

The watchdog exempts a step that recorded a new program (the
reference's rule for a step that traced one) or in which a CUDA kernel
library was built or loaded (``kernels/_build.py`` compiles a kernel at
its first launch): neither is a hang.

The fleet plane (``serving/fleet``): :meth:`ServingGateway.adopt` and
:meth:`ServingGateway.request_migration` move a live request between
replica gateways by ``engine.evict`` / ``engine.restore`` on the two
driver threads, and ``on_fatal`` hands a dying driver's live requests to
a sibling before any is stranded.
"""
from __future__ import annotations

import atexit
import collections
import itertools
import queue
import threading
import time
import weakref

import numpy as np

from ...kernels import _build
from ...profiler.cost import PROGRAM_KINDS, CostObservatory
from ...profiler.metrics import (QUEUE_WAIT_BUCKETS, SPEC_ACCEPT_BUCKETS,
                                 STEP_BUCKETS, TPOT_BUCKETS, TTFT_BUCKETS,
                                 MetricsRegistry)
from ...profiler.tracing import TID_GATEWAY, SpanTracer
from ..faults import TransientFault

#: engine ``stats`` counters whose /metrics series must stay monotonic
#: across crash-recovery rebuilds: a rebuilt engine starts its stats at
#: zero, so the gateway carries each dead incarnation's final count as a
#: base and every scrape reads base + live. Only true counters belong
#: here — gauges (headroom, last_step_*) must NOT be summed across
#: engines.
CARRIED_ENGINE_STATS = (
    "preemptions", "policy_preemptions", "prefill_copy_dispatches",
    "prefill_chunks", "prefill_tokens_saved", "spec_proposed",
    "spec_accepted", "spec_tokens", "decode_calls", "tokens_generated",
    "mtick_syncs", "mtick_ticks")

#: the same carry for the prefix cache's own stats (a rebuild builds a
#: fresh trie — and a fresh host tier — zeroing them)
CARRIED_PREFIX_STATS = ("hits", "misses", "evictions",
                        "spilled_blocks", "tier_hits",
                        "readmitted_blocks", "tier_evictions",
                        "tier_transfers")


class QueueFullError(RuntimeError):
    """Waiting room at capacity — shed load (HTTP 429)."""


class TraceBusyError(RuntimeError):
    """A step-bounded trace capture is already in progress (HTTP 409) —
    captures serialize so two debuggers cannot clear each other's
    buffer mid-window."""


class GatewayClosedError(RuntimeError):
    """Gateway is draining or stopped — no new work (HTTP 503)."""


class WatchdogTimeout(RuntimeError):
    """An engine step overran the supervisor's watchdog deadline —
    classified "hung" and recovered like a fatal fault. (A step that
    never returns at all cannot be preempted from inside its own
    thread; it is visible externally through ``/healthz``'s
    ``last_step_age_s`` and the watchdog gauge, for an orchestrator's
    liveness probe to act on.)"""


class TokenStream:
    """Live handle for one submitted request.

    Iterating yields generated token ids as the engine produces them and
    stops when the sequence finishes; ``finish_reason`` is set by then.
    ``result()`` drains to completion and returns
    ``(ids, finish_reason)``. Both are safe from any single consumer
    thread; ``cancel()`` is safe from any thread.
    """

    def __init__(self, gateway, request, stream_id):
        self.gateway = gateway
        self.request = request
        self.id = stream_id
        self.finish_reason = None
        self.seq = None            # set by the driver at engine-submit
        self.submit_time = time.monotonic()
        self.first_token_time = None
        self.finish_time = None
        self._events = queue.SimpleQueue()  # ("token", id) | ("finish", r) | ("error", msg)
        self._collected = []
        self._cancel = False
        self._waiting = True       # still counted against max_queue
        self._drained = False      # consumer saw the finish event

    # ------------------------------------------------------- consumer side
    def __iter__(self):
        # event-driven on purpose: the driver sets finish_reason BEFORE
        # queueing the finish event, so gating on finish_reason here
        # would drop still-queued tokens of a finished stream
        while not self._drained:
            kind, payload = self._events.get()
            if kind == "token":
                self._collected.append(payload)
                yield payload
            elif kind == "finish":
                self._drained = True
            else:
                self._drained = True
                raise RuntimeError(payload)

    def result(self):
        """Block until the sequence finishes; return
        ``(np.int32 ids, finish_reason)``."""
        for _ in self:
            pass
        return np.asarray(self._collected, np.int32), self.finish_reason

    def tokens(self):
        """Tokens consumed so far (complete after ``result()`` /
        exhausting the iterator)."""
        return list(self._collected)

    @property
    def done(self):
        """Finished engine-side (tokens may still await consumption)."""
        return self.finish_reason is not None

    def cancel(self):
        """Request cancellation (idempotent, any thread). The driver
        applies it between engine steps."""
        self._cancel = True
        self.gateway._wake.set()

    # --------------------------------------------------------- driver side
    def _push_token(self, token):
        self._events.put(("token", int(token)))

    def _push_finish(self, reason):
        self.finish_time = time.monotonic()
        self.finish_reason = reason
        self._events.put(("finish", reason))

    def _push_error(self, msg):
        self.finish_time = time.monotonic()
        self.finish_reason = "error"
        self._events.put(("error", str(msg)))


class _RateWindow:
    """Sliding-window event rate (the tokens/s gauge): O(1) record via a
    deque of (second-bucket, count) pairs, pruned at read time."""

    def __init__(self, window_s=10.0):
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._buckets = collections.deque()  # (int second, count)

    def record(self, n=1):
        sec = int(time.monotonic())
        with self._lock:
            if self._buckets and self._buckets[-1][0] == sec:
                self._buckets[-1][1] += n
            else:
                self._buckets.append([sec, n])

    def rate(self):
        now = time.monotonic()
        horizon = now - self.window_s
        with self._lock:
            while self._buckets and self._buckets[0][0] < horizon:
                self._buckets.popleft()
            total = sum(c for _, c in self._buckets)
        return total / self.window_s


class ServingGateway:
    """Thread-safe front door + engine-driver thread.

    ``max_queue`` bounds the waiting room: requests submitted but not
    yet decoding (gateway intake + engine scheduler queue). Running
    sequences never count — capacity there is ``num_slots``.
    """

    def __init__(self, engine, max_queue=64, idle_wait_s=0.02,
                 registry=None, start=True, engine_factory=None,
                 watchdog_deadline_s=None, max_transient_retries=3,
                 retry_backoff_s=0.02, max_restarts=8,
                 transient_types=(TransientFault,), clock=None,
                 fault_hook=None, tracer=None, trace=False,
                 trace_buffer=65536, cost=True, on_fatal=None,
                 stream_id_prefix="cmpl"):
        self.engine = engine
        self.max_queue = int(max_queue)
        self.idle_wait_s = float(idle_wait_s)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._intake = collections.deque()   # TokenStreams pre engine-submit
        self._live = {}                      # seq.request_id -> TokenStream
        self._backlog = 0                    # waiting-room occupancy
        self._closed = False
        self._drain = True
        self._ids = itertools.count(1)
        # stream-id namespace: the fleet gives each replica's gateway its
        # own prefix so ids stay unique across the fleet
        self._id_prefix = str(stream_id_prefix)
        # ----------------------------------------------- supervision state
        # engine_factory() -> a fresh engine with the SAME config and the
        # SAME shared jit_cache (so recovery never re-traces); None
        # disables crash recovery (a fatal fault strands, pre-PR-7 style)
        self.engine_factory = engine_factory
        self.watchdog_deadline_s = (None if not watchdog_deadline_s
                                    else float(watchdog_deadline_s))
        self.max_transient_retries = int(max_transient_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_restarts = int(max_restarts)
        self.transient_types = tuple(transient_types)
        self._clock = clock if clock is not None else time.monotonic
        self._fault_hook = fault_hook        # re-installed on every rebuild
        self._transient_streak = 0
        self._restarts = 0
        self.last_restart_at = None          # clock() of the last rebuild
        # fleet failover hook: called (gateway, [(stream, seq|None)]) on
        # the dying driver thread when supervision is exhausted, BEFORE
        # the streams are stranded; True (or the adopted streams) means
        # the fleet re-admitted them on a sibling, and those get no error
        self.on_fatal = on_fatal
        # dead engine incarnations' summed counter stats (see
        # CARRIED_ENGINE_STATS): every /metrics series derived from
        # engine (or prefix-cache) stats reads through _stat() /
        # _pc_stat(), so a crash-recovery rebuild can never scrape as a
        # counter going backwards. The (base, pc_base, engine) triple
        # swaps in ONE attribute store: a scrape mid-rebuild must never
        # pair the new base with the old engine's stats (double count,
        # then a backwards step).
        self._counter_state = (dict.fromkeys(CARRIED_ENGINE_STATS, 0),
                               dict.fromkeys(CARRIED_PREFIX_STATS, 0),
                               engine)
        # live migration: adopt() enqueues (stream, seq) pairs arriving
        # from a sibling (seq None: never engine-admitted, submit fresh);
        # request_migration() enqueues (stream, handoff) pairs leaving for
        # one. The driver drains both between steps: restore and evict
        # run only on its thread.
        self._migrate_in = collections.deque()
        self._migrate_out = collections.deque()
        self._last_step_done = self._clock()
        self._recovering = False
        self._fault_at = None                # clock() of the fault being
        self.restart_latencies = []          # recovered; -> latency sample
        # poison-quarantine / bisection state (module docstring):
        self._probation = set()   # ids readmitted by the last recovery
        self._suspect_ids = None  # active bisection half (None = off)
        self._parked = []         # Sequences held out of the engine
        # ------------------------------------------------ tracing state
        # (README "Tracing & debugging") the gateway OWNS the tracer so
        # one timeline survives engine rebuilds; it is installed on
        # every engine incarnation. trace=True records from startup
        # (the --trace flag); otherwise the tracer sits disabled —
        # zero-cost — until /debug/trace?steps=N opens a capture
        # window via capture_trace().
        self.tracer = tracer if tracer is not None else \
            SpanTracer(capacity=trace_buffer, clock=self._clock)
        #: public: whether tracing records continuously (``--trace``) —
        #: the HTTP layer keys its /debug/trace default on it (a
        #: parameterless GET must SNAPSHOT a persistent buffer, never
        #: clear hours of history)
        self.trace_persistent = bool(trace)
        if self.trace_persistent:
            self.tracer.enable()
        self._capture = None        # {"remaining": n, "done": Event}
        # ---------------------------------------------- cost observatory
        # (README "Cost attribution & /debug/profile") gateway-owned
        # like the tracer, so dispatch/transfer/compile accounting is
        # monotonic across engine rebuilds; ON by default (host-side
        # dict updates, a handful per step) — ``cost=False`` reduces
        # every engine cost site to the one _co() attribute check.
        self.cost = CostObservatory(clock=self._clock) if cost else None
        self._pcapture = None       # /debug/profile capture window
        engine.tracer = self.tracer
        engine.cost = self.cost
        engine.on_token = self._on_token
        engine.on_finish = self._on_finish
        engine.on_policy_preempt = self._on_policy_preempt
        if fault_hook is not None:
            engine.fault_hook = fault_hook
        self._init_metrics(registry)
        self._thread = threading.Thread(target=self._run,
                                        name="engine-driver", daemon=True)
        # a daemon driver killed mid-launch at interpreter teardown can
        # abort the process — stop it via atexit instead. weakref so the
        # hook never keeps a dropped gateway alive.
        ref = weakref.ref(self)
        self._atexit_hook = lambda: (lambda gw: gw and gw.shutdown(
            drain=False, timeout=10))(ref())
        atexit.register(self._atexit_hook)
        if start:
            self.start()

    def start(self):
        """Start the engine-driver thread (for gateways built with
        ``start=False`` — tests and benches submit their whole workload
        first so a fault plan's step indices are deterministic relative
        to the traffic). Idempotent once running; returns self."""
        if not self._thread.is_alive():
            self._thread.start()
        return self

    # ------------------------------------------------------------- helpers
    def _tr(self):
        """The tracer when recording, else None — the gateway's guard
        for its own instrumentation sites (the engine's ``_tr()``
        discipline; the guard-discipline static test pins that every
        recording site in ``serving/`` routes through one of these)."""
        t = self.tracer
        return t if t.enabled else None

    @property
    def _stat_base(self) -> dict:
        """Dead incarnations' summed engine-stat counters."""
        return self._counter_state[0]

    def _stat(self, key) -> int:
        """A monotonic engine-stat counter: dead incarnations' carried
        base + the live engine's count (CARRIED_ENGINE_STATS). Reads
        base and engine from ONE snapshot so a mid-rebuild scrape
        cannot mix epochs."""
        base, _, eng = self._counter_state
        return base[key] + eng.stats[key]

    def _pc_stat(self, key) -> int:
        """The same carry for prefix-cache stats (zero with no trie)."""
        _, pc_base, eng = self._counter_state
        pc = eng.prefix_cache
        return pc_base[key] + (pc.stats[key] if pc is not None else 0)

    def _class_labels(self, seq) -> dict:
        """Label kwargs for one sequence's latency observations: the
        ``class`` label with a multi-class table active, {} otherwise (a
        policy-off gateway's histograms keep their empty label sets)."""
        if self._m_slo_miss is None:
            return {}
        pclass = getattr(seq, "pclass", None)
        return {"class": pclass.name} if pclass is not None else {}

    # ------------------------------------------------------------- metrics
    def _init_metrics(self, registry):
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        r = self.registry
        self._m_requests = r.counter(
            "serving_requests_total", "Requests accepted by the gateway.")
        self._m_rejected = r.counter(
            "serving_rejected_total",
            "Requests shed by admission control (queue full).")
        self._m_finished = r.counter(
            "serving_finished_total",
            "Finished sequences by finish_reason.")
        self._m_tokens = r.counter(
            "serving_generated_tokens_total", "Generated tokens.")
        self._m_ttft = r.histogram(
            "serving_ttft_seconds", "Submit-to-first-token latency.",
            buckets=TTFT_BUCKETS)
        self._m_latency = r.histogram(
            "serving_request_latency_seconds",
            "Submit-to-finish latency per request.")
        # SLO substrate (ROADMAP multi-tenant item b): per-request
        # latency decomposition the TTFT/TPOT-target scheduler will
        # consume. Both are gateway-owned and read the Sequence's
        # engine-clock stamps at retirement, so they survive engine
        # rebuilds and keep accumulating across restarts.
        self._m_tpot = r.histogram(
            "serving_tpot_seconds",
            "Per-request time-per-output-token: (finish - first token)"
            " / (tokens - 1), the steady-state decode cadence one "
            "request observed (engine clock; requests with a single "
            "token have no inter-token gap and are not observed).",
            buckets=TPOT_BUCKETS)
        self._m_queue_wait = r.histogram(
            "serving_queue_wait_seconds",
            "Per-request submit-to-slot-claim wait (engine clock) — "
            "the admission-control half of TTFT. Never-admitted "
            "requests (queued timeout/cancel) are not observed.",
            buckets=QUEUE_WAIT_BUCKETS)
        self._rate = _RateWindow()
        r.gauge("serving_queue_depth",
                "Requests waiting for a slot (intake + scheduler queue)."
                ).set_fn(lambda: self._backlog)
        r.gauge("serving_active_slots",
                "KV slots currently decoding.").set_fn(
            lambda: self.engine.num_active)
        r.gauge("serving_num_slots", "KV slot capacity.").set(
            self.engine.num_slots)
        r.gauge("serving_tokens_per_second",
                "Generated tokens/s over a 10s sliding window.").set_fn(
            self._rate.rate)
        r.gauge("serving_decode_compilations",
                "Decode-program traces (compile-once contract: stays at "
                "one per (num_slots, max_seq_len, n_steps)).").set_fn(
            self.engine.decode_compilations)
        r.counter("serving_prefill_copy_dispatches_total",
                  "Block copy-in dispatches spent installing prefix "
                  "hits (dense engine only; the paged path pins this "
                  "at 0 — hits install by reference). Monotonic "
                  "across engine rebuilds.").set_fn(
            lambda: self._stat("prefill_copy_dispatches"))
        r.counter("serving_prefill_chunks_total",
                  "Chunked-prefill device chunks run (one per sequence "
                  "per step while a long cold prompt is interleaved "
                  "with decode; 0 with chunking off or on the dense "
                  "engine). Monotonic across engine rebuilds.").set_fn(
            lambda: self._stat("prefill_chunks"))
        # per-step telemetry: the SAME duration/token measurements the
        # engine's headroom EWMAs (adaptive chunk budget) read — the
        # driver observes them after every step() it pumps
        self._m_step_dur = r.histogram(
            "serving_step_duration_seconds",
            "Engine step() wall duration (admission + prefill grant + "
            "decode + retire).", buckets=STEP_BUCKETS)
        r.gauge("serving_step_tokens",
                "Tokens the last engine step processed on device "
                "(decode rows x fused ticks + prefill chunk tokens)."
                ).set_fn(lambda: self.engine.stats["last_step_tokens"])
        r.gauge("serving_prefill_headroom_tokens",
                "Current headroom-adaptive chunk-token grant per step "
                "(prefill_chunk is the cap; fixed at it until the "
                "EWMAs have signal or with adaptivity off).").set_fn(
            lambda: self.engine.stats["headroom"])
        # multi-tick decode surface (README "Multi-tick decode"):
        # mean on-device decode ticks per host sync — 1.0 means the
        # host is back in the loop every token, decode_ticks means the
        # fast path is fully engaged. Counters ride the _stat() carry,
        # so a rebuild never dents the ratio.
        r.gauge("serving_decode_ticks_per_sync",
                "Mean fused on-device decode ticks per host sync on "
                "the multi-tick engine (decode_ticks=1 engines and "
                "engines that never decoded scrape 0).").set_fn(
            lambda: (self._stat("mtick_ticks")
                     / max(self._stat("mtick_syncs"), 1)))
        # speculative-decode surface: registered only on a speculative
        # engine, read THROUGH self.engine so a rebuild re-binds them;
        # the counters ride the _stat() carry
        self._m_spec_len = None
        if getattr(self.engine, "spec_decode", False):
            r.counter("serving_spec_proposed_total",
                      "Draft tokens submitted to verification. "
                      "Monotonic across engine rebuilds."
                      ).set_fn(lambda: self._stat("spec_proposed"))
            r.counter("serving_spec_accepted_total",
                      "Draft tokens accepted (emitted without their own "
                      "decode launch) — the speculation win. Monotonic "
                      "across engine rebuilds.").set_fn(
                lambda: self._stat("spec_accepted"))
            self._m_spec_len = r.histogram(
                "serving_spec_accept_length",
                "Tokens emitted per verify span (1 = nothing accepted, "
                "spec_k + 1 = full draft accepted).",
                buckets=SPEC_ACCEPT_BUCKETS)
            # decode_calls, not spec_steps: chunk-only launches carry no
            # verify rows and would inflate a ratio over decode work
            r.gauge("serving_spec_launches_per_accepted_token",
                    "Decode launches per emitted token under "
                    "speculation (1.0 = no speedup; ~1 / mean "
                    "acceptance length).").set_fn(
                lambda: (self._stat("decode_calls")
                         / max(self._stat("spec_tokens"), 1)))
        # fault-tolerance surface (README "Fault tolerance & chaos
        # testing"). Gateway-owned counters, NOT engine-stat-backed:
        # engine stats die with a rebuilt engine, and a restart must
        # never scrape as a counter reset.
        self._m_faults = r.counter(
            "serving_faults_total",
            "Engine step faults observed by the supervisor, by class "
            "(kind = transient|fatal|hung).")
        self._m_restarts = r.counter(
            "serving_engine_restarts_total",
            "Engine rebuilds after a fatal/hung step fault (recovery-"
            "by-recompute; the jit cache is shared, so a restart "
            "re-traces nothing).")
        self._m_recovered = r.counter(
            "serving_recovered_requests_total",
            "Live requests re-enqueued for recompute after an engine "
            "rebuild (each readmission counts, including bisection "
            "re-entries).")
        # zero-seed the label-free incremented counters so every
        # gateway's series exists from the first scrape — a gateway
        # that never restarted must scrape as an explicit 0, not an
        # absent series
        for m in (self._m_requests, self._m_rejected, self._m_tokens,
                  self._m_restarts, self._m_recovered):
            m.inc(0)
        r.counter("serving_preemptions_total",
                  "Sequences preempted by recompute under KV pool "
                  "pressure (PoolExhausted: chain donated to the trie, "
                  "request re-queued). Monotonic across engine rebuilds."
                  ).set_fn(lambda: self._stat("preemptions"))
        # multi-tenant SLO surface: registered only when the engine's
        # class table is ACTIVE, so a policy-off gateway's document (and
        # the empty label sets of the latency histograms) stays as it
        # was. Both counters are gateway-owned, monotonic across
        # rebuilds, and zero-seeded per known class
        self._m_slo_miss = None
        self._m_policy_preempt = None
        if self.engine.classes.active:
            self._m_slo_miss = r.counter(
                "serving_slo_misses_total",
                "Finished first-tokens/requests that exceeded their "
                "priority class's SLO target, by class and slo "
                "(ttft|tpot). Classes without a target never miss.")
            self._m_policy_preempt = r.counter(
                "serving_policy_preemptions_total",
                "Sequences displaced by SLO-driven policy preemption "
                "(an urgent higher-class request claimed the slot), "
                "by the victim's class. Streams continue unchanged "
                "after restore.")
            for c in self.engine.classes:
                self._m_policy_preempt.inc(0, victim_class=c.name)
                for slo in ("ttft", "tpot"):
                    self._m_slo_miss.inc(0, **{"class": c.name,
                                               "slo": slo})
        r.gauge("serving_watchdog_last_step_age_seconds",
                "Seconds since the last completed engine step (the "
                "supervisor's hung-step signal; an orchestrator's "
                "external liveness probe for a step that never "
                "returns).").set_fn(self.last_step_age)
        # paged/prefix gauges read THROUGH self.engine at scrape time:
        # a recovery rebuild swaps the engine (and its cache/pool/trie)
        # underneath the registry, and the gauges must follow it rather
        # than keep reporting a dead engine's bookkeeping
        if getattr(self.engine, "_paged", False) \
                and getattr(self.engine, "cache", None) is not None:
            # paged-attention surface: physical sharing + table pressure
            # (scrape-time reads of host bookkeeping; driver is the only
            # writer, a scrape reads ints under the GIL)
            r.gauge("kv_blocks_shared",
                    "Pool blocks physically shared by concurrent "
                    "readers (refcount >= 2) — the zero-copy win."
                    ).set_fn(lambda: self.engine.cache.pool.num_shared)
            r.gauge("kv_block_table_fill",
                    "Fraction of the [num_slots, max_blocks] block "
                    "table grid populated by live sequences."
                    ).set_fn(lambda: self.engine.cache.table_fill())
            # quantized-serving surface (README "Quantized serving"):
            # pool HBM in BYTES, dtype-aware via
            # PagedKVCache.occupancy_bytes() — an int8 pool reports
            # int8 data bytes under kind="kv" plus its fp32 scale
            # planes under kind="scales" (0 on the default pool), and
            # the per-cached-token marginal HBM cost the density bench
            # banks against. Allocated (live + trie) blocks x
            # per-block bytes.
            kvb = r.gauge(
                "kv_pool_bytes",
                "Allocated KV pool HBM bytes by storage kind (kv = "
                "block data at the pool dtype, scales = the int8 "
                "pool's fp32 scale planes; 0 when unquantized).")
            # each kind scans the block tables once (used_blocks);
            # per-token is pure constants — a scrape pays two cheap
            # scans total, never three occupancy_bytes() walks
            kvb.set_fn(
                lambda: (self.engine.cache.used_blocks()
                         * self.engine.cache.pool.block_nbytes),
                kind="kv")
            kvb.set_fn(
                lambda: (self.engine.cache.used_blocks()
                         * self.engine.cache.pool.scale_block_nbytes),
                kind="scales")
            r.gauge("serving_kv_bytes_per_token",
                    "Marginal HBM bytes one cached token costs (block "
                    "bytes incl. scale planes / block_size) — the "
                    "denominator of the quantized-density win."
                    ).set_fn(
                lambda: self.engine.cache.bytes_per_token())
        if getattr(self.engine, "prefix_cache", None) is not None:
            # scrape-time counters backed by the trie's own stats plus
            # the carried base: a rebuild starts a fresh trie, the base
            # keeps the series monotonic across it
            r.counter("serving_prefix_cache_hits_total",
                      "Admissions that matched a cached prefix chain. "
                      "Monotonic across engine rebuilds.").set_fn(
                lambda: self._pc_stat("hits"))
            r.counter("serving_prefix_cache_misses_total",
                      "Admissions with no cached prefix. Monotonic "
                      "across engine rebuilds.").set_fn(
                lambda: self._pc_stat("misses"))
            r.counter("serving_prefix_cache_evictions_total",
                      "Cached blocks evicted under pool pressure. "
                      "Monotonic across engine rebuilds.").set_fn(
                lambda: self._pc_stat("evictions"))
            r.counter("serving_prefill_tokens_saved_total",
                      "Prompt tokens served from cached KV blocks "
                      "instead of device prefill. Monotonic across "
                      "engine rebuilds.").set_fn(
                lambda: self._stat("prefill_tokens_saved"))
            r.gauge("kv_prefix_blocks",
                    "Prefix-cache pool blocks in use (published + "
                    "pinned).").set_fn(
                lambda: self.engine.prefix_cache.pool.num_used)
            r.gauge("kv_prefix_blocks_capacity",
                    "Prefix-cache pool size in blocks.").set_fn(
                lambda: self.engine.prefix_cache.pool.num_blocks)
            r.gauge("serving_prefix_cached_blocks",
                    "Trie-resident cached blocks (live nodes).").set_fn(
                lambda: self.engine.prefix_cache.num_cached_blocks)
            # the host-RAM spill tier: counters registered whether or not
            # a tier exists (a tierless engine scrapes zeros)
            for name, stat, doc in (
                    ("serving_prefix_spilled_blocks_total",
                     "spilled_blocks",
                     "Evicted trie blocks spilled device->host into the "
                     "tier instead of deleted."),
                    ("serving_prefix_tier_hits_total", "tier_hits",
                     "Recording lookups that readmitted at least one "
                     "spilled block from the host tier."),
                    ("serving_prefix_readmitted_blocks_total",
                     "readmitted_blocks",
                     "Spilled blocks streamed back host->device."),
                    ("serving_prefix_tier_evictions_total",
                     "tier_evictions",
                     "Tier entries dropped by the host-side LRU."),
                    ("serving_prefix_tier_transfers_total",
                     "tier_transfers",
                     "Spilled chains admitted host-to-host from a "
                     "sibling replica's tier.")):
                r.counter(name, doc + " Monotonic across engine "
                          "rebuilds.").set_fn(
                    (lambda k: lambda: self._pc_stat(k))(stat))
            r.gauge("serving_prefix_tier_blocks",
                    "Blocks resident in the host-RAM spill tier."
                    ).set_fn(
                lambda: (self.engine.prefix_cache.tier.num_blocks
                         if self.engine.prefix_cache.tier is not None
                         else 0))
            r.gauge("serving_prefix_tier_bytes",
                    "Host bytes the spill tier currently holds."
                    ).set_fn(
                lambda: (self.engine.prefix_cache.tier.bytes_used
                         if self.engine.prefix_cache.tier is not None
                         else 0))
            r.gauge("serving_prefix_tier_bytes_capacity",
                    "The host_tier_bytes budget (0 = tier off)."
                    ).set_fn(
                lambda: self.engine.prefix_cache.host_tier_bytes)
        # device-boundary cost surface (README "Cost attribution &
        # /debug/profile"): observatory-owned, so every series is
        # monotonic across engine rebuilds by construction. One series
        # per program kind is registered up front — unused kinds scrape
        # as 0 rather than appearing mid-flight.
        if self.cost is not None:
            co = self.cost
            disp = r.counter(
                "serving_dispatches_total",
                "Device program launches by program kind — the exact "
                "host->device dispatch count the mega-kernel work is "
                "measured against. Monotonic across engine rebuilds.")
            for kind in PROGRAM_KINDS:
                disp.set_fn((lambda k: lambda: co.kind_calls(k))(kind),
                            program=kind)
            xfer = r.counter(
                "serving_transfer_bytes_total",
                "Host<->device boundary bytes from abstract shapes "
                "(h2d: host-resident argument leaves uploaded at "
                "dispatch; d2h: result leaves the engine fetches to "
                "host). No device sync; monotonic across rebuilds.")
            xfer.set_fn(lambda: co.totals["h2d_bytes"], direction="h2d")
            xfer.set_fn(lambda: co.totals["d2h_bytes"], direction="d2h")
            # the tensor-parallel and KV-tier byte series, registered up
            # front so tp=1 and tierless engines scrape explicit zeros
            coll = r.counter(
                "serving_collective_bytes_total",
                "Tensor-parallel all-reduce wire bytes per device by "
                "collective dtype (exact, from shapes; the engine's "
                "ledger). 0 on tp=1 engines. Monotonic across engine "
                "rebuilds.")
            for cdt in ("fp", "int8"):
                coll.set_fn((lambda d: lambda: co.collective_bytes(d))(cdt),
                            dtype=cdt)
            tier = r.counter(
                "serving_tier_bytes_total",
                "KV prefix-tier bytes moved by direction (d2h: spill, "
                "h2d: readmission, peer: fleet transfer in), a ledger "
                "apart from serving_transfer_bytes_total. 0 without a "
                "host tier. Monotonic across engine rebuilds.")
            for tdir in ("d2h", "h2d", "peer"):
                tier.set_fn((lambda d: lambda: co.tier_bytes(d))(tdir),
                            direction=tdir)
            r.counter("serving_program_compiles_total",
                      "Program compile (trace) events observed at the "
                      "jit-cache chokepoint — stays flat once warm "
                      "(the compile-once contract, including across "
                      "rebuilds).").set_fn(
                lambda: co.totals["compiles"])
            r.gauge("serving_dispatches_per_decoded_token",
                    "Serving program calls per generated token (all "
                    "program kinds / all tokens since start)."
                    ).set_fn(
                lambda: (co.totals["dispatches"]
                         / max(self._stat("tokens_generated"), 1)))

    # ---------------------------------------------------------- front door
    def submit(self, request) -> TokenStream:
        """Enqueue from any thread. Raises ValueError/TypeError on a bad
        request, QueueFullError past ``max_queue``, GatewayClosedError
        after shutdown began."""
        # validate on the caller's thread: a bad request must 400 here,
        # not poison the driver loop later
        self.engine.validate(request)
        with self._lock:
            if self._closed:
                raise GatewayClosedError("gateway is draining")
            if self._backlog >= self.max_queue:
                self._m_rejected.inc()
                raise QueueFullError(
                    f"waiting room full ({self.max_queue} requests)")
            self._backlog += 1
            stream = TokenStream(self, request,
                                 f"{self._id_prefix}-{next(self._ids)}")
            self._intake.append(stream)
        self._m_requests.inc()
        self._wake.set()
        return stream

    def adopt(self, stream, seq=None):
        """Take over a live request from a sibling gateway (fleet
        failover, live migration). Thread-safe: enqueues the pair; the
        driver re-admits it between steps — ``seq`` (the sibling's
        evicted or crash-snapshotted sequence, PRNG walk included) through
        ``engine.restore``, so its stream continues byte-identically;
        ``seq=None`` (never engine-admitted there) submits fresh. The
        stream is re-pointed at THIS gateway, so cancellation and token
        delivery follow it."""
        with self._lock:
            if self._closed:
                raise GatewayClosedError("gateway is draining")
            stream.gateway = self
            if stream._waiting:
                # the waiting-room seat moves with the stream (the source
                # gave up its own at handoff)
                self._backlog += 1
            self._migrate_in.append((stream, seq))
        self._wake.set()

    def request_migration(self, stream, handoff):
        """Ask the driver to evict ``stream``'s sequence between steps and
        call ``handoff(stream, seq)`` on the driver thread once it is
        displaced (chain donated, PRNG snapshotted; ``seq`` None when the
        request never reached the engine). The fleet's handoff adopts the
        pair on a sibling. Thread-safe; a no-op for a stream that
        finishes first."""
        with self._lock:
            self._migrate_out.append((stream, handoff))
        self._wake.set()

    @property
    def queue_depth(self):
        return self._backlog

    @property
    def closed(self):
        return self._closed

    # ------------------------------------------------------- engine events
    def _leave_waiting_room(self, stream):
        if stream._waiting:
            stream._waiting = False
            with self._lock:
                self._backlog -= 1

    def _on_token(self, seq, token):
        stream = self._live.get(seq.request_id)
        self._m_tokens.inc()
        self._rate.record()
        if stream is None:
            return
        if stream.first_token_time is None:
            stream.first_token_time = time.monotonic()
            self._m_ttft.observe(stream.first_token_time
                                 - stream.submit_time,
                                 **self._class_labels(seq))
            self._leave_waiting_room(stream)
            # TTFT SLO verdict from the engine-clock stamp (not the wall
            # latency above): deterministic under an injected clock
            if self._m_slo_miss is not None:
                pclass = getattr(seq, "pclass", None)
                ttft = seq.ttft_s
                if (pclass is not None and pclass.ttft_slo_s is not None
                        and ttft is not None
                        and ttft > pclass.ttft_slo_s):
                    self._m_slo_miss.inc(**{"class": pclass.name,
                                            "slo": "ttft"})
        stream._push_token(token)

    def _finish_teardown(self, seq):
        """Bookkeeping shared by every terminal path — engine finishes
        (:meth:`_on_finish`) and the quarantine's poison conviction
        (:meth:`_fail_poisoned`) — so metrics and quarantine state
        cannot drift between them. Returns the stream (if any) still
        owed its terminal event."""
        stream = self._live.pop(seq.request_id, None)
        self._m_finished.inc(reason=seq.finish_reason)
        # SLO decomposition from the Sequence's engine-clock stamps
        # (None-guarded: a queued timeout was never admitted, a
        # one-token request has no TPOT)
        qw = seq.queue_wait_s
        if qw is not None:
            self._m_queue_wait.observe(qw, **self._class_labels(seq))
        tp = seq.tpot_s
        if tp is not None:
            self._m_tpot.observe(tp, **self._class_labels(seq))
            if self._m_slo_miss is not None:
                pclass = getattr(seq, "pclass", None)
                if (pclass is not None and pclass.tpot_slo_s is not None
                        and tp > pclass.tpot_slo_s):
                    self._m_slo_miss.inc(**{"class": pclass.name,
                                            "slo": "tpot"})
        # quarantine bookkeeping: any terminal outcome clears suspicion
        self._probation.discard(seq.request_id)
        if self._suspect_ids is not None:
            self._suspect_ids.discard(seq.request_id)
        if stream is None:
            return None
        self._leave_waiting_room(stream)  # finished while still queued
        self._m_latency.observe(time.monotonic() - stream.submit_time)
        return stream

    def _on_finish(self, seq):
        stream = self._finish_teardown(seq)
        if stream is not None:
            stream._push_finish(seq.finish_reason)

    def _on_policy_preempt(self, seq):
        """Engine hook: an SLO-urgent request displaced ``seq``. Counts
        by victim class on the gateway-owned counter (the engine's own
        ``policy_preemptions`` stat rides the carry beside it)."""
        if self._m_policy_preempt is not None:
            pclass = getattr(seq, "pclass", None)
            self._m_policy_preempt.inc(
                victim_class=pclass.name if pclass is not None
                else "unknown")

    # ------------------------------------------------------- driver thread
    def _admit_intake(self):
        while True:
            with self._lock:
                if not self._intake:
                    return
                stream = self._intake.popleft()
            if stream._cancel:
                self._leave_waiting_room(stream)
                self._m_finished.inc(reason="cancelled")
                stream._push_finish("cancelled")
                continue
            try:
                seq = self.engine.submit(stream.request)
            except Exception as e:  # validated at submit(); belt+braces
                self._leave_waiting_room(stream)
                stream._push_error(e)
                continue
            stream.seq = seq
            self._live[seq.request_id] = stream

    def _admit_migrations(self):
        """Driver-side intake of requests adopted from a sibling: a
        carried sequence re-enters by ``engine.restore`` (recompute from
        host token state and the PRNG snapshot), a bare request submits
        fresh. A cancellation that raced the migration is honoured here,
        as on the intake path."""
        while True:
            with self._lock:
                if not self._migrate_in:
                    return
                stream, seq = self._migrate_in.popleft()
            if stream._cancel:
                if seq is not None and not seq.done:
                    seq.status = "finished"
                    seq.finish_reason = "cancelled"
                self._leave_waiting_room(stream)
                self._m_finished.inc(reason="cancelled")
                stream._push_finish("cancelled")
                continue
            if seq is None:
                try:
                    seq = self.engine.submit(stream.request)
                except Exception as e:
                    self._leave_waiting_room(stream)
                    stream._push_error(e)
                    continue
            elif seq.done:
                # finished between gateways (eviction hands off only live
                # sequences): a terminal event beats a stranded consumer
                self._leave_waiting_room(stream)
                self._m_finished.inc(reason=seq.finish_reason)
                stream._push_finish(seq.finish_reason)
                continue
            elif (seq.prompt_len + int(seq.request.max_new_tokens)
                    > self.engine.max_seq_len):
                # behind the fleet's can_hold selection: an adoption this
                # engine cannot hold to completion ends cleanly, never
                # crashes the driver mid-recompute (a fatal fault that
                # would cascade a fresh failover of the same sequence)
                self._leave_waiting_room(stream)
                stream._push_error(
                    f"migrated sequence needs "
                    f"{seq.prompt_len + int(seq.request.max_new_tokens)}"
                    f" KV rows; this engine holds "
                    f"{self.engine.max_seq_len}")
                continue
            elif self.engine.restore(seq):
                self._m_recovered.inc()
            stream.seq = seq
            self._live[seq.request_id] = stream

    def _apply_migrate_out(self):
        """Driver-side eviction for live migration: displace each
        requested stream's sequence (``engine.evict``: chain donated,
        PRNG snapshotted) and hand the pair to the fleet's ``handoff`` on
        this thread. A refused handoff (no sibling can take it) restores
        the sequence here: a migration may be refused, never lose a
        request."""
        while True:
            with self._lock:
                if not self._migrate_out:
                    return
                stream, handoff = self._migrate_out.popleft()
            seq = stream.seq
            if seq is None:
                # still in this gateway's intake: hand the bare request
                with self._lock:
                    try:
                        self._intake.remove(stream)
                    except ValueError:
                        continue        # finished, cancelled or raced away
                    if stream._waiting:
                        self._backlog -= 1
                try:
                    handoff(stream, None)
                except Exception:
                    with self._lock:
                        if stream._waiting:
                            self._backlog += 1
                        self._intake.append(stream)
                continue
            if seq.done or self._live.get(seq.request_id) is not stream:
                continue                # finished, or already handed off
            if any(p is seq for p in self._parked) or (
                    self._suspect_ids
                    and seq.request_id in self._suspect_ids):
                continue                # mid-bisection: not migratable
            if not self.engine.evict(seq):
                continue
            del self._live[seq.request_id]
            self._probation.discard(seq.request_id)
            if stream._waiting:
                with self._lock:
                    self._backlog -= 1
            try:
                handoff(stream, seq)
            except Exception:
                # refused by the target: re-admit here by recompute
                if stream._waiting:
                    with self._lock:
                        self._backlog += 1
                if self.engine.restore(seq):
                    self._m_recovered.inc()
                    self._live[seq.request_id] = stream

    def _apply_cancels(self):
        for stream in [s for s in self._live.values() if s._cancel]:
            seq = stream.seq
            parked = next((p for p in self._parked if p is seq), None)
            if parked is not None:
                # bisection-parked: not in any engine, cancel by hand —
                # honoring cancellation DURING recovery is part of the
                # fault-tolerance contract
                self._parked.remove(seq)
                seq.status = "finished"
                seq.finish_reason = "cancelled"
                self._on_finish(seq)
                continue
            self.engine.cancel(seq)         # fires _on_finish

    def _sweep_parked_deadlines(self):
        """Bisection-parked sequences live outside the engine, so its
        per-step deadline sweep cannot see them — a parked request's
        ``timeout_s`` must still be honored here (deadlines share the
        engine's ``time.monotonic`` basis)."""
        if not self._parked:
            return
        now = time.monotonic()
        for seq in [p for p in self._parked
                    if p.deadline is not None and now >= p.deadline]:
            self._parked.remove(seq)
            seq.status = "finished"
            seq.finish_reason = "timeout"
            self._on_finish(seq)

    def _run(self):
        try:
            while True:
                self._arm_capture()
                self._admit_intake()
                self._admit_migrations()
                self._apply_cancels()
                self._sweep_parked_deadlines()
                self._advance_bisection()
                self._apply_migrate_out()
                if self.engine.has_work():
                    self._step_supervised()
                    continue
                with self._lock:
                    drained = (not self._intake and not self._live
                               and not self._parked
                               and not self._migrate_in)
                    if self._closed and drained:
                        return
                # idle is provably not hung: refresh the watchdog
                # timestamp so last_step_age_s / the gauge measure
                # time-stuck-in-a-step, not time-without-traffic (an
                # orchestrator must not kill a healthy idle server)
                self._last_step_done = self._clock()
                self._wake.wait(self.idle_wait_s)
                self._wake.clear()
        except BaseException as e:
            # supervision exhausted (max_restarts, no factory, or a
            # non-Exception). Fleet failover first: every live request,
            # snapshotted as a rebuild's recovery would, goes to the
            # on_fatal hook, which re-admits it on a sibling; only what
            # nobody adopted is stranded. The driver is the only thread
            # that can unblock consumers — it must not strand them
            # mid-result()
            handed = self._failover_handoff()
            with self._lock:
                self._closed = True
                stranded = (list(self._intake) + list(self._live.values())
                            + [st for st, _ in self._migrate_in])
                self._intake.clear()
                self._live.clear()
                self._parked.clear()
                self._migrate_in.clear()
            for s in stranded:
                if id(s) not in handed:
                    s._push_error(f"engine driver died: {e!r}")
            raise

    # ---------------------------------------------------------- supervisor
    def _step_supervised(self):
        """One engine step under supervision: classify any failure,
        retry transients with bounded backoff, rebuild + recover on
        fatal/hung, give up (re-raise, stranding with errors) only past
        ``max_restarts`` or without an ``engine_factory``."""
        t0 = self._clock()
        try:
            # a step that recorded a new program (the reference's rule for
            # one that traced a program) or built/loaded a kernel library
            # (nvcc at a kernel's first launch: seconds) is exempt from
            # the watchdog: a build is not a hang, and classifying it as
            # one would burn the restart budget on healthy cold starts
            traces0 = (self.engine.decode_compilations()
                       + self.engine.prefill_compilations())
            libs0 = _build.libraries_loaded()
            self.engine.step()
            dt = self._clock() - t0
            compiled = ((self.engine.decode_compilations()
                         + self.engine.prefill_compilations()) > traces0
                        or _build.libraries_loaded() > libs0)
            if self.watchdog_deadline_s is not None and not compiled \
                    and dt > self.watchdog_deadline_s:
                raise WatchdogTimeout(
                    f"engine step took {dt:.3f}s, watchdog deadline is "
                    f"{self.watchdog_deadline_s:.3f}s")
        except Exception as e:
            self._on_fault(e)
            return
        self._last_step_done = self._clock()
        self._transient_streak = 0
        self._tick_capture()
        if self._fault_at is not None:
            # first completed step on the rebuilt engine: recovery done
            self.restart_latencies.append(self._clock() - self._fault_at)
            self._fault_at = None
        self._m_step_dur.observe(self.engine.stats["last_step_duration_s"])
        if self._m_spec_len is not None:
            # drain the step's acceptance lengths into the histogram (the
            # driver thread is their only reader and writer)
            lens = self.engine.stats["spec_last_accept"]
            if lens:
                for m in lens:
                    self._m_spec_len.observe(m)
                self.engine.stats["spec_last_accept"] = []

    def _classify(self, exc) -> str:
        if isinstance(exc, WatchdogTimeout):
            return "hung"
        if isinstance(exc, self.transient_types):
            return "transient"
        return "fatal"

    def _on_fault(self, exc):
        kind = self._classify(exc)
        self._m_faults.inc(kind=kind)
        tr = self._tr()
        if tr is not None:
            tr.instant(
                "fault", tid=TID_GATEWAY,
                args={"kind": kind, "error": type(exc).__name__,
                      "message": str(exc)[:200]})
        if self._fault_at is None:
            self._fault_at = self._clock()
        if kind == "transient":
            self._transient_streak += 1
            if self._transient_streak <= self.max_transient_retries:
                # retry the SAME engine: injected transients fire at a
                # step boundary, so engine bookkeeping is intact; real
                # ones (a flaky transfer) are worth one cheap retry
                # before paying a rebuild
                time.sleep(self.retry_backoff_s * self._transient_streak)
                return
            self._transient_streak = 0      # escalate: streak is a wedge
        if self.engine_factory is None or self._restarts >= self.max_restarts:
            raise exc
        self._rebuild_and_recover()

    @staticmethod
    def _snapshot_live(engine):
        """The recovery snapshot: every live slot-holder (arrival order)
        with its PRNG-walk snapshot — per-slot current keys, held on the
        host, so sampled continuations restart mid-walk; recovery itself
        runs on host token state — plus the still-queued sequences.
        Returns ``(live, queued)``."""
        keys = np.asarray(engine._keys, np.int64)
        live = [s for s in engine._slots if s is not None and not s.done]
        live.sort(key=lambda s: s.request_id)   # arrival order
        for s in live:
            if keys is not None and s.tokens and s.status == "running" \
                    and s.slot is not None:
                s.key = keys[s.slot].copy()
        queued = [s for s in engine.scheduler.queue if not s.done]
        return live, queued

    def _failover_handoff(self) -> frozenset:
        """The dying driver's last act (failover to a sibling): snapshot
        every live request as a rebuild's recovery would and offer the
        (stream, sequence) pairs to ``on_fatal``. Returns the ids of the
        streams the hook adopted (all of them on True; empty without a
        hook, on refusal, or if the handoff fails — stranding is the
        fallback)."""
        if self.on_fatal is None:
            return frozenset()
        try:
            live, queued = self._snapshot_live(self.engine)
            seqs = live + queued + [p for p in self._parked if not p.done]
            pairs, seen = [], set()
            for seq in seqs:
                st = self._live.get(seq.request_id)
                if st is not None and st.finish_reason is None \
                        and not st._cancel:
                    pairs.append((st, seq))
                    seen.add(id(st))
            with self._lock:
                pending = [(st, None) for st in self._intake] \
                    + list(self._migrate_in)
            for st, sq in pending:
                if id(st) not in seen and st.finish_reason is None \
                        and not st._cancel:
                    pairs.append((st, sq))
                    seen.add(id(st))
            if pairs:
                res = self.on_fatal(self, pairs)
                if res is True:
                    return frozenset(id(st) for st, _ in pairs)
                if res:     # the streams actually adopted
                    return frozenset(id(st) for st in res)
        except Exception:
            pass        # failover is best-effort; stranding still works
        return frozenset()

    def _rebuild_and_recover(self):
        """Fatal-fault recovery: rebuild the engine and re-enqueue every
        live request by recompute — modulo the poison quarantine, which
        decides who re-enters now, who parks, and (once isolated) who
        is failed as the culprit."""
        self._recovering = True
        tr = self._tr()
        tr0 = tr.now() if tr is not None else None
        old = self.engine
        # bank the dead incarnation's counter stats so every derived
        # /metrics series stays monotonic (CARRIED_ENGINE_STATS). Built
        # aside and swapped in below WITH the new engine — one store —
        # so concurrent scrapes never see base and engine from
        # different epochs.
        base, pc_base, _ = self._counter_state
        new_base = {k: base[k] + old.stats[k]
                    for k in CARRIED_ENGINE_STATS}
        live, queued = self._snapshot_live(old)
        # the dead engine's pool goes before the factory allocates the
        # next one: at 7B widths a pool is tens of GiB, and two of them
        # need not fit the card
        old.release()
        new = self.engine_factory()
        new.on_token = self._on_token
        new.on_finish = self._on_finish
        new.on_policy_preempt = self._on_policy_preempt
        new.tracer = self.tracer     # one timeline across incarnations
        new.cost = self.cost         # one cost account, monotonic too
        if self._fault_hook is not None:
            new.fault_hook = self._fault_hook
        new_pc = dict(pc_base)
        if old.prefix_cache is not None \
                and new.prefix_cache is not old.prefix_cache:
            # bank the dead trie's stats only when the factory built a
            # fresh one: a shared PrefixCache rides into the new engine
            # with its counts intact
            for k in CARRIED_PREFIX_STATS:
                new_pc[k] += old.prefix_cache.stats[k]
        self.engine = new
        self._counter_state = (new_base, new_pc, new)   # atomic swap
        self._restarts += 1
        self.last_restart_at = self._clock()
        self._m_restarts.inc()
        readmit, culprit = self._quarantine_plan(live)
        recovered = 0
        for s in readmit + queued:
            if new.restore(s):
                self._m_recovered.inc()
                recovered += 1
        self._probation = {s.request_id for s in readmit + queued}
        if tr is not None:
            tr.complete("rebuild", tr0, tid=TID_GATEWAY,
                        args={"restarts": self._restarts,
                              "live": len(live), "queued": len(queued)})
            tr.instant("recovery", tid=TID_GATEWAY,
                       args={"recovered": recovered,
                             "parked": len(self._parked)})
        if culprit is not None:
            self._fail_poisoned(culprit)
        self._recovering = False

    def _quarantine_plan(self, live):
        """Split the recovered slot-holders into (readmit-now, culprit).
        First fault: readmit everyone (they enter probation). A repeat
        fault while probation members are still live starts the
        bisection: suspects are the probation members present at the
        fault; half readmit as the active set, half park. Conviction
        requires RECURRENCE UNDER ACTIVE BISECTION — a fault that
        follows a single-member active set is the poison (fail it,
        unpark everyone) — so two coincidental independent faults can
        shrink an innocent request to sole-suspect, but it is only
        failed if the fault then follows it a further time; otherwise
        it finishes and is exonerated."""
        bisecting = self._suspect_ids is not None
        watched = self._suspect_ids if bisecting else self._probation
        suspects = [s for s in live if s.request_id in watched]
        bystanders = [s for s in live if s.request_id not in watched]
        if not suspects:
            # fault not attributable to any prior readmission (fresh
            # fault, or suspects all finished): plain recovery
            self._suspect_ids = None
            return live, None
        if bisecting and len(suspects) == 1:
            # the fault followed this request through the halvings and
            # recurred on it alone — it is the poison. Everyone parked
            # re-enters.
            culprit = suspects[0]
            readmit = bystanders + self._parked
            self._parked = []
            self._suspect_ids = None
            return readmit, culprit
        half = (len(suspects) + 1) // 2
        active, benched = suspects[:half], suspects[half:]
        self._parked.extend(benched)
        self._suspect_ids = {s.request_id for s in active}
        tr = self._tr()
        if tr is not None:
            tr.instant(
                "bisection", tid=TID_GATEWAY,
                args={"verdict": "halved", "active": len(active),
                      "parked": len(benched)})
        return bystanders + active, None

    def _advance_bisection(self):
        """Driver-loop bookkeeping between steps: when the active
        suspect half has fully drained without re-faulting, it is
        exonerated — the culprit (if any) hides among the parked, so
        half of them re-enter as the next suspects. With nothing parked
        left, the bisection ends (the fault did not recur: poison gone,
        or it was step-pinned rather than request-pinned)."""
        if self._suspect_ids:
            return                  # active half still live — wait
        if not self._parked:
            self._suspect_ids = None
            return
        half = (len(self._parked) + 1) // 2
        batch, self._parked = self._parked[:half], self._parked[half:]
        batch = [s for s in batch if not s.done]
        tr = self._tr()
        if batch and tr is not None:
            tr.instant(
                "bisection", tid=TID_GATEWAY,
                args={"verdict": "reenter", "reentered": len(batch),
                      "parked": len(self._parked)})
        for s in batch:
            if self.engine.restore(s):
                self._m_recovered.inc()
        ids = {s.request_id for s in batch}
        self._suspect_ids = ids if (ids or self._parked) else None
        self._probation |= ids

    def _fail_poisoned(self, seq):
        """Terminate the isolated culprit — the ONLY request a poison
        fault costs. Consumers see ``finish_reason="error"``: SSE gets
        a terminal error event, blocking a JSON 500."""
        seq.status = "finished"
        seq.finish_reason = "error"
        tr = self._tr()
        if tr is not None:
            tr.instant(
                "bisection", tid=TID_GATEWAY,
                args={"verdict": "poisoned",
                      "request_tid": tr.req_tid(seq.request_id)})
            tr.instant("finished", tid=tr.req_tid(seq.request_id),
                       args={"finish_reason": "error"})
        stream = self._finish_teardown(seq)
        if stream is not None:
            stream._push_error(
                "poisoned request: engine fault recurred pinned to this "
                "request; bystanders recovered")

    # ----------------------------------------------------- trace capture
    def _arm_capture(self):
        """Driver-side capture start: a pending window opens at a STEP
        BOUNDARY (top of the driver loop), never mid-step — so every
        step the countdown charges was recorded from its first event
        and the capture holds exactly the asked-for step spans. Arming
        runs under the gateway lock so it cannot race the handler's
        timeout cleanup — an orphaned window must never enable the
        tracer with nobody left to read or stop it."""
        if self._capture is None and self._pcapture is None:
            return                      # lock-free fast path
        with self._lock:
            cap = self._capture
            if cap is not None and not cap["armed"]:
                self.tracer.clear()
                self.tracer.enable()
                cap["armed"] = True
            pc = self._pcapture
            if pc is not None and not pc["armed"] \
                    and self.cost is not None:
                # profile window base: the accounting as of this step
                # boundary — the returned table is exactly the next
                # ``steps`` steps' worth of cost
                pc["base"] = self._profile_snapshot()
                pc["armed"] = True

    def _tick_capture(self):
        """Driver-side capture countdown: called after every completed
        supervised step. When the requested window closes, recording
        stops (unless tracing is persistent) so the capture holds
        exactly the asked-for steps, and the waiting handler wakes.
        Locked for the same reason as :meth:`_arm_capture`; the
        no-capture fast path stays one attribute check."""
        if self._capture is None and self._pcapture is None:
            return                      # lock-free fast path
        with self._lock:
            cap = self._capture
            if cap is not None and cap["armed"]:
                cap["remaining"] -= 1
                if cap["remaining"] <= 0:
                    if not self.trace_persistent:
                        self.tracer.disable()
                    cap["done"].set()
            pc = self._pcapture
            if pc is not None and pc["armed"]:
                pc["remaining"] -= 1
                if pc["remaining"] <= 0 and pc["end"] is None:
                    # freeze the window's END at this exact step
                    # boundary: the driver keeps stepping while the
                    # waiting handler wakes, and those later steps
                    # must not leak into the N-step document
                    pc["end"] = self._profile_snapshot()
                    pc["done"].set()

    def capture_trace(self, steps=32, timeout_s=30.0):
        """Capture ``steps`` engine steps of trace and return the
        Chrome trace document (the ``GET /debug/trace`` body).

        ``steps <= 0`` snapshots the current buffer without touching
        recording state — the natural read when tracing is persistent
        (``trace=True`` / ``--trace``). Otherwise the buffer is
        cleared, recording turns on, and the call blocks until the
        driver completes ``steps`` steps or ``timeout_s`` elapses (an
        idle engine steps nothing — the timeout returns whatever was
        captured, e.g. only gateway events). Captures serialize:
        a second concurrent capture raises :class:`TraceBusyError`.
        Safe from any thread; the driver's arming/countdown and this
        teardown all run under the gateway lock."""
        tr = self.tracer
        if steps <= 0:
            return tr.export()
        # clamp: Event.wait overflows on absurd timeouts, and a capture
        # that outlives any plausible debugging session is a leak
        timeout_s = min(max(float(timeout_s), 0.0), 3600.0)
        with self._lock:
            if self._capture is not None:
                raise TraceBusyError(
                    "a trace capture is already in progress")
            done = threading.Event()
            self._capture = {"remaining": int(steps), "done": done,
                             "armed": False}
        try:
            self._wake.set()
            done.wait(timeout_s)
        finally:
            # unconditional teardown: an exception here must not leave
            # an orphaned window 409-ing every later capture (or the
            # tracer recording with nobody left to stop it)
            with self._lock:
                cap, self._capture = self._capture, None
                if cap is not None and cap["armed"] \
                        and not self.trace_persistent:
                    tr.disable()
        return tr.export()

    # ------------------------------------------------------ cost profile
    def _profile_snapshot(self) -> dict:
        """One consistent reading of the accounting + token count (the
        base or frozen end of a step-bounded window)."""
        return {"cost": self.cost.snapshot_full(),
                "tokens": self._stat("tokens_generated")}

    def profile_doc(self, base=None, window_steps=None, at=None) -> dict:
        """The cost-attribution document (the ``GET /debug/profile``
        body): per-program calls / transfer bytes / compile events /
        wall EWMA / share of the window's wall, phase attribution, and
        the per-decoded-token rates the mega-kernel work is gated on.
        ``base``/``at`` bound the window (prior
        :meth:`_profile_snapshot` readings; None = gateway start /
        now)."""
        co = self.cost
        if co is None:
            raise RuntimeError(
                "cost observatory disabled (gateway built with "
                "cost=False)")
        doc = co.export(base=(base or {}).get("cost"),
                        at=(at or {}).get("cost"))
        tokens = ((at["tokens"] if at is not None
                   else self._stat("tokens_generated"))
                  - (base or {}).get("tokens", 0))
        t = doc["totals"]
        t["decoded_tokens"] = tokens
        t["dispatches_per_decoded_token"] = round(
            t["dispatches"] / max(tokens, 1), 6)
        t["h2d_bytes_per_decoded_token"] = round(
            t["h2d_bytes"] / max(tokens, 1), 3)
        t["d2h_bytes_per_decoded_token"] = round(
            t["d2h_bytes"] / max(tokens, 1), 3)
        doc["window_steps"] = window_steps
        eng = self.engine
        if getattr(eng, "_paged", False):
            # KV columns in BYTES, not blocks (README "Quantized
            # serving"): block counts hide the density story — an int8
            # pool's block is ~4x smaller — so the profile reports the
            # dtype-aware byte footprint (live/trie split from
            # occupancy(), per-block bytes from the pool) alongside
            # the storage dtype and per-token rate.
            # ONE occupancy walk: every byte field below derives from
            # this reading plus the pool's per-block constants
            occ = eng.cache.occupancy()
            kv_b = eng.cache.pool.block_nbytes
            sc_b = eng.cache.pool.scale_block_nbytes
            per_block = kv_b + sc_b
            used = occ["live"] + occ["trie"]
            doc["kv_pool"] = {
                "kv_dtype": eng.kv_dtype,
                "quantize_weights": eng.quantize_weights,
                "quantize_activations": eng.quantize_activations,
                "live_bytes": occ["live"] * per_block,
                "trie_bytes": occ["trie"] * per_block,
                "free_bytes": occ["free"] * per_block,
                "used_kv_bytes": used * kv_b,
                "used_scale_bytes": used * sc_b,
                "capacity_bytes": eng.cache.pool.num_blocks * per_block,
                "bytes_per_token": eng.cache.bytes_per_token(),
            }
        if eng.tp > 1:
            # the window's reduction traffic per layer and per decoded
            # token, beside the engine's degree
            L = max(int(eng.config.num_hidden_layers), 1)
            doc["collectives"] = {
                "tp": eng.tp,
                "per_dtype": {
                    dtype: dict(rec,
                                bytes_per_layer=round(rec["bytes"] / L, 3),
                                bytes_per_decoded_token=round(
                                    rec["bytes"] / max(tokens, 1), 3))
                    for dtype, rec in doc.get("collectives", {}).items()},
            }
        pc = getattr(eng, "prefix_cache", None)
        if pc is not None and pc.tier is not None:
            # the window's spill/readmit traffic per decoded token, and
            # the tier's occupancy now
            doc["tiers"] = {
                "host_tier_bytes": pc.host_tier_bytes,
                "tier_blocks": pc.tier.num_blocks,
                "tier_bytes": pc.tier.bytes_used,
                "per_direction": {
                    d: dict(rec, bytes_per_decoded_token=round(
                        rec["bytes"] / max(tokens, 1), 3))
                    for d, rec in doc.get("tiers", {}).items()},
            }
        return doc

    def capture_profile(self, steps=0, timeout_s=30.0) -> dict:
        """Aggregate cost attribution (``steps <= 0``: everything since
        gateway start), or a STEP-BOUNDED window: block until the
        driver completes ``steps`` engine steps and return only that
        window's costs — the same arm-at-a-step-boundary /
        count-completed-steps machinery as :meth:`capture_trace`, and
        the same serialization rule (a second concurrent window raises
        :class:`TraceBusyError` → HTTP 409)."""
        if self.cost is None:
            raise RuntimeError(
                "cost observatory disabled (gateway built with "
                "cost=False)")
        if steps <= 0:
            return self.profile_doc()
        timeout_s = min(max(float(timeout_s), 0.0), 3600.0)
        with self._lock:
            if self._pcapture is not None:
                raise TraceBusyError(
                    "a profile capture is already in progress")
            done = threading.Event()
            self._pcapture = {"remaining": int(steps), "done": done,
                              "armed": False, "base": None,
                              "end": None, "steps": int(steps)}
        try:
            self._wake.set()
            done.wait(timeout_s)
        finally:
            with self._lock:
                pc, self._pcapture = self._pcapture, None
                if pc["end"] is None:
                    # timed out mid-window: freeze the end NOW, under
                    # the lock, so it is consistent with `remaining`
                    pc["end"] = self._profile_snapshot()
        # report the steps the window actually captured, not the ask: a
        # timed-out capture (slow engine, or a window that never armed
        # because the driver is idle/dead) must not label lifetime or
        # partial totals as an N-step window — per-step rates derived
        # from the document would be silently off. A never-armed window
        # captured NOTHING: its base is its end (empty deltas), never
        # the lifetime aggregate with a 0-step label.
        armed = pc["base"] is not None
        completed = (min(pc["steps"] - max(pc["remaining"], 0),
                         pc["steps"]) if armed else 0)
        doc = self.profile_doc(base=pc["base"] if armed else pc["end"],
                               window_steps=completed, at=pc["end"])
        doc["window_steps_requested"] = pc["steps"]
        doc["window_truncated"] = completed < pc["steps"]
        return doc

    # ------------------------------------------------------ debug surface
    def request_table(self) -> list:
        """Live request table (the ``GET /debug/requests`` body): one
        row per in-flight request — state, slot, token progress,
        queue-wait, TTFT, TPOT-so-far and KV footprint. Reads host
        bookkeeping the driver thread writes (ints/short lists under
        the GIL — same discipline as the scrape-time gauges)."""
        eng = self.engine
        now = eng._clock()
        with self._lock:
            pending = list(self._intake)
            live = list(self._live.values())
        parked_ids = {id(p) for p in self._parked}
        rows = []
        wall = time.monotonic()
        for st in pending:
            # class + TTFT-deadline slack (README "Multi-tenant SLO
            # serving"): pending requests resolve against the live
            # class table (they passed validate at submit, so this
            # cannot raise); slack counts down on the same wall wait
            # the row's queue_wait_s shows
            pclass = eng.classes.resolve(st.request.priority_class)
            slack = (None if pclass.ttft_slo_s is None else
                     round(pclass.ttft_slo_s - (wall - st.submit_time), 6))
            rows.append({"id": st.id, "state": "pending", "slot": None,
                         "class": pclass.name,
                         "prompt_tokens": len(st.request.prompt),
                         "generated_tokens": 0,
                         "max_new_tokens": int(st.request.max_new_tokens),
                         # wait-so-far on the gateway wall clock (the
                         # engine has not seen this request yet, so no
                         # engine-clock stamp exists) — the longest
                         # waiters are exactly the rows an operator
                         # inspecting a saturated server looks for
                         "queue_wait_s": round(wall - st.submit_time, 6),
                         "ttft_s": None,
                         "tpot_s": None, "kv_tokens": 0,
                         "kv_blocks": None,
                         "launches": 0, "kv_bytes": 0,
                         "slo_slack_s": slack})
        for st in live:
            seq = st.seq
            slot = seq.slot
            qw = seq.queue_wait_s
            if qw is None and seq.t_submit is not None:
                qw = now - seq.t_submit          # still waiting: so far
            tpot = seq.tpot_s
            if tpot is None and seq.t_first_token is not None \
                    and len(seq.tokens) > 1 \
                    and seq.t_last_token is not None:
                # TPOT-so-far from the LAST ACCEPTED token's stamp, not
                # the live clock: mid-step the token count is frozen at
                # the previous host-accept while `now` keeps advancing,
                # so a clock-based numerator inflates for the whole
                # step — n ticks of it under multi-tick decode — then
                # snaps back. Stamp-over-stamp stays consistent however
                # long the device runs between syncs.
                tpot = (seq.t_last_token - seq.t_first_token) \
                    / (len(seq.tokens) - 1)
            kv_tokens, kv_blocks, kv_bytes = 0, None, 0
            if slot is not None:
                kv_tokens = int(eng.cache.lengths[slot])
                kv_bytes = eng.cache.slot_kv_bytes(slot)
                if getattr(eng, "_paged", False):
                    kv_blocks = len(eng.cache.slot_block_ids(slot))
            # TTFT-deadline slack on the engine clock: settled once the
            # first token landed (negative = the miss already counted),
            # counting down from the wait-so-far while still queued
            pclass = seq.pclass
            slack = None
            if pclass is not None and pclass.ttft_slo_s is not None:
                waited = seq.ttft_s
                if waited is None and seq.t_submit is not None:
                    waited = now - seq.t_submit
                if waited is not None:
                    slack = round(pclass.ttft_slo_s - waited, 6)
            rows.append({
                "id": st.id,
                "state": ("parked" if id(seq) in parked_ids
                          else seq.status),
                "slot": slot,
                "class": (pclass.name if pclass is not None
                          else eng.classes.default),
                "prompt_tokens": seq.prompt_len,
                "generated_tokens": len(seq.tokens),
                "max_new_tokens": int(seq.request.max_new_tokens),
                "queue_wait_s": None if qw is None else round(qw, 6),
                "ttft_s": (None if seq.ttft_s is None
                           else round(seq.ttft_s, 6)),
                "tpot_s": None if tpot is None else round(tpot, 6),
                "kv_tokens": kv_tokens,
                "kv_blocks": kv_blocks,
                # cost columns (README "Cost attribution &
                # /debug/profile"): device launches this request has
                # ridden so far, and the HBM bytes its KV currently
                # holds (paged: blocks x block bytes; dense: rows x
                # row bytes)
                "launches": seq.launches,
                "kv_bytes": kv_bytes,
                "slo_slack_s": slack,
            })
        return rows

    # ------------------------------------------------------ health surface
    @property
    def running_slots(self) -> int:
        """Slots actively decoding (the ``/healthz`` saturation view)."""
        return sum(1 for s in self.engine._slots
                   if s is not None and s.status == "running")

    @property
    def prefilling_slots(self) -> int:
        """Slots held by mid-chunked-prefill sequences."""
        return sum(1 for s in self.engine._slots
                   if s is not None and s.status == "prefilling")

    @property
    def restarts(self) -> int:
        return self._restarts

    def last_step_age(self) -> float:
        """Seconds since the last completed engine step (the watchdog's
        external visibility — grows without bound while a step is hung)."""
        return max(0.0, self._clock() - self._last_step_done)

    @property
    def health_state(self) -> str:
        """``ok`` | ``degraded`` | ``recovering`` | ``draining`` — the
        ``/healthz`` status. ``recovering``: an engine rebuild or a
        poison bisection is in progress (parked requests exist or a
        suspect half is live). ``degraded``: serving, but the last
        recovery's readmissions have not all finished yet (probation)
        or a transient-retry streak is active."""
        if self._closed:
            return "draining"
        if self._recovering or self._parked or self._suspect_ids:
            return "recovering"
        if self._probation or self._transient_streak:
            return "degraded"
        return "ok"

    # ------------------------------------------------------------ shutdown
    def shutdown(self, drain=True, timeout=None):
        """Close the front door; ``drain=True`` lets in-flight and
        queued work finish, ``drain=False`` cancels it. Blocks until the
        driver exits (or ``timeout``). Returns True if it did."""
        with self._lock:
            self._closed = True
            streams = ([] if drain else
                       list(self._intake) + list(self._live.values()))
        for s in streams:
            s._cancel = True
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
        atexit.unregister(self._atexit_hook)
        return not self._thread.is_alive()
