"""Engine fleet: N replicated serving engines behind one front door —
the port of ``paddle_tpu/serving/fleet/fleet.py`` (README "Engine
fleet").

An :class:`EngineFleet` owns N :class:`~.replica.FleetReplica`\\ s —
each a supervised gateway with its own paged pool, prefix trie,
scheduler and driver thread — and routes every submission through a
pluggable policy (``fleet/router.py``: round-robin, least-loaded,
prefix affinity within a load band, class headroom). The reference's
properties carry over:

- **Programs counted once per geometry**: replicas with the SAME pool
  geometry share one ``jit_cache`` dict of program records (the port's
  counterpart of the reference's shared jit caches), so each engine's
  ``decode_compilations()`` reads the reference's count however many
  replicas serve; replicas with DIFFERENT geometry get dicts of their
  own, so two geometries' signatures never pool under one record.
- **Monotonic fleet metrics**: every replica registers its series
  through a ``registry.labeled(replica=i)`` view of ONE shared registry,
  and each gateway keeps its own carried counter base, so one scrape
  covers the fleet and a replica's rebuild re-bases only its own series.
- **Zero requests lost on replica death**: a replica whose supervisor
  exhausts its restart budget hands its live requests — snapshotted as a
  rebuild's recovery would, PRNG walks included — to the fleet's
  ``on_fatal`` hook, which re-admits each on a sibling by
  ``engine.restore()`` recompute: the stream continues as it would have.

Live migration rides the same primitive in the healthy direction:
:meth:`EngineFleet.migrate` evicts a running sequence from its replica
between steps (chain donated to the source trie, PRNG snapshotted —
``engine.evict``) and re-admits it on a sibling; :meth:`drain_replica`
and :meth:`rebalance` are built from it. The cache plane
(:meth:`EngineFleet._tier_warm`) moves spilled prefix chains between the
replicas' host tiers by content digest.

**On one card.** The replicas share the model's weights and the card:
each replica's driver thread launches its kernels on the port's current
stream, the device's default stream on every thread, so the per-device
buffers the kernels share (the split-KV walk's tickets, the fused tick's
grid barrier) stay ordered as with one engine; a multi-tick engine's
CUDA-graph capture is thread-local and one at a time in the process
(``serving/graphs.py``), so the other replicas go on launching while one
captures. Launch counts are kept per thread too
(``kernels.thread_launches``). Replicas on streams of their own are open
speed work (ROADMAP Queue B item 6).

Routing is deterministic: policies read only replica load and trie
state, never a clock — a fixed submission order over fixed replica
state routes identically on every replay.
"""
from __future__ import annotations

import collections
import threading

import numpy as np

from ...profiler.metrics import MetricsRegistry
from ...profiler.tracing import SpanTracer
from ..prefix_cache import HostTier
from ..server.gateway import GatewayClosedError, QueueFullError, \
    ServingGateway
from .replica import FleetReplica
from .router import make_router

#: the fleet's own trace lane in the merged /debug/trace document
TID_FLEET = 1


def _per_replica(value, n, name):
    """Broadcast a scalar engine knob to ``n`` replicas, or validate a
    per-replica sequence of length ``n`` (the ``--num-slots 8,4``
    CLI form)."""
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(
                f"{name} has {len(value)} per-replica values for "
                f"{n} replicas")
        return list(value)
    return [value] * n


class EngineFleet:
    """N supervised engine replicas + a routing front door.

    ``model`` is shared by every replica (weights live once; each
    replica's KV pool and trie are its own). ``num_slots``,
    ``max_seq_len``, ``prefill_chunk``, ``max_queue``,
    ``prefix_blocks`` and ``host_tier_bytes`` accept either a scalar
    (same on every replica) or a per-replica sequence — mixed pool
    geometries get program-record dicts of their own. ``router`` is a
    policy name (``round-robin`` | ``least-loaded`` | ``affinity`` |
    ``class-headroom``) or a :class:`~.router.Router` instance.
    ``fault_hooks`` threads one fault plan per replica (the chaos
    harness; ``None`` entries leave a replica un-instrumented).
    ``start=False`` leaves every driver stopped so tests and benches can
    submit a whole workload first — routing decisions then depend only
    on submission order, making chaos replays deterministic.
    """

    def __init__(self, model, replicas=2, router="affinity",
                 num_slots=8, max_seq_len=None, decode_chunk=1,
                 max_queue=64, prefix_cache=True, prefix_blocks=None,
                 prefix_block_size=32, paged_attn=True,
                 prefill_chunk=512, ragged_step=True, headroom_mult=2.0,
                 spec_decode=False, spec_k=4, drafter=None,
                 decode_ticks=1, kv_dtype=None, quantize_weights=False,
                 quantize_activations=False,
                 tp=1, collective_dtype="fp", host_tier_bytes=0,
                 priority_classes=None,
                 fused_tick=False, collective_overlap=False,
                 registry=None, clock=None, watchdog_deadline_s=None,
                 max_transient_retries=3, retry_backoff_s=0.02,
                 max_restarts=8, fault_hooks=None, trace=False,
                 trace_buffer=65536, cost=True, idle_wait_s=0.02,
                 start=True):
        n = int(replicas)
        if n < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.model = model
        self.router = make_router(router)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._lock = threading.Lock()
        self._clock = clock
        #: the fleet's own trace lane (router decisions, failovers,
        #: migrations); per-replica engine/request lanes live on each
        #: gateway's tracer and merge into one document in trace_doc()
        self.tracer = SpanTracer(capacity=trace_buffer, clock=clock)
        if trace:
            self.tracer.enable()
        #: routing decision log — (stream_id, replica_index), the chaos
        #: matrix's determinism pin. Bounded: a long-running fleet
        #: appends one entry per admission, and an unbounded list would
        #: be a slow leak on the production submit path (the tracer
        #: ring next to it is bounded for the same reason).
        self.decisions = collections.deque(maxlen=4096)
        slots = _per_replica(num_slots, n, "num_slots")
        smax = _per_replica(max_seq_len, n, "max_seq_len")
        chunk = _per_replica(prefill_chunk, n, "prefill_chunk")
        queues = _per_replica(max_queue, n, "max_queue")
        pblocks = _per_replica(prefix_blocks, n, "prefix_blocks")
        # host_tier_bytes is POLICY, not geometry: it changes no program
        # signature and adds no program key, so it never joins the geom
        # tuple below — replicas with different tier budgets still share
        # one program-record dict. With any replica tiered, submit()
        # runs the fleet cache plane: spilled chains move host-to-host
        # from the replica that evicted them to the replica about to
        # need them.
        tiers = _per_replica(host_tier_bytes, n, "host_tier_bytes")
        # the class table is POLICY too (the host_tier_bytes rule): one
        # parsed table shared fleet-wide — admission/preemption policy
        # must agree across replicas or a migrated request would change
        # tier — and it never joins the geom tuple
        from ..policy import ClassTable
        self.classes = ClassTable.coerce(priority_classes)
        hooks = _per_replica(None, n, "fault_hooks") \
            if fault_hooks is None else list(fault_hooks)
        if len(hooks) != n:
            raise ValueError(
                f"fault_hooks has {len(hooks)} entries for {n} replicas")
        # one program-record dict PER POOL GEOMETRY, model-resident so a
        # second fleet over the same model starts warm: same-geometry
        # replicas (and their rebuilds) share every program record; a
        # differing geometry gets its own, or both engines'
        # decode_compilations() counts would pool
        jits = model.__dict__.setdefault("_serving_jit_fleet", {})
        self.replicas = []
        for i in range(n):
            # every knob that reaches a program's argument shapes or
            # types, or picks another program, is geometry: the pool
            # (num_blocks = live + prefix budget, so prefix_blocks and
            # the trie toggle too), kv_dtype and quantize_weights (other
            # argument types), tp and collective_dtype, fused_tick and
            # collective_overlap (other programs of the same step)
            geom = (slots[i], smax[i], chunk[i], bool(paged_attn),
                    bool(ragged_step), bool(spec_decode), int(spec_k),
                    int(decode_chunk), int(prefix_block_size),
                    bool(prefix_cache), pblocks[i], int(decode_ticks),
                    kv_dtype, bool(quantize_weights),
                    bool(quantize_activations),
                    int(tp), str(collective_dtype),
                    bool(fused_tick), bool(collective_overlap))
            jit = jits.setdefault(geom, {})

            def factory(i=i, jit=jit):
                from ..engine import ContinuousBatchingEngine
                return ContinuousBatchingEngine(
                    model, num_slots=slots[i], max_seq_len=smax[i],
                    decode_chunk=decode_chunk,
                    prefix_cache=prefix_cache,
                    prefix_blocks=pblocks[i],
                    prefix_block_size=prefix_block_size,
                    paged_attn=paged_attn, prefill_chunk=chunk[i],
                    ragged_step=ragged_step,
                    headroom_mult=headroom_mult,
                    spec_decode=spec_decode, spec_k=spec_k,
                    drafter=drafter, decode_ticks=decode_ticks,
                    kv_dtype=kv_dtype,
                    quantize_weights=quantize_weights,
                    quantize_activations=quantize_activations,
                    tp=tp, collective_dtype=collective_dtype,
                    host_tier_bytes=tiers[i],
                    priority_classes=self.classes,
                    fused_tick=fused_tick,
                    collective_overlap=collective_overlap,
                    jit_cache=jit)

            gw = ServingGateway(
                factory(), max_queue=queues[i], idle_wait_s=idle_wait_s,
                registry=self.registry.labeled(replica=str(i)),
                start=False, engine_factory=factory,
                watchdog_deadline_s=watchdog_deadline_s,
                max_transient_retries=max_transient_retries,
                retry_backoff_s=retry_backoff_s,
                max_restarts=max_restarts, clock=clock,
                fault_hook=hooks[i], trace=trace,
                trace_buffer=trace_buffer, cost=cost,
                on_fatal=self._on_replica_fatal,
                stream_id_prefix=f"cmpl-r{i}")
            self.replicas.append(FleetReplica(i, gw))
        self._init_metrics()
        if start:
            self.start()

    # ------------------------------------------------------------- helpers
    def _tr(self):
        """The fleet tracer when recording, else None — the engine's
        ``_tr()`` one-attribute guard discipline, fleet lane."""
        t = self.tracer
        return t if t.enabled else None

    def _routable(self, exclude=None):
        return [r for r in self.replicas
                if r.routable and r is not exclude]

    def _alive(self, exclude=None):
        return [r for r in self.replicas
                if r.alive and r is not exclude]

    def _by_gateway(self, gateway):
        for r in self.replicas:
            if r.gateway is gateway:
                return r
        return None

    # ------------------------------------------------------------- metrics
    def _init_metrics(self):
        r = self.registry
        r.gauge("serving_fleet_replicas",
                "Engine replicas behind the fleet front door.").set(
            len(self.replicas))
        r.gauge("serving_fleet_alive_replicas",
                "Replicas currently routable (alive and accepting)."
                ).set_fn(lambda: len(self._routable()))
        self._m_routed = r.counter(
            "serving_fleet_router_decisions_total",
            "Admissions routed, by policy and chosen replica.")
        self._m_failovers = r.counter(
            "serving_fleet_failovers_total",
            "Replica deaths whose live requests were re-admitted on "
            "siblings (failover-to-sibling events).")
        self._m_migrated = r.counter(
            "serving_fleet_migrated_requests_total",
            "Requests moved between replicas, by cause "
            "(cause = failover|migration).")
        self._m_tier_transfers = r.counter(
            "serving_fleet_tier_transfers_total",
            "Spilled prefix blocks moved host-to-host between replica "
            "tiers by the fleet cache plane (a routed request about to "
            "miss on its replica pulled the chain from the sibling "
            "that spilled it).")
        self._m_tier_transfer_bytes = r.counter(
            "serving_fleet_tier_transfer_bytes_total",
            "Host bytes the fleet cache plane moved between replica "
            "tiers.")
        # plain carried ints for /fleet/cacheplane (scrape-style reads
        # under the submit lock, like the decisions log)
        self._tier_transfers = 0
        self._tier_transfer_bytes = 0

    # ---------------------------------------------------------- front door
    def submit(self, request):
        """Route and enqueue one request; returns its
        :class:`~..server.gateway.TokenStream`. Walks the router's
        preference order so a full waiting room sheds sideways to the
        next-best replica; :class:`QueueFullError` means EVERY routable
        replica is full (the HTTP 429), :class:`GatewayClosedError`
        that none is routable (503)."""
        reps = self._routable()
        # heterogeneous max_seq_len: prefer replicas that can hold the
        # request to completion; when NONE can, keep the full order so
        # the first replica's validate() raises the true 400 (a request
        # too long for every replica must not surface as a 503)
        fitting = [r for r in reps if r.can_hold(request)]
        order = self.router.rank(request, fitting or reps)
        if not order:
            raise GatewayClosedError("no routable replicas")
        last = None
        for k, rep in enumerate(order):
            try:
                self._tier_warm(rep, request)
                stream = rep.gateway.submit(request)
            except (QueueFullError, GatewayClosedError) as e:
                last = e
                continue
            with self._lock:
                self.decisions.append((stream.id, rep.index))
            self._m_routed.inc(policy=self.router.name,
                               replica=str(rep.index))
            tr = self._tr()
            if tr is not None:
                tr.instant(
                    "route", tid=TID_FLEET,
                    args={"stream": stream.id, "replica": rep.index,
                          "policy": self.router.name, "rank": k,
                          "load": rep.load()})
            return stream
        raise last

    # -------------------------------------------------- fleet cache plane
    def _tier_warm(self, rep, request):
        """The fleet cache plane (README "Tiered KV prefix cache"):
        before a routed request submits to ``rep``, pull any spilled
        prefix chain it will need from a sibling replica's host tier
        into ``rep``'s — host-to-host, by reference (tier buffers are
        immutable by convention), addressed by content digests
        (:meth:`HostTier.chain_digests`), so a miss on replica A that
        hits replica B's tier becomes a local tier hit at admission:
        prefix affinity upgraded from a routing heuristic to a
        distributed prefix cache. Transfers extend the target's
        coverage contiguously from its resident+tier frontier and stop
        at the first block no sibling holds. Returns blocks moved;
        never raises (racing a driver-side trie mutation degrades to a
        cold route, exactly like the affinity probe)."""
        pc = getattr(rep.gateway.engine, "prefix_cache", None)
        if pc is None or pc.tier is None \
                or getattr(request, "prompt", None) is None:
            return 0
        try:
            prompt = np.asarray(request.prompt).reshape(-1)
            keys = pc._blocks_of(prompt, len(prompt) - 1)
            if not keys:
                return 0
            digests = HostTier.chain_digests(keys)
            covered = len(pc.lookup(prompt, record=False))
        except Exception:
            return 0                # malformed prompt / racing rebuild
        moved = moved_bytes = 0
        path = tuple(keys[:covered])
        for depth in range(covered, len(keys)):
            path = path + (keys[depth],)
            if pc.tier.has(path):
                continue            # already local
            entry = None
            for donor in self.replicas:
                if donor is rep or not donor.alive:
                    continue
                dpc = getattr(donor.gateway.engine, "prefix_cache", None)
                if dpc is None or dpc.tier is None:
                    continue
                entry = dpc.tier.export_digest(digests[depth])
                if entry is not None:
                    break
            if entry is None:
                break               # chain must stay contiguous
            _, bufs, nbytes = entry
            # shared=True: these are the donor tier's buffers by
            # reference (the pointer-move transfer) — neither tier may
            # recycle them into its staging pool
            pc.tier.put(path, bufs, shared=True)
            pc.stats["tier_transfers"] += 1
            moved += 1
            moved_bytes += nbytes
            co = rep.gateway.cost
            if co is not None:
                co.record_tier("peer", 1, nbytes)
        if moved:
            with self._lock:
                self._tier_transfers += moved
                self._tier_transfer_bytes += moved_bytes
            self._m_tier_transfers.inc(moved)
            self._m_tier_transfer_bytes.inc(moved_bytes)
            tr = self._tr()
            if tr is not None:
                tr.instant(
                    "tier_transfer", tid=TID_FLEET,
                    args={"to": rep.index, "blocks": moved,
                          "bytes": moved_bytes})
        return moved

    def cache_plane_doc(self) -> dict:
        """The ``GET /fleet/cacheplane`` body: per-replica tier
        occupancy + published digest counts, and the fleet's transfer
        totals — the distributed-prefix-cache debug surface."""
        rows = []
        for r in self.replicas:
            pc = getattr(r.gateway.engine, "prefix_cache", None)
            tier = pc.tier if pc is not None else None
            row = {"replica": r.index, "enabled": tier is not None}
            if tier is not None:
                row.update(
                    tier_blocks=tier.num_blocks,
                    tier_bytes=tier.bytes_used,
                    capacity_bytes=pc.host_tier_bytes,
                    digests=len(tier.digest_table()),
                    spilled_blocks=int(
                        r.gateway._pc_stat("spilled_blocks")),
                    tier_hits=int(r.gateway._pc_stat("tier_hits")),
                    readmitted_blocks=int(
                        r.gateway._pc_stat("readmitted_blocks")),
                    tier_transfers_in=int(
                        r.gateway._pc_stat("tier_transfers")))
            rows.append(row)
        with self._lock:
            transfers = self._tier_transfers
            transfer_bytes = self._tier_transfer_bytes
        return {"replicas": rows,
                "transfers_total": transfers,
                "transfer_bytes_total": transfer_bytes}

    # ------------------------------------------------------------ failover
    def _on_replica_fatal(self, gateway, pairs):
        """Failover-to-sibling (the gateway's ``on_fatal`` hook, called
        on the dying replica's driver thread): mark the replica dead,
        then re-admit each surviving (stream, sequence) pair on the
        least-loaded alive sibling — ``adopt`` + ``restore()``
        recompute, streams byte-identical. Returns the streams actually
        adopted; any the siblings refuse fall back to the gateway's
        stranding path (an error event, never a hang)."""
        rep = self._by_gateway(gateway)
        if rep is None:
            return False
        rep.dead = True
        adopted = []
        targets = self._alive()
        if not targets:
            return False            # last replica down: strand as before
        tr = self._tr()
        if tr is not None:
            tr.instant("replica_dead", tid=TID_FLEET,
                       args={"replica": rep.index,
                             "survivors": len(pairs)})
        for stream, seq in pairs:
            placed = False
            for tgt in sorted(
                    (r for r in self._alive()
                     if r.can_hold(stream.request)),
                    key=lambda r: (r.load(), r.index)):
                try:
                    tgt.gateway.adopt(stream, seq)
                except GatewayClosedError:
                    continue
                adopted.append(stream)
                self._m_migrated.inc(cause="failover")
                if tr is not None:
                    tr.instant(
                        "failover", tid=TID_FLEET,
                        args={"stream": stream.id, "from": rep.index,
                              "to": tgt.index,
                              "tokens": (len(seq.tokens)
                                         if seq is not None else 0)})
                placed = True
                break
            if not placed and not self._alive():
                break               # no target left at all: strand rest
            # else: THIS request is unplaceable (every alive sibling
            # refused or is too small for it) — it strands with an
            # error, but later survivors still get their chance
        if adopted:
            self._m_failovers.inc()
        return adopted

    # ----------------------------------------------------- live migration
    def migrate(self, stream, target=None):
        """Move one in-flight request to another replica while both are
        healthy: the source driver evicts its sequence between steps
        (chain donated to the source trie, PRNG walk snapshotted) and
        the pair is adopted by ``target`` (a replica or index; default:
        the least-loaded other replica, chosen at handoff time). The
        stream continues byte-identically on the target — consumers
        see a pause, never a replayed or lost token. Asynchronous: the
        handoff happens on the source driver's next loop pass."""
        if isinstance(target, int):
            target = self.replicas[target]
        source = self._by_gateway(stream.gateway)

        def handoff(st, seq):
            tgt = target
            if tgt is not None and not tgt.can_hold(st.request):
                tgt = None      # explicit target too small: re-select
            if tgt is None or not tgt.alive:
                cands = sorted(
                    (r for r in self._routable(exclude=source)
                     if r.can_hold(st.request)),
                    key=lambda r: (r.load(), r.index))
                if not cands:
                    raise GatewayClosedError(
                        "no routable sibling can hold this request")
                tgt = cands[0]
            tgt.gateway.adopt(st, seq)
            self._m_migrated.inc(cause="migration")
            tr = self._tr()
            if tr is not None:
                tr.instant(
                    "migrate", tid=TID_FLEET,
                    args={"stream": st.id,
                          "from": source.index if source else None,
                          "to": tgt.index,
                          "tokens": (len(seq.tokens)
                                     if seq is not None else 0)})

        stream.gateway.request_migration(stream, handoff)

    def _live_streams(self, rep):
        """Snapshot a replica's in-flight streams (driver mutates the
        dict concurrently; retry the rare mid-resize read)."""
        gw = rep.gateway
        for _ in range(8):
            try:
                return list(gw._live.values()) + list(gw._intake)
            except RuntimeError:
                continue
        return []

    def drain_replica(self, index) -> int:
        """Take a replica out of rotation (maintenance): new work
        routes around it and every in-flight request migrates to a
        sibling by eviction + ``restore()`` recompute. Returns the
        number of migrations requested; the replica's driver performs
        them on its next loop passes. The replica stays alive and can
        be returned to rotation with :meth:`undrain_replica`."""
        rep = self.replicas[int(index)]
        rep.accepting = False
        if not self._routable(exclude=rep):
            return 0                # nowhere to move work; just cordon
        streams = [st for st in self._live_streams(rep)
                   if st.finish_reason is None]
        for st in streams:
            self.migrate(st)
        return len(streams)

    def undrain_replica(self, index):
        """Return a drained (alive) replica to rotation."""
        rep = self.replicas[int(index)]
        if rep.dead:
            raise ValueError(f"replica {rep.index} is dead")
        rep.accepting = True

    def rebalance(self, max_moves=8) -> int:
        """One load-shedding pass: migrate up to ``max_moves`` of the
        MOST-loaded replica's youngest in-flight requests (least sunk
        recompute work — the preemption policy's victim order) to the
        LEAST-loaded replica, until their in-flight counts would be
        within one of each other. Returns migrations requested."""
        reps = self._routable()
        if len(reps) < 2:
            return 0
        src = max(reps, key=lambda r: (r.load(), -r.index))
        dst = min(reps, key=lambda r: (r.load(), r.index))
        if src is dst:
            return 0
        src_live = [st for st in self._live_streams(src)
                    if st.finish_reason is None and st.seq is not None]
        dst_live = sum(1 for st in self._live_streams(dst)
                       if st.finish_reason is None)
        gap = len(src_live) - dst_live
        if gap <= 1:
            return 0
        src_live.sort(key=lambda st: -st.seq.request_id)  # youngest first
        moves = min(int(max_moves), gap // 2)
        for st in src_live[:moves]:
            self.migrate(st, target=dst)
        return moves

    # ------------------------------------------------------ health / debug
    @property
    def health_state(self) -> str:
        """Fleet-level ``/healthz`` status: ``ok`` when every routable
        replica is ok; ``degraded`` when any replica is degraded, dead
        or draining (capacity is reduced but the fleet serves);
        ``recovering`` while any replica recovers; ``draining`` when
        nothing is routable."""
        routable = self._routable()
        if not routable:
            return "draining"
        states = {r.gateway.health_state for r in routable}
        if "recovering" in states:
            return "recovering"
        if "degraded" in states or len(routable) < len(self.replicas):
            return "degraded"
        return "ok"

    def fleet_table(self) -> list:
        """The ``GET /debug/fleet`` body: one row per replica — state,
        live/free KV blocks, queue depth, dispatches per token, last
        rebuild — computed by the same reads as the per-replica
        ``/metrics``/``/debug/profile`` surfaces."""
        return [r.row() for r in self.replicas]

    def trace_doc(self) -> dict:
        """Merged Chrome-trace snapshot: the fleet lane (router
        decisions, failovers, migrations) as pid 0 and each replica's
        full timeline (engine phases, request lanes, counter tracks)
        as pid ``replica + 1`` — one Perfetto document for the whole
        fleet."""
        events = [{**ev, "pid": 0} for ev in self.tracer.events()]
        dropped = self.tracer.dropped
        for rep in self.replicas:
            t = rep.gateway.tracer
            events.extend({**ev, "pid": rep.index + 1}
                          for ev in t.events())
            dropped += t.dropped
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"clock": "injectable-monotonic",
                              "dropped_events": dropped,
                              "pid_map": {"0": "fleet", **{
                                  str(r.index + 1): f"replica{r.index}"
                                  for r in self.replicas}}}}

    def profile_doc(self) -> dict:
        """Fleet cost attribution: each replica's ``/debug/profile``
        document plus fleet totals (dispatches, decoded tokens and the
        aggregate dispatches-per-decoded-token rate)."""
        per = {}
        dispatches = tokens = 0
        for rep in self.replicas:
            gw = rep.gateway
            if gw.cost is None:
                continue
            per[str(rep.index)] = gw.profile_doc()
            dispatches += gw.cost.totals["dispatches"]
            tokens += gw._stat("tokens_generated")
        return {"replicas": per, "totals": {
            "dispatches": dispatches, "decoded_tokens": tokens,
            "dispatches_per_decoded_token": round(
                dispatches / max(tokens, 1), 6)}}

    # ----------------------------------------------------------- lifecycle
    def start(self):
        """Start every replica's driver thread (idempotent)."""
        for rep in self.replicas:
            rep.gateway.start()
        return self

    def shutdown(self, drain=True, timeout=None):
        """Close every replica's front door and stop its driver
        (``drain=True`` lets in-flight work finish). Returns True when
        every driver exited."""
        for rep in self.replicas:
            with rep.gateway._lock:
                rep.gateway._closed = True
        ok = True
        for rep in self.replicas:
            ok = rep.gateway.shutdown(drain=drain, timeout=timeout) and ok
        return ok
