"""Device-boundary cost observatory for the serving stack (README
"Cost attribution & /debug/profile") — the port of
``paddle_tpu/profiler/cost.py``.

The span tracer says *where wall-time goes*; this module says *what
crosses the host↔device boundary*. A :class:`CostObservatory` wraps every
serving program the engine hands out of its jit cache in a counting
facade (:class:`_CountedProgram`) and records, per program key:

- **dispatches** — exact call counts (the facade IS the call);
- **host→device bytes** — shape × itemsize of every *host-resident*
  argument leaf: numpy arrays and scalars, exactly what the call must
  copy to the device (torch tensors — weights, the KV pool — are
  device-resident and not charged);
- **device→host bytes** — shape × itemsize of the result leaves the
  engine fetches to host (declared per program via ``host_out``: the
  sampled tokens and keys, never the pool);
- **compile events** — new program signatures recorded at the call
  (``_cache_size()`` deltas; eager PyTorch compiles nothing, the count
  is the JAX package's trace count for the same traffic);
- **wall EWMA / total** — per-call wall time on an injectable clock
  (the fault harness's ``VirtualClock`` makes a chaos replay's exported
  accounting byte-identical);
- **launch census** — where the JAX package counts the ``pallas_call``s
  in a program's jaxpr, the port reads its own launch counters (the
  calling thread's, ``kernels.thread_launches()``: a fleet's replicas
  launch from their own threads) across the program's first dispatch:
  the kernels one call of that program launched. On the CPU no kernel
  launches and the census reads zeros. Its ``collectives`` entry counts
  the wire operations of the tensor-parallel reductions the call ran (the
  same tally's ``tp_wire_ops``), where the JAX census counts the
  collective primitives of the jaxpr;
- **collectives** — the tensor-parallel engine's cross-shard reduction
  traffic by wire dtype (:meth:`CostObservatory.record_collective`), a
  ledger apart from h2d/d2h: it never crosses the host boundary, and a
  ``tp=2`` run's h2d/d2h totals equal the ``tp=1`` run's.

All sizes come from shapes — no device sync, no value reads. The engine
guards every touch on ``_co()`` — one attribute check when disabled.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..kernels import KERNELS, thread_launches

#: every program kind the JAX engine's jit cache can hand out — the fixed
#: label set of ``serving_dispatches_total{program=...}`` (kinds the port
#: does not run scrape as 0, as unused kinds do there)
PROGRAM_KINDS = ("prefill", "suffix", "psuffix", "decode", "pdecode",
                 "ragged", "mtick", "spec")


def _nbytes(leaf) -> int:
    """Byte size of one leaf from its shape — a numpy array, a tensor
    or a scalar; no device sync."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        n = 1
        for d in shape:
            n *= int(d)
        return n * np.dtype(dtype).itemsize
    try:
        return np.dtype(type(leaf)).itemsize
    except TypeError:
        return 8          # opaque python scalar: one word, by convention


def _leaves(tree):
    """The leaves of nested tuples, lists and dicts (the
    ``jax.tree_util.tree_leaves`` of the program arguments)."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [] if tree is None else [tree]


def _label(key) -> str:
    """Stable per-program label from a jit-cache key tuple:
    ``("ragged", 8, 72, 1, "jnp")`` → ``"ragged[8,72,1,jnp]"``."""
    if len(key) == 1:
        return str(key[0])
    return f"{key[0]}[{','.join(str(k) for k in key[1:])}]"


class CostObservatory:
    """Exact per-program dispatch / transfer / compile accounting.

    One observatory is OWNED BY THE GATEWAY and installed on every
    engine incarnation (``engine.cost``), so its counts are monotonic
    across crash-recovery rebuilds — the same ownership rule as the
    tracer and the ``serving_preemptions_total`` base. ``clock`` is any
    zero-arg monotonic-seconds callable (default ``time.perf_counter``;
    tests and the chaos bench pass a
    :class:`~paddle_tpu_torch.serving.faults.VirtualClock`, under which
    the exported accounting replays byte-identically).

    The engine guards every touch on :attr:`enabled` through its
    ``_co()`` helper — one attribute check when disabled, the same
    discipline as the tracer's ``_tr()``.
    """

    def __init__(self, clock=None, ewma_alpha=0.2):
        self.clock = clock if clock is not None else time.perf_counter
        self.enabled = True
        self.ewma_alpha = float(ewma_alpha)
        # label -> per-program record (insertion-ordered: deterministic
        # under a deterministic workload, so export() is byte-stable)
        self.programs = {}
        # step-phase attribution (the engine names the current phase:
        # admit | plan | launch | host-accept): where dispatches land
        self.phases = {}
        self._phase = None
        self.totals = {"dispatches": 0, "h2d_bytes": 0, "d2h_bytes": 0,
                       "compiles": 0, "wall_s": 0.0}
        # the tensor-parallel reductions' wire traffic by wire dtype: a
        # ledger apart from h2d/d2h (all-reduce bytes never cross the
        # host boundary)
        self.collectives = {}
        # KV-tier traffic by direction (the host-RAM spill tier): a
        # ledger apart from the per-program h2d/d2h records, whose
        # arguments and results it never touches. Directions: "d2h"
        # (spill), "h2d" (readmit), "peer" (a fleet's host-to-host
        # transfer in; not ported yet)
        self.tiers = {}
        # label -> launch census: the kernel launches the program's FIRST
        # dispatch made, read off the launch counters across the call
        # (the same chokepoint as every other column, so exactly the
        # programs that ran export one)
        self.censuses = {}

    # ------------------------------------------------------------- control
    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def set_phase(self, phase):
        """Name the step phase subsequent dispatches are attributed to
        (None between steps)."""
        self._phase = phase

    # ------------------------------------------------------------ recording
    def wrap(self, key, fn, host_out=()):
        """Counting facade over one jitted program handed out of the
        jit-cache. ``key`` is the cache key (its first element is the
        program kind); ``host_out`` names the result indices the engine
        fetches to host — the exact device→host surface."""
        return _CountedProgram(self, _label(key), str(key[0]), fn,
                               tuple(host_out))

    def _record(self, label, kind, args, out, host_out, compiles, dt):
        h2d = sum(_nbytes(leaf) for leaf in _leaves(args)
                  if not isinstance(leaf, torch.Tensor))
        d2h = sum(_nbytes(leaf) for i in host_out
                  for leaf in _leaves(out[i]))
        rec = self.programs.get(label)
        if rec is None:
            rec = {"kind": kind, "calls": 0, "h2d_bytes": 0,
                   "d2h_bytes": 0, "compiles": 0, "wall_s": 0.0,
                   "wall_ewma_s": None}
            self.programs[label] = rec
        rec["calls"] += 1
        rec["h2d_bytes"] += h2d
        rec["d2h_bytes"] += d2h
        rec["compiles"] += compiles
        rec["wall_s"] += dt
        rec["wall_ewma_s"] = dt if rec["wall_ewma_s"] is None else \
            (1 - self.ewma_alpha) * rec["wall_ewma_s"] + self.ewma_alpha * dt
        t = self.totals
        t["dispatches"] += 1
        t["h2d_bytes"] += h2d
        t["d2h_bytes"] += d2h
        t["compiles"] += compiles
        t["wall_s"] += dt
        ph = self.phases.get(self._phase)
        if ph is None:
            ph = {"dispatches": 0, "h2d_bytes": 0, "d2h_bytes": 0,
                  "wall_s": 0.0}
            self.phases[self._phase] = ph
        ph["dispatches"] += 1
        ph["h2d_bytes"] += h2d
        ph["d2h_bytes"] += d2h
        ph["wall_s"] += dt

    def record_census(self, label, launches, collectives=0):
        """Record one program's launch census (idempotent per label;
        the counting facade passes the launch-counter and wire-operation
        deltas of the program's first dispatch)."""
        if label not in self.censuses:
            self.censuses[label] = {"launches": dict(launches),
                                    "collectives": int(collectives)}

    def record_collective(self, dtype, ops, nbytes):
        """Account one sharded launch's reduction traffic: ``ops``
        reductions moving ``nbytes`` wire bytes a device, under wire dtype
        ``dtype`` (``fp`` | ``int8``). Sized from shapes by the caller (the
        engine's ``_record_collectives``). The
        ``serving_collective_bytes_total{dtype}`` counter and the
        ``/debug/profile`` collectives section read this."""
        rec = self.collectives.get(dtype)
        if rec is None:
            rec = {"ops": 0, "bytes": 0}
            self.collectives[dtype] = rec
        rec["ops"] += int(ops)
        rec["bytes"] += int(nbytes)

    def collective_bytes(self, dtype) -> int:
        """Total wire bytes recorded under one collective dtype (0 for one
        that never ran: tp=1 engines scrape explicit zeros)."""
        rec = self.collectives.get(dtype)
        return int(rec["bytes"]) if rec else 0

    def record_tier(self, direction, blocks, nbytes):
        """Account KV-tier traffic: ``blocks`` pool blocks moving
        ``nbytes`` bytes under ``direction`` (``d2h`` spill | ``h2d``
        readmit | ``peer``). The caller (the prefix cache's spill and
        readmit paths) sizes it from the staging buffers. The
        ``serving_tier_bytes_total{direction}`` counter and the
        ``/debug/profile`` tiers section read this."""
        rec = self.tiers.get(direction)
        if rec is None:
            rec = {"blocks": 0, "bytes": 0}
            self.tiers[direction] = rec
        rec["blocks"] += int(blocks)
        rec["bytes"] += int(nbytes)

    def tier_bytes(self, direction) -> int:
        """Total bytes recorded under one tier direction (0 for one that
        never moved)."""
        rec = self.tiers.get(direction)
        return int(rec["bytes"]) if rec else 0

    # -------------------------------------------------------------- reading
    def kind_calls(self, kind) -> int:
        """Total dispatches of one program kind (the
        ``serving_dispatches_total{program}`` series). ``list()``
        snapshots the dict before iterating: scrapes run on HTTP
        handler threads while the driver may be inserting a new
        program label, and bare dict iteration would raise
        "changed size during iteration"."""
        return sum(rec["calls"] for rec in list(self.programs.values())
                   if rec["kind"] == kind)

    def snapshot(self) -> dict:
        """Cheap totals copy — the engine's per-step delta base."""
        return dict(self.totals)

    def delta(self, base) -> dict:
        """Totals accrued since ``base`` (a prior :meth:`snapshot`)."""
        return {k: self.totals[k] - base[k]
                for k in ("dispatches", "h2d_bytes", "d2h_bytes",
                          "compiles")}

    def snapshot_full(self) -> dict:
        """Deep copy of the whole accounting — the base (or frozen end)
        of a step-bounded ``/debug/profile`` capture window. ``list()``
        snapshots each dict before iterating (see :meth:`kind_calls`);
        concurrent driver updates can tear a single in-flight record,
        never crash."""
        return {"programs": {k: dict(v)
                             for k, v in list(self.programs.items())},
                "phases": {k: dict(v)
                           for k, v in list(self.phases.items())},
                "totals": dict(self.totals),
                "collectives": {k: dict(v)
                                for k, v in list(
                                    self.collectives.items())},
                "tiers": {k: dict(v)
                          for k, v in list(self.tiers.items())},
                "censuses": {k: (dict(v) if v is not None else None)
                             for k, v in list(self.censuses.items())}}

    def export(self, base=None, at=None) -> dict:
        """The cost-attribution document: aggregate, the delta since
        ``base``, or the ``base``→``at`` window (both prior
        :meth:`snapshot_full` snapshots — ``at`` is how a step-bounded
        capture freezes its END at the exact step boundary instead of
        leaking later steps into the window). Deterministic for a
        deterministic workload: insertion-ordered programs, rounded
        floats, no wall-clock reads."""
        state = at if at is not None else self.snapshot_full()
        base_p = (base or {}).get("programs", {})
        base_t = (base or {}).get("totals", {})
        base_ph = (base or {}).get("phases", {})
        wall_total = state["totals"]["wall_s"] - base_t.get("wall_s", 0.0)
        programs = []
        for label, rec in state["programs"].items():
            b = base_p.get(label, {})
            calls = rec["calls"] - b.get("calls", 0)
            if calls <= 0:
                continue
            wall = rec["wall_s"] - b.get("wall_s", 0.0)
            entry = {
                "program": label, "kind": rec["kind"], "calls": calls,
                "h2d_bytes": rec["h2d_bytes"] - b.get("h2d_bytes", 0),
                "d2h_bytes": rec["d2h_bytes"] - b.get("d2h_bytes", 0),
                "compiles": rec["compiles"] - b.get("compiles", 0),
                "wall_s": round(wall, 9),
                "wall_ewma_s": round(rec["wall_ewma_s"] or 0.0, 9),
                "share_of_wall": round(wall / wall_total, 6)
                if wall_total > 0 else 0.0,
            }
            census = state.get("censuses", {}).get(label)
            if census is not None:
                entry["census"] = census
            programs.append(entry)
        programs.sort(key=lambda r: (-r["wall_s"], -r["calls"],
                                     r["program"]))
        phases = {}
        for name, rec in state["phases"].items():
            b = base_ph.get(name, {})
            d = rec["dispatches"] - b.get("dispatches", 0)
            if d <= 0:
                continue
            phases[str(name)] = {
                "dispatches": d,
                "h2d_bytes": rec["h2d_bytes"] - b.get("h2d_bytes", 0),
                "d2h_bytes": rec["d2h_bytes"] - b.get("d2h_bytes", 0),
                "wall_s": round(rec["wall_s"] - b.get("wall_s", 0.0), 9),
            }
        totals = {k: state["totals"][k] - base_t.get(k, 0)
                  for k in ("dispatches", "h2d_bytes", "d2h_bytes",
                            "compiles")}
        totals["wall_s"] = round(wall_total, 9)
        base_tr = (base or {}).get("tiers", {})
        tiers = {}
        for direction, rec in state.get("tiers", {}).items():
            b = base_tr.get(direction, {})
            d_blocks = rec["blocks"] - b.get("blocks", 0)
            d_bytes = rec["bytes"] - b.get("bytes", 0)
            if d_blocks <= 0 and d_bytes <= 0:
                continue
            tiers[direction] = {"blocks": d_blocks, "bytes": d_bytes}
        base_c = (base or {}).get("collectives", {})
        collectives = {}
        for dtype, rec in state.get("collectives", {}).items():
            b = base_c.get(dtype, {})
            d_ops = rec["ops"] - b.get("ops", 0)
            d_bytes = rec["bytes"] - b.get("bytes", 0)
            if d_ops <= 0 and d_bytes <= 0:
                continue
            collectives[dtype] = {"ops": d_ops, "bytes": d_bytes}
        return {"programs": programs, "phases": phases, "totals": totals,
                "collectives": collectives, "tiers": tiers}


class _CountedProgram:
    """The counting facade: calls the wrapped program and records exact
    dispatch/byte/compile/wall accounting, and the launch census on the
    program's first dispatch. Handed out fresh per accessor call (the
    jit cache keeps the raw program, so ``decode_compilations()`` is
    untouched). Runs on the engine-driver thread, the only thread that
    launches, so the launch-counter delta is this call's."""

    __slots__ = ("_co", "_label", "_kind", "_fn", "_host_out")

    def __init__(self, co, label, kind, fn, host_out):
        self._co = co
        self._label = label
        self._kind = kind
        self._fn = fn
        self._host_out = host_out

    def _cache_size(self):
        return self._fn._cache_size()

    def __call__(self, *args, **kw):
        # keyword arguments are host-side state (the multi-tick program's
        # graph holder), not program arguments: no bytes are counted
        co = self._co
        fn = self._fn
        census = self._label not in co.censuses
        launches0 = thread_launches() if census else None
        t0 = co.clock()
        c0 = fn._cache_size()
        out = fn(*args, **kw)
        co._record(self._label, self._kind, args, out, self._host_out,
                   fn._cache_size() - c0, co.clock() - t0)
        if census:
            launches = thread_launches()
            co.record_census(self._label,
                             {k: launches[k] - launches0[k]
                              for k in KERNELS
                              if launches[k] != launches0[k]},
                             launches["tp_wire_ops"]
                             - launches0["tp_wire_ops"])
        return out
