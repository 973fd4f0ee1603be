"""Deterministic fault injection for the serving stack — the port of
``paddle_tpu/serving/faults.py``.

The fault-tolerance layer (supervised gateway driver + engine
preemption, README "Fault tolerance & chaos testing") is only
trustworthy if every failure class it claims to survive can be
reproduced on demand, at an exact step, with an exact blast radius.
This module is that reproducer: a :class:`FaultPlan` is a deterministic
schedule of injected faults, threaded through the engine and gateway as
injectable hooks —

- the engine calls its ``fault_hook`` at the top of every ``step()``
  attempt (a step boundary, so an injected raise always leaves host
  bookkeeping consistent — exactly the contract recovery recomputes
  from);
- the gateway re-installs the same hook on every engine it builds, so a
  plan keeps firing across crash-recovery rebuilds (its step counter is
  plan-global, not per-engine-incarnation);
- simulated *hangs* never sleep: the plan advances a
  :class:`VirtualClock` past the supervisor's watchdog deadline and
  returns, so the hung-step classification is tested in microseconds.

Fault classes (``kind``):

- ``"transient"`` — raises :class:`TransientFault`; the supervisor
  retries the same engine with bounded backoff.
- ``"fatal"`` — raises :class:`FatalFault`; the supervisor rebuilds the
  engine and recovers every live request by recompute.
- ``"nan"`` — REALLY corrupts the engine's KV storage with NaNs, then
  raises :class:`FatalFault`. Recovery must recompute from host-side
  token state; a bystander stream that stays byte-identical proves the
  corrupted device state was discarded, not reused.
- ``"hung"`` — advances the plan's :class:`VirtualClock` by
  ``stall_s`` and returns; the step "completes" but overran the
  watchdog, so the supervisor classifies it hung and rebuilds.
- ``"pool"`` — raises :class:`~.kv_cache.PoolExhausted`; the ENGINE
  catches this one itself and preempts the youngest sequence
  (recompute, not crash) — the gateway never sees it.

Poison faults (:meth:`FaultPlan.poison`) fire whenever a matching
sequence holds a KV slot, every time it is readmitted — the
repeated-crash-pinned-to-one-request case the gateway's bisection
quarantine exists to isolate.

Everything here is host-side and dependency-free; production builds
simply never install a plan (``fault_hook=None`` costs one attribute
check per step).
"""
from __future__ import annotations


class FaultError(RuntimeError):
    """Base class of injected faults (so tests/benches can catch the
    whole family without matching real errors)."""


class TransientFault(FaultError):
    """Injected fault the supervisor should classify retryable."""


class FatalFault(FaultError):
    """Injected fault the supervisor should classify fatal (engine
    rebuild + recovery-by-recompute)."""


class VirtualClock:
    """Injectable monotonic clock: ``clock()`` reads, ``advance()``
    moves time forward. Drives the gateway watchdog (and the engine's
    ``step_clock``) in tests/benches so hung-step classification and
    EWMA pacing are deterministic and instant."""

    def __init__(self, start=0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt):
        if dt < 0:
            raise ValueError(f"clock cannot go backwards (dt={dt})")
        self.t += float(dt)
        return self.t


class _Entry:
    __slots__ = ("kind", "message", "stall_s", "predicate", "remaining")

    def __init__(self, kind, message, stall_s, predicate, repeat):
        if kind not in ("transient", "fatal", "nan", "hung", "pool"):
            raise ValueError(f"unknown fault kind {kind!r}")
        self.kind = kind
        self.message = message
        self.stall_s = stall_s
        self.predicate = predicate
        self.remaining = None if repeat is None else int(repeat)


class FaultPlan:
    """Deterministic fault schedule; install as an engine's
    ``fault_hook`` (or pass as the gateway's ``fault_hook`` so rebuilt
    engines inherit it). ``clock`` is required only for ``"hung"``
    entries.

    Step indices are PLAN-global: the plan counts every hook firing —
    one per ``step()`` attempt, across engine rebuilds and
    pool-pressure retries — so a schedule replays identically no matter
    how recovery reshapes the engine underneath it. ``log`` records
    every fired fault as ``(plan_step, kind)`` for assertions.
    """

    def __init__(self, clock=None):
        self.clock = clock
        self._at = {}        # plan step -> [_Entry]
        self._poison = []    # [_Entry] with predicates
        self.step = 0        # hook firings so far (the plan-global index)
        self.log = []

    # ---------------------------------------------------------- authoring
    def at_step(self, step, kind="fatal", message=None, stall_s=None):
        """Fire one ``kind`` fault at plan step ``step`` (0-based)."""
        self._at.setdefault(int(step), []).append(
            _Entry(kind, message, stall_s, None, 1))
        return self

    def poison(self, predicate, kind="fatal", message=None, repeat=None):
        """Fire whenever ``predicate(seq)`` matches a slot-holding live
        sequence — every step it is resident, every readmission
        (``repeat=None`` = unbounded: the poisoned-request model)."""
        self._poison.append(_Entry(kind, message, None, predicate, repeat))
        return self

    # ---------------------------------------------------------- injection
    def install(self, engine):
        engine.fault_hook = self
        return self

    def _fire(self, engine, entry):
        self.log.append((self.step - 1, entry.kind))
        if entry.kind == "hung":
            if self.clock is None:
                raise ValueError(
                    "a 'hung' fault needs the plan's VirtualClock")
            self.clock.advance(entry.stall_s if entry.stall_s is not None
                               else 3600.0)
            return
        if entry.kind == "pool":
            from .kv_cache import PoolExhausted
            pool = getattr(engine.cache, "pool", None)
            # same occupancy snapshot the real raise site reports, so
            # the injected exception is representative of the condition
            # it simulates
            raise PoolExhausted(
                live_blocks=pool.num_used if pool is not None else 0,
                pinned_blocks=int((pool._ref > 0).sum())
                if pool is not None else 0,
                free_blocks=pool.num_free if pool is not None else 0,
                message=entry.message or "injected pool exhaustion")
        if entry.kind == "nan":
            self._corrupt(engine)
            raise FatalFault(entry.message
                             or "injected NaN corruption in KV storage")
        cls = TransientFault if entry.kind == "transient" else FatalFault
        raise cls(entry.message or f"injected {entry.kind} fault")

    @staticmethod
    def _corrupt(engine):
        """Overwrite the engine's KV device storage with NaNs, in place —
        real corruption, so recovery provably recomputes instead of
        reusing the poisoned cache. In place because the kernels hold the
        storage's raw device pointers: a new tensor would leave them
        reading the old, clean one."""
        import torch
        store = getattr(engine.cache, "pool", engine.cache)
        with torch.no_grad():
            store.k.fill_(float("nan"))
            store.v.fill_(float("nan"))

    def __call__(self, engine):
        """The hook the engine invokes at the top of each step
        attempt."""
        step = self.step
        self.step += 1
        for entry in self._poison:
            if entry.remaining is not None and entry.remaining <= 0:
                continue
            if any(s is not None and not s.done and entry.predicate(s)
                   for s in engine._slots):
                if entry.remaining is not None:
                    entry.remaining -= 1
                self._fire(engine, entry)
        for entry in self._at.get(step, ()):
            if entry.remaining is not None:
                if entry.remaining <= 0:
                    continue
                entry.remaining -= 1
            self._fire(engine, entry)

    @property
    def exhausted(self) -> bool:
        """True when every scheduled (non-poison) fault has fired."""
        return self.step > max(self._at) if self._at else True
