"""Priority classes for multi-tenant SLO serving (README "Multi-tenant
SLO serving"); the port's own copy of
``paddle_tpu/serving/policy/classes.py``.

A :class:`PriorityClass` names one tenant tier — ``latency`` /
``standard`` / ``batch`` in the canonical three-way split — with its
TTFT/TPOT SLO targets, its preemption rank, and the slot headroom the
scheduler reserves for it. A :class:`ClassTable` is the engine's closed
set of classes: every request resolves against it at validate time (an
unknown ``priority_class`` is a ValueError — the HTTP 400, never a
driver crash), and the default table is a SINGLE neutral class with no
targets, so an engine built without policy knobs schedules exactly like
the FIFO baseline and every banked stream stays byte-identical.

Classes are POLICY, not geometry: they change admission order and
preemption choices — host-side decisions — never a traced shape or a
jit key, so they join no jit-cache or fleet geometry tuple (the
``host_tier_bytes`` rule).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: the neutral class every request gets when no table is configured —
#: rank 0, no SLO targets, no reserved headroom
DEFAULT_CLASS_NAME = "standard"


@dataclass(frozen=True)
class PriorityClass:
    """One tenant tier.

    ``rank`` is the preemption authority (higher outranks lower: an
    admission-starved request of rank r may displace running work of
    rank < r, never >= r). ``ttft_slo_s`` / ``tpot_slo_s`` are the SLO
    targets in seconds (None = no target; a class with no TTFT target
    never triggers preemption). ``reserved_slots`` is admission
    headroom: that many KV slots are held back from other classes so a
    burst of best-effort work can never fully lock this class out of
    the engine."""
    name: str
    rank: int = 0
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None
    reserved_slots: int = 0

    def doc(self) -> dict:
        """Debug/banner row — the EFFECTIVE values, spelled in ms like
        the CLI knobs that set them."""
        return {
            "name": self.name,
            "rank": int(self.rank),
            "ttft_slo_ms": (None if self.ttft_slo_s is None
                            else round(self.ttft_slo_s * 1e3, 3)),
            "tpot_slo_ms": (None if self.tpot_slo_s is None
                            else round(self.tpot_slo_s * 1e3, 3)),
            "reserved_slots": int(self.reserved_slots),
        }


class ClassTable:
    """The engine's closed priority-class set.

    ``classes`` is an ordered list of :class:`PriorityClass` with
    unique names; ``default`` names the class an unlabeled request
    (``priority_class=None``) resolves to. ``aging_s`` is the
    anti-starvation quantum: every full ``aging_s`` a request waits in
    the queue raises its EFFECTIVE admission rank by one, so batch
    traffic always drains eventually no matter how steady the
    latency-class arrival stream is (aging moves admission order only —
    preemption authority always uses the true class rank, so an aged
    batch request never starts displacing anyone)."""

    def __init__(self, classes, default=None, aging_s=30.0):
        classes = list(classes)
        if not classes:
            raise ValueError("ClassTable needs at least one class")
        names = [c.name for c in classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names in {names}")
        for c in classes:
            for attr in ("ttft_slo_s", "tpot_slo_s"):
                v = getattr(c, attr)
                if v is not None and float(v) <= 0:
                    raise ValueError(
                        f"class {c.name!r}: {attr} must be > 0 or None, "
                        f"got {v}")
            if int(c.reserved_slots) < 0:
                raise ValueError(
                    f"class {c.name!r}: reserved_slots must be >= 0, "
                    f"got {c.reserved_slots}")
        if aging_s is not None and float(aging_s) <= 0:
            raise ValueError(f"aging_s must be > 0 or None, got {aging_s}")
        self.classes = tuple(classes)
        self._by_name = {c.name: c for c in classes}
        default = default if default is not None else classes[-1].name
        if default not in self._by_name:
            raise ValueError(
                f"default class {default!r} not in {sorted(self._by_name)}")
        self.default = default
        self.aging_s = None if aging_s is None else float(aging_s)

    # ------------------------------------------------------- constructors
    @classmethod
    def single(cls) -> "ClassTable":
        """The neutral table: one rank-0 class, no targets — the
        policy-off baseline every engine gets by default."""
        return cls([PriorityClass(DEFAULT_CLASS_NAME)])

    @classmethod
    def coerce(cls, value) -> "ClassTable":
        """Engine-knob coercion: None -> the neutral single-class
        table, a ClassTable passes through, a spec string/list parses
        (the CLI form)."""
        if value is None:
            return cls.single()
        if isinstance(value, cls):
            return value
        return cls.parse(value)

    @classmethod
    def parse(cls, classes, slo_ttft_ms=None, slo_tpot_ms=None,
              aging_s=30.0) -> "ClassTable":
        """Parse the CLI spec (``--classes`` / ``--slo-ttft-ms`` /
        ``--slo-tpot-ms``).

        ``classes`` is a comma list (or sequence) of
        ``name[*][:reserved_slots]`` entries, highest priority FIRST —
        ranks descend with list position. A ``*`` suffix on the name
        marks the default class for unlabeled requests (at most one;
        with no marker the LAST listed — lowest-priority — class is
        the default, so legacy traffic rides best-effort).
        ``slo_ttft_ms`` / ``slo_tpot_ms`` are aligned comma lists (or
        sequences) of per-class targets in milliseconds; 0 (or a
        missing tail entry) means no target for that class.

        Example: ``--classes "latency*:1,standard,batch"
        --slo-ttft-ms 250,1000,0`` — three classes, one slot reserved
        for ``latency``, 250 ms / 1 s TTFT targets on the top two
        tiers, unlabeled requests land on ``latency``.
        """
        if isinstance(classes, str):
            entries = [e.strip() for e in classes.split(",") if e.strip()]
        else:
            entries = [str(e).strip() for e in classes]
        if not entries:
            raise ValueError("--classes names no classes")

        def _targets(spec, what):
            if spec is None:
                return []
            if isinstance(spec, str):
                parts = [p.strip() for p in spec.split(",")]
            else:
                parts = list(spec)
            out = []
            for p in parts:
                v = float(p) if p not in ("", None) else 0.0
                if v < 0:
                    raise ValueError(f"{what} entries must be >= 0 "
                                     f"(0 = no target), got {v}")
                out.append(v / 1e3 if v else None)
            if len(out) > len(entries):
                raise ValueError(
                    f"{what} names {len(out)} targets for "
                    f"{len(entries)} classes")
            return out

        ttft = _targets(slo_ttft_ms, "--slo-ttft-ms")
        tpot = _targets(slo_tpot_ms, "--slo-tpot-ms")
        built, default = [], None
        for i, entry in enumerate(entries):
            name, _, res = entry.partition(":")
            name = name.strip()
            if name.endswith("*"):
                name = name[:-1].strip()
                if default is not None:
                    raise ValueError(
                        f"--classes marks two defaults "
                        f"({default!r} and {name!r})")
                default = name
            if not name or not name.replace("-", "").replace(
                    "_", "").isalnum():
                raise ValueError(f"bad class name {entry!r}")
            built.append(PriorityClass(
                name=name,
                rank=len(entries) - 1 - i,
                ttft_slo_s=ttft[i] if i < len(ttft) else None,
                tpot_slo_s=tpot[i] if i < len(tpot) else None,
                reserved_slots=int(res) if res.strip() else 0))
        return cls(built, default=default, aging_s=aging_s)

    # ------------------------------------------------------------ queries
    @property
    def active(self) -> bool:
        """Whether this table changes ANY scheduling decision: more
        than one class, any SLO target, or any reserved headroom. The
        neutral single-class table is inactive — the engine keeps the
        plain FIFO scheduler and every baseline stays byte-identical."""
        return (len(self.classes) > 1
                or any(c.ttft_slo_s is not None or c.tpot_slo_s is not None
                       or c.reserved_slots for c in self.classes))

    def resolve(self, name) -> PriorityClass:
        """The class for one request's ``priority_class`` (None -> the
        default class). Raises ValueError on an unknown name — the
        submit-time 400, validated on the caller's thread."""
        if name is None:
            return self._by_name[self.default]
        try:
            return self._by_name[str(name)]
        except KeyError:
            raise ValueError(
                f"unknown priority_class {name!r}; this engine serves "
                f"{sorted(self._by_name)}") from None

    def __iter__(self):
        return iter(self.classes)

    def __len__(self):
        return len(self.classes)

    def doc(self) -> list:
        """The EFFECTIVE class table (banner / ``/debug`` surfaces):
        one row per class plus the default marker."""
        return [dict(c.doc(), default=(c.name == self.default))
                for c in self.classes]

    def __repr__(self):
        return (f"ClassTable({[c.name for c in self.classes]}, "
                f"default={self.default!r})")
