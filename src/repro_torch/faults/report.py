"""MTTD / MTTR accounting from the trace timeline.

The injector, detector and recovery path all emit onto the PR-6 trace
recorder, so resilience metrics are *derived from the same artifact*
the rest of the stack exports — no side channel to drift out of sync:

* **MTTD** (mean time to detect): ``fault.inject`` → the target's
  first ``detector.suspect`` — when the controller first knows
  something is wrong.
* **MTTR** (mean time to recover): ``fault.inject`` → the fleet is
  re-planned around the loss — the first ``placement.decide`` after
  the eviction (or the eviction itself when placement is off, since
  eviction synchronously falls affected requesters back to local).

Only *silence* faults (crash/freeze) have a detection story; the other
kinds degrade service without killing the heartbeat and are scored by
the benchmark's goodput ratio instead.

Since the paging PR the summary also audits **live migration**: every
``req.migrate`` instant is folded into a ``migrations`` list, and
``migrated_reprefills`` counts migrated requests that nevertheless
showed up in a later ``engine.prefill`` — the zero-re-prefill claim,
checked against the same trace artifact.

The SLO tracker also lands on this timeline: ``slo_burns`` counts
``slo.burn`` window instants and ``slo_pages`` counts ``slo.page``
engagement edges, so a chaos report shows whether the injected faults
actually burned the error budget."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .injector import SILENT_KINDS, FaultSpec


def _ts(e) -> float:
    return e.sim_s if e.sim_s is not None else e.wall_s


@dataclass(frozen=True)
class FaultOutcome:
    """One injected fault's detection/recovery timeline (``None`` stamps
    mean the stage never happened inside the observed window)."""
    kind: str
    target: str
    injected_s: float
    suspected_s: Optional[float] = None
    dead_s: Optional[float] = None
    evicted_s: Optional[float] = None
    recovered_s: Optional[float] = None

    @property
    def mttd_s(self) -> Optional[float]:
        return (None if self.suspected_s is None
                else self.suspected_s - self.injected_s)

    @property
    def mttr_s(self) -> Optional[float]:
        return (None if self.recovered_s is None
                else self.recovered_s - self.injected_s)

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "target": self.target,
                "injected_s": self.injected_s,
                "suspected_s": self.suspected_s, "dead_s": self.dead_s,
                "evicted_s": self.evicted_s,
                "recovered_s": self.recovered_s,
                "mttd_s": self.mttd_s, "mttr_s": self.mttr_s}


def summarize_faults(events: Sequence) -> Dict:
    """Fold a recorder's event list into per-fault outcomes + rollups.

    ``events`` is ``TraceRecorder.events`` (or any sequence of objects
    with ``name``/``args``/``sim_s``/``wall_s``).  Returns a dict ready
    for JSON: ``outcomes`` rows plus aggregate mean/max MTTD and MTTR
    over the silence faults that were detected."""
    injects: List = []
    suspects: Dict[str, List[float]] = {}
    deads: Dict[str, List[float]] = {}
    evicts: Dict[str, List[float]] = {}
    decides: List[float] = []
    migrates: List[Dict] = []
    prefills: List = []     # (ts, rids) of every engine.prefill begin
    slo_burns = 0
    slo_pages = 0
    for e in events:
        args = e.args or {}
        if e.name == "fault.inject":
            injects.append(e)
        elif e.name == "detector.suspect":
            suspects.setdefault(args.get("device"), []).append(_ts(e))
        elif e.name == "detector.dead":
            deads.setdefault(args.get("device"), []).append(_ts(e))
        elif e.name == "fleet.evict":
            evicts.setdefault(args.get("device"), []).append(_ts(e))
        elif e.name == "placement.decide":
            decides.append(_ts(e))
        elif e.name == "req.migrate":
            migrates.append({"rid": args.get("rid"),
                             "src": args.get("src"),
                             "dst": args.get("dst"),
                             "reprefill": bool(args.get("reprefill")),
                             "ts_s": _ts(e)})
        elif e.name == "engine.prefill" and getattr(e, "ph", "B") == "B":
            prefills.append((_ts(e), args.get("rids") or []))
        elif e.name == "slo.burn":
            slo_burns += 1
        elif e.name == "slo.page":
            slo_pages += 1

    def first_after(times: Optional[List[float]], t0: float
                    ) -> Optional[float]:
        if not times:
            return None
        later = [t for t in times if t >= t0]
        return min(later) if later else None

    outcomes: List[FaultOutcome] = []
    for e in injects:
        args = e.args or {}
        kind, target, t0 = args.get("kind"), args.get("target"), _ts(e)
        if kind not in SILENT_KINDS:
            outcomes.append(FaultOutcome(kind, target, t0))
            continue
        sus = first_after(suspects.get(target), t0)
        ded = first_after(deads.get(target), t0)
        evi = first_after(evicts.get(target), t0)
        rec = first_after(decides, evi) if evi is not None else None
        outcomes.append(FaultOutcome(
            kind, target, t0, suspected_s=sus, dead_s=ded,
            evicted_s=evi, recovered_s=rec if rec is not None else evi))

    # the zero-re-prefill audit: a migrated rid re-entering any
    # engine.prefill *after* its migration means the thaw fell back
    reprefilled = 0
    for m in migrates:
        hit = any(ts >= m["ts_s"] and m["rid"] in rids
                  for ts, rids in prefills)
        m["reprefill"] = m["reprefill"] or hit
        reprefilled += int(m["reprefill"])

    mttds = [o.mttd_s for o in outcomes if o.mttd_s is not None]
    mttrs = [o.mttr_s for o in outcomes if o.mttr_s is not None]
    silent = [o for o in outcomes if o.kind in SILENT_KINDS]
    return {
        "outcomes": [o.to_dict() for o in outcomes],
        "faults": len(outcomes),
        "silent_faults": len(silent),
        "detected": len(mttds),
        "mean_mttd_s": sum(mttds) / len(mttds) if mttds else None,
        "max_mttd_s": max(mttds) if mttds else None,
        "mean_mttr_s": sum(mttrs) / len(mttrs) if mttrs else None,
        "max_mttr_s": max(mttrs) if mttrs else None,
        "migrations": migrates,
        "migrated_requests": len(migrates),
        "migrated_reprefills": reprefilled,
        "slo_burns": slo_burns,
        "slo_pages": slo_pages,
    }


def schedule_to_json(schedule: Sequence[FaultSpec]) -> List[Dict]:
    """Serialize a schedule for the benchmark artifact."""
    return [{"kind": f.kind, "target": f.target, "at_s": f.at_s,
             "duration_s": f.duration_s, "magnitude": f.magnitude}
            for f in schedule]
