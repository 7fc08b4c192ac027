"""Fleet-wide rollups: per-tier SLA/violation/energy + calibration gain.

Turns a :class:`FleetController` run into the numbers the paper reports
per platform class — latency distributions, SLA violation rates, energy
totals — plus the before/after prediction error (MAPE) that quantifies
what the crowd-telemetry feedback loop bought.  Under event-driven
stepping the report also surfaces the *asynchrony* itself: per-device
tick counts (fast devices accumulate strictly more wakes over one
horizon) and the fleet's wall-clock skew (how far apart devices' last
wakes landed on the simulated clock).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from .controller import FleetController


@dataclass
class TierSummary:
    """One hardware tier's rollup over a fleet run: device/tick counts
    (including the min/max per-device tick spread that event stepping
    introduces), latency distribution, SLA violations, energy, and the
    raw-vs-calibrated prediction error."""
    tier: str
    devices: int
    ticks: int
    mean_latency_s: float
    p95_latency_s: float
    violations: int
    violation_rate: float
    energy_j: float
    # raw analytic predictions vs observed, across ALL of the tier's
    # measurement channels — for a tier mixing engine-backed (wall-time)
    # and simulated devices this is dominated by the engine records'
    # genuinely huge raw error, which is exactly the gap the per-channel
    # calibration (mape_after) closes
    mape_before: float
    mape_after: float             # calibrated predictions vs observed
    min_device_ticks: int = 0     # slowest member's wake count
    max_device_ticks: int = 0     # fastest member's wake count


@dataclass
class FleetReport:
    """A rendered-ready summary of one fleet run: per-tier
    :class:`TierSummary` rows, fleet totals, the first-half/second-half
    violation split (halved on the fleet clock, so it is meaningful for
    both lockstep and event stepping), per-device tick counts, and
    ``clock_skew_s`` — the spread between the earliest and latest final
    wake across devices (0 under lockstep; under event stepping, how far
    the fleet's members drifted apart over the horizon)."""
    tiers: List[TierSummary]
    total_ticks: int
    total_violations: int
    total_energy_j: float
    violations_first_half: int
    violations_second_half: int
    device_ticks: Dict[str, int] = field(default_factory=dict)
    clock_skew_s: float = 0.0
    # cross-device placement (empty when the fleet runs without the
    # placer): requester -> human-readable current placement, plus how
    # many re-placement sweeps the controller ran
    placements: Dict[str, str] = field(default_factory=dict)
    placement_events: int = 0

    def render(self) -> str:
        hdr = (f"{'tier':8s} {'dev':>4s} {'ticks':>6s} {'t/dev':>9s} "
               f"{'mean_lat':>10s} {'p95_lat':>10s} {'viol':>5s} "
               f"{'rate':>6s} {'energy_J':>10s} {'MAPE_raw':>9s} "
               f"{'MAPE_cal':>9s}")
        lines = [hdr, "-" * len(hdr)]
        for t in self.tiers:
            lines.append(
                f"{t.tier:8s} {t.devices:4d} {t.ticks:6d} "
                f"{t.min_device_ticks:4d}-{t.max_device_ticks:<4d} "
                f"{t.mean_latency_s:10.4g} {t.p95_latency_s:10.4g} "
                f"{t.violations:5d} {t.violation_rate:6.1%} "
                f"{t.energy_j:10.4g} {t.mape_before:9.1%} "
                f"{t.mape_after:9.1%}")
        lines.append(
            f"total: ticks={self.total_ticks} "
            f"violations={self.total_violations} "
            f"(1st half {self.violations_first_half} → "
            f"2nd half {self.violations_second_half}) "
            f"energy={self.total_energy_j:.4g} J "
            f"clock_skew={self.clock_skew_s:.3g}s")
        if self.placements:
            lines.append(f"placements ({self.placement_events} sweeps):")
            for rid in sorted(self.placements):
                lines.append(f"  {self.placements[rid]}")
        return "\n".join(lines)


def _mape_after(ctl: FleetController, tier: str) -> float:
    """Calibrated error uses the correction each device's loop would
    actually consult — tier-pooled under crowd sharing, per-device
    otherwise — always on the record's own measurement channel."""
    if ctl.share_calibration:
        return ctl.telemetry.mape(tier=tier, per_tier_calibration=True)
    return ctl.telemetry.mape(tier=tier, per_device_calibration=True)


def fleet_report(ctl: FleetController) -> FleetReport:
    """Roll a controller's records up into a :class:`FleetReport` (see
    the class docstrings for field semantics)."""
    recs = ctl.records
    tiers = sorted({r.tier for r in recs})
    device_ticks = ctl.tick_counts
    tier_of = {spec.device_id: spec.tier for spec in ctl.devices}
    summaries = []
    for tier in tiers:
        rs = [r for r in recs if r.tier == tier]
        lats = np.array([r.observed_s for r in rs])
        viol = sum(1 for r in rs if r.violated)
        tier_ticks = [n for did, n in device_ticks.items()
                      if tier_of.get(did) == tier]
        summaries.append(TierSummary(
            tier=tier,
            devices=len({r.device_id for r in rs}),
            ticks=len(rs),
            mean_latency_s=float(lats.mean()) if len(lats) else 0.0,
            p95_latency_s=float(np.percentile(lats, 95)) if len(lats)
            else 0.0,
            violations=viol,
            violation_rate=viol / max(len(rs), 1),
            energy_j=float(sum(r.observed_energy_j for r in rs)),
            mape_before=ctl.telemetry.mape(tier=tier),
            mape_after=_mape_after(ctl, tier),
            min_device_ticks=min(tier_ticks, default=0),
            max_device_ticks=max(tier_ticks, default=0)))
    # halve the run on the fleet clock: under lockstep timestamps equal
    # global ticks, so this reproduces the old tick-based split exactly
    max_ts = max((r.timestamp_s for r in recs), default=0.0)
    mid_ts = max_ts / 2.0
    last_wake = {}
    for r in recs:
        last_wake[r.device_id] = max(last_wake.get(r.device_id, 0.0),
                                     r.timestamp_s)
    skew = (max(last_wake.values()) - min(last_wake.values())
            if last_wake else 0.0)
    placements = {}
    if ctl.placer is not None:
        placements = {rid: dec.describe()
                      for rid, dec in ctl.placer.decisions.items()}
    # fleet totals are views over the controller's metrics registry
    # (incremented exactly where records are appended, so they always
    # agree with a records-derived sum — test_obs.py pins this)
    return FleetReport(
        tiers=summaries,
        total_ticks=len(recs),
        total_violations=ctl.metrics.counter("fleet.violations").value,
        total_energy_j=float(
            ctl.metrics.counter("fleet.energy_j").value),
        violations_first_half=ctl.violations(last_s=mid_ts),
        violations_second_half=ctl.violations()
        - ctl.violations(last_s=mid_ts),
        device_ticks=device_ticks,
        clock_skew_s=skew,
        placements=placements,
        placement_events=ctl.placement_events)
