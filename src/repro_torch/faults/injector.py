"""Deterministic fault injection against a running FleetController.

A fault schedule is a list of :class:`FaultSpec` rows — what breaks,
when (on the simulated fleet clock), for how long, how badly.
:func:`random_schedule` draws one from a seed, so a chaos run is
reproducible from ``(fleet, horizon, seed)`` alone.  The
:class:`FaultInjector` arms a schedule onto a controller as clock
callbacks (the same min-heap that drives device wakes), applies each
fault when its time comes, and automatically clears time-bounded ones.

Fault taxonomy (``FAULT_KINDS``):

* ``crash`` — the device stops waking, permanently; its state machine
  must be *discovered* dead by the detector.
* ``freeze`` — stops waking for ``duration_s`` but holds state, then
  resumes (the flapping case quarantine exists for).
* ``link_degrade`` — the link between two sites loses ``magnitude``×
  bandwidth and gains ``magnitude``× RTT (``target="siteA|siteB"``).
* ``partition`` — the site pair's link collapses to ~zero bandwidth.
* ``telemetry_loss`` — the device's reports are dropped with
  probability ``magnitude``.
* ``telemetry_delay`` — reports arrive ``magnitude`` seconds late.
* ``telemetry_corrupt`` — observed latencies are scaled ``magnitude``×
  before reporting (a lying sensor).
* ``straggler`` — DVFS collapse: the device's effective derate is
  capped at ``magnitude`` (< 1), slowing wakes and raw latency.
* ``load_spike`` — hosted-load spike: the member is marked
  ``magnitude`` busy in the placer (requires placement).
* ``oom`` — the device's serving engine fails its next ``magnitude``
  admissions with an OOM (requires an attached engine).

Everything lands on the trace timeline as ``fault.inject`` /
``fault.clear`` instants, so MTTD/MTTR are measurable from the same
artifact the rest of the stack already exports.

The module deliberately imports nothing from ``repro_torch.fleet`` at module
scope (the controller imports the detector from this package; keeping
injector → fleet references runtime-only avoids the cycle)."""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

CRASH = "crash"
FREEZE = "freeze"
LINK_DEGRADE = "link_degrade"
PARTITION = "partition"
TELEMETRY_LOSS = "telemetry_loss"
TELEMETRY_DELAY = "telemetry_delay"
TELEMETRY_CORRUPT = "telemetry_corrupt"
STRAGGLER = "straggler"
LOAD_SPIKE = "load_spike"
OOM = "oom"

FAULT_KINDS = (CRASH, FREEZE, LINK_DEGRADE, PARTITION, TELEMETRY_LOSS,
               TELEMETRY_DELAY, TELEMETRY_CORRUPT, STRAGGLER, LOAD_SPIKE,
               OOM)

# kinds whose target is a "siteA|siteB" pair rather than a device id
LINK_KINDS = (LINK_DEGRADE, PARTITION)
# kinds the heartbeat detector is expected to discover (silence faults)
SILENT_KINDS = (CRASH, FREEZE)


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.  ``duration_s=0`` means permanent;
    ``magnitude`` is kind-specific (see module docstring)."""
    kind: str
    target: str
    at_s: float
    duration_s: float = 0.0
    magnitude: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")

    @property
    def sites(self) -> Tuple[str, str]:
        """The site pair of a link fault (``target="a|b"``)."""
        a, _, b = self.target.partition("|")
        return (a, b)


@dataclass(frozen=True)
class TelemetryFault:
    """Active telemetry corruption on one device's reporting path."""
    loss_p: float = 0.0            # drop probability per report
    delay_s: float = 0.0           # extra arrival latency per report
    corrupt_scale: float = 1.0     # observed-latency multiplier


def random_schedule(devices: Sequence, horizon_s: float, seed: int, *,
                    n_faults: int = 4,
                    kinds: Sequence[str] = (CRASH, FREEZE, STRAGGLER,
                                            TELEMETRY_LOSS, PARTITION),
                    protect: Sequence[str] = ()) -> List[FaultSpec]:
    """Draw a reproducible fault schedule for a fleet.

    ``devices`` are :class:`~repro_torch.fleet.registry.DeviceSpec`-likes
    (``.device_id`` + ``.site`` are all that is read); ``protect``
    lists device ids never targeted (e.g. the requester a test asserts
    goodput for).  Injection times land in the middle 60% of the
    horizon so warmup calibration and the final drain stay fault-free
    enough to measure against."""
    rng = random.Random(seed)
    eligible = [d for d in devices if d.device_id not in protect]
    if not eligible:
        raise ValueError("no eligible fault targets (all protected)")
    sites = sorted({d.site for d in devices})
    out: List[FaultSpec] = []
    for _ in range(n_faults):
        kind = rng.choice(list(kinds))
        at = (0.2 + 0.6 * rng.random()) * horizon_s
        dur = (0.1 + 0.2 * rng.random()) * horizon_s
        if kind in LINK_KINDS:
            if len(sites) < 2:
                kind = FREEZE       # single-site fleet: nothing to cut
            else:
                a, b = rng.sample(sites, 2)
                mag = 8.0 + rng.random() * 8.0 \
                    if kind == LINK_DEGRADE else 1.0
                out.append(FaultSpec(kind, f"{a}|{b}", at, dur, mag))
                continue
        target = rng.choice(eligible).device_id
        if kind == CRASH:
            out.append(FaultSpec(kind, target, at, 0.0))
        elif kind == FREEZE:
            out.append(FaultSpec(kind, target, at, dur))
        elif kind == STRAGGLER:
            out.append(FaultSpec(kind, target, at, dur,
                                 magnitude=0.1 + 0.2 * rng.random()))
        elif kind == LOAD_SPIKE:
            out.append(FaultSpec(kind, target, at, dur,
                                 magnitude=0.7 + 0.25 * rng.random()))
        elif kind == TELEMETRY_LOSS:
            out.append(FaultSpec(kind, target, at, dur,
                                 magnitude=0.3 + 0.6 * rng.random()))
        elif kind == TELEMETRY_DELAY:
            out.append(FaultSpec(kind, target, at, dur,
                                 magnitude=0.5 + rng.random()))
        elif kind == TELEMETRY_CORRUPT:
            out.append(FaultSpec(kind, target, at, dur,
                                 magnitude=2.0 + 3.0 * rng.random()))
        elif kind == OOM:
            out.append(FaultSpec(kind, target, at, 0.0,
                                 magnitude=float(rng.randint(1, 3))))
    out.sort(key=lambda f: (f.at_s, f.kind, f.target))
    return out


class FaultInjector:
    """Arms a fault schedule onto a live controller's event clock.

    ``arm()`` registers every fault as a ``schedule_at`` callback;
    faults with a ``duration_s`` also register their clearing.  The
    ``applied``/``cleared`` logs record what actually fired (a fault
    targeting a device that crashed earlier is skipped, and logged as
    such in the trace)."""

    def __init__(self, controller, schedule: Sequence[FaultSpec]):
        self.ctl = controller
        self.schedule = list(schedule)
        self.applied: List[FaultSpec] = []
        self.cleared: List[FaultSpec] = []
        self.skipped: List[FaultSpec] = []
        # saved link overrides so clears restore, not reset
        self._saved_links: Dict[Tuple[str, str], Optional[object]] = {}
        self._armed = False

    def arm(self) -> "FaultInjector":
        if self._armed:
            raise RuntimeError("schedule already armed")
        self._armed = True
        for f in self.schedule:
            self.ctl.schedule_at(f.at_s, lambda f=f: self._apply(f))
            if f.duration_s > 0:
                self.ctl.schedule_at(f.at_s + f.duration_s,
                                     lambda f=f: self._clear(f))
        return self

    # ------------------------------------------------------------ events ---
    def _emit(self, name: str, f: FaultSpec, **extra) -> None:
        rec = self.ctl.recorder
        if rec.enabled:
            rec.instant(name, pid="fleet", tid="faults", cat="fleet",
                        args={"kind": f.kind, "target": f.target,
                              "magnitude": f.magnitude, **extra})

    # ------------------------------------------------------------- apply ---
    def _apply(self, f: FaultSpec) -> None:
        ctl = self.ctl
        if f.kind in LINK_KINDS:
            topo = self._topology()
            if topo is None:
                self.skipped.append(f)
                self._emit("fault.skip", f, why="no topology")
                return
            self._degrade_link(topo, f)
        elif f.kind in (CRASH, FREEZE):
            if not ctl.device_is_up(f.target):
                self.skipped.append(f)
                self._emit("fault.skip", f, why="already down")
                return
            ctl.fail_device(f.target, mode=f.kind)
        elif f.kind == STRAGGLER:
            ctl.set_derate_cap(f.target, f.magnitude)
        elif f.kind == LOAD_SPIKE:
            if getattr(ctl, "placer", None) is None:
                self.skipped.append(f)
                self._emit("fault.skip", f, why="no placement")
                return
            ctl.inject_load(f.target, f.magnitude)
        elif f.kind == TELEMETRY_LOSS:
            ctl.set_telemetry_fault(f.target,
                                    TelemetryFault(loss_p=f.magnitude))
        elif f.kind == TELEMETRY_DELAY:
            ctl.set_telemetry_fault(f.target,
                                    TelemetryFault(delay_s=f.magnitude))
        elif f.kind == TELEMETRY_CORRUPT:
            ctl.set_telemetry_fault(
                f.target, TelemetryFault(corrupt_scale=f.magnitude))
        elif f.kind == OOM:
            eng = ctl.engine_of(f.target)
            if eng is None:
                self.skipped.append(f)
                self._emit("fault.skip", f, why="no engine")
                return
            eng.inject_oom(int(f.magnitude))
        self.applied.append(f)
        self._emit("fault.inject", f, duration_s=f.duration_s)

    def _clear(self, f: FaultSpec) -> None:
        if f not in self.applied:
            return                     # never applied → nothing to clear
        ctl = self.ctl
        if f.kind in LINK_KINDS:
            topo = self._topology()
            if topo is not None:
                self._restore_link(topo, f)
        elif f.kind == FREEZE:
            ctl.thaw_device(f.target)
        elif f.kind == STRAGGLER:
            ctl.set_derate_cap(f.target, None)
        elif f.kind == LOAD_SPIKE:
            ctl.inject_load(f.target, 0.0)
        elif f.kind in (TELEMETRY_LOSS, TELEMETRY_DELAY,
                        TELEMETRY_CORRUPT):
            ctl.set_telemetry_fault(f.target, None)
        self.cleared.append(f)
        self._emit("fault.clear", f)

    # -------------------------------------------------------------- links --
    def _topology(self):
        placer = getattr(self.ctl, "placer", None)
        return placer.topology if placer is not None else None

    @staticmethod
    def _link_key(f: FaultSpec) -> Tuple[str, str]:
        a, b = f.sites
        return (a, b) if a <= b else (b, a)

    def _degrade_link(self, topo, f: FaultSpec) -> None:
        from repro_torch.fleet.placement.topology import LinkSpec
        key = self._link_key(f)
        if key not in self._saved_links:
            self._saved_links[key] = topo.overrides.get(key)
        base = topo.link(*key)
        if f.kind == PARTITION:
            broken = LinkSpec(bandwidth_bytes_s=1.0, rtt_s=3600.0,
                              kind=base.kind)
        else:
            m = max(f.magnitude, 1.0)
            broken = LinkSpec(bandwidth_bytes_s=base.bandwidth_bytes_s / m,
                              rtt_s=base.rtt_s * m, kind=base.kind)
        topo.overrides[key] = broken
        self._schedule_resweep()

    def _restore_link(self, topo, f: FaultSpec) -> None:
        key = self._link_key(f)
        prior = self._saved_links.pop(key, None)
        if prior is None:
            topo.overrides.pop(key, None)
        else:
            topo.overrides[key] = prior
        self._schedule_resweep()

    def _schedule_resweep(self) -> None:
        """A link change is placement-relevant NOW, not at the next
        periodic sweep."""
        sched = getattr(self.ctl, "_schedule_placement", None)
        if sched is not None:
            sched(self.ctl.now_s)
