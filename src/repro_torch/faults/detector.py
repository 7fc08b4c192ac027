"""Heartbeat failure detector: suspect→dead on missed wakes.

The fleet's event scheduler already *is* a heartbeat source — every
device wake is a liveness proof.  :class:`HeartbeatDetector` tracks the
time since each device's last wake against a grace period scaled to
that device's own wake cadence (its tick-envelope ceiling plus any
engine step time), so a 1 Hz phone is not declared dead on a 4 Hz
server's schedule:

* **alive → suspect** after ``suspect_after`` missed periods — the
  device is still placed, but the controller notes the silence;
* **suspect → dead** after ``dead_after`` periods — the controller
  evicts it through the same path ``drop_device`` uses (failures are
  *discovered*, not announced);
* **suspect/dead → alive** on the next heartbeat — a *flap*.  Each flap
  doubles the device's quarantine window (capped), during which the
  placer will not select it as a helper: a blinking device must prove
  stability before it hosts anyone's layers again.

The detector is deliberately fleet-agnostic — ids, periods and clock
readings in, :class:`Transition` records out — so the chaos suite can
drive the state machine directly, without a controller."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

ALIVE, SUSPECT, DEAD = "alive", "suspect", "dead"
RECOVERED = "recovered"      # transition kind only, never a stored state


@dataclass(frozen=True)
class DetectorConfig:
    """Grace periods in multiples of each device's OWN wake period.

    ``suspect_after`` must exceed 1.0 with headroom — a healthy device
    goes exactly one period between beats, and derate can stretch a
    wake to its envelope ceiling.  ``quarantine_periods`` is the base
    readmission hold after a flap; each further flap doubles it up to
    ``flap_backoff_cap`` doublings' worth."""
    suspect_after: float = 2.5
    dead_after: float = 5.0
    quarantine_periods: float = 6.0
    flap_backoff_cap: float = 8.0

    def __post_init__(self):
        if not (1.0 < self.suspect_after < self.dead_after):
            raise ValueError(
                f"need 1 < suspect_after < dead_after, got "
                f"{self.suspect_after} / {self.dead_after}")


@dataclass(frozen=True)
class Transition:
    """One state-machine edge: who, to what, when, and how silent."""
    device_id: str
    state: str                     # SUSPECT | DEAD | RECOVERED
    at_s: float
    silent_s: float = 0.0          # time since last beat at transition
    flaps: int = 0
    quarantined_until_s: float = 0.0
    was: str = ALIVE               # state before the edge


@dataclass
class _Tracked:
    period_s: float                # this device's current wake period
    last_beat_s: float
    state: str = ALIVE
    flaps: int = 0
    quarantined_until_s: float = 0.0


class HeartbeatDetector:
    """Suspect→dead liveness tracking over explicit heartbeats."""

    def __init__(self, config: Optional[DetectorConfig] = None):
        self.cfg = config if config is not None else DetectorConfig()
        self._tracked: Dict[str, _Tracked] = {}
        # full edge history, in occurrence order (sweeps + recoveries)
        self.transitions: List[Transition] = []

    # ------------------------------------------------------- membership ----
    def track(self, device_id: str, period_s: float,
              now_s: float = 0.0) -> None:
        """Start watching a device; ``period_s`` is its expected wake
        interval (refreshed on every beat, so DVFS slowdowns stretch
        the grace window instead of tripping it)."""
        self._tracked[device_id] = _Tracked(
            period_s=max(period_s, 1e-9), last_beat_s=now_s)

    def untrack(self, device_id: str) -> None:
        """Stop watching (announced departure or trace exhaustion — an
        expected silence must not raise a false alarm)."""
        self._tracked.pop(device_id, None)

    def tracked(self) -> List[str]:
        return list(self._tracked)

    # -------------------------------------------------------- heartbeats ---
    def beat(self, device_id: str, now_s: float,
             period_s: Optional[float] = None) -> Optional[Transition]:
        """A liveness proof.  Returns a RECOVERED transition when the
        device was suspect/dead (a flap — quarantine doubles), else
        ``None``.  Unknown devices are ignored (evicted stragglers may
        still be mid-wake when the eviction lands)."""
        tr = self._tracked.get(device_id)
        if tr is None:
            return None
        if period_s is not None:
            tr.period_s = max(period_s, 1e-9)
        silent = now_s - tr.last_beat_s
        tr.last_beat_s = now_s
        if tr.state == ALIVE:
            return None
        was = tr.state
        tr.state = ALIVE
        tr.flaps += 1
        hold = (self.cfg.quarantine_periods * tr.period_s
                * min(2.0 ** (tr.flaps - 1), self.cfg.flap_backoff_cap))
        tr.quarantined_until_s = now_s + hold
        edge = Transition(device_id, RECOVERED, now_s, silent_s=silent,
                          flaps=tr.flaps,
                          quarantined_until_s=tr.quarantined_until_s,
                          was=was)
        self.transitions.append(edge)
        return edge

    def sweep(self, now_s: float) -> List[Transition]:
        """Advance every tracked device's state machine to ``now_s``.
        Returns the edges taken this sweep (a long-silent device can
        take alive→suspect and suspect→dead in one sweep — detection
        latency is then bounded by the sweep cadence, not doubled)."""
        out: List[Transition] = []
        for did, tr in self._tracked.items():
            silent = now_s - tr.last_beat_s
            if tr.state == ALIVE \
                    and silent > self.cfg.suspect_after * tr.period_s:
                tr.state = SUSPECT
                out.append(Transition(did, SUSPECT, now_s, silent_s=silent,
                                      flaps=tr.flaps, was=ALIVE))
            if tr.state == SUSPECT \
                    and silent > self.cfg.dead_after * tr.period_s:
                tr.state = DEAD
                out.append(Transition(did, DEAD, now_s, silent_s=silent,
                                      flaps=tr.flaps, was=SUSPECT))
        self.transitions.extend(out)
        return out

    # ---------------------------------------------------------- queries ----
    def state(self, device_id: str) -> str:
        tr = self._tracked.get(device_id)
        return tr.state if tr is not None else DEAD

    def flaps(self, device_id: str) -> int:
        tr = self._tracked.get(device_id)
        return tr.flaps if tr is not None else 0

    def quarantined_until(self, device_id: str) -> float:
        tr = self._tracked.get(device_id)
        return tr.quarantined_until_s if tr is not None else 0.0

    def quarantined(self, device_id: str, now_s: float) -> bool:
        return now_s < self.quarantined_until(device_id)
