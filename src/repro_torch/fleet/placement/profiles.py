"""Live DeviceProfiles: the fleet's calibrated state as a device pool.

The static pools in ``repro_torch.offload.placer`` describe hypothetical
hardware; a running fleet knows better.  :func:`synthesize_profile`
turns one member's :class:`~repro_torch.fleet.registry.DeviceSpec` capability
envelope into an offloading :class:`~repro_torch.offload.placer.DeviceProfile`
corrected by everything the fleet has *measured*:

* the ``(tier, channel)`` telemetry calibration — a tier whose silicon
  runs 1.4× slower than the analytic model predicts yields a profile
  with 1.4× fewer achievable FLOP/s, so the placement DP sees the same
  reality the calibrated evaluator does;
* the member's current context — DVFS derate, competing processes, free
  memory fraction;
* load the member is already carrying: its own serving work
  (``own_load``, e.g. from an attached engine's step-time EWMA) and the
  partitions it hosts *for other members* (multi-tenant accounting — a
  jetson helping two phones looks slower to the third).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.monitor import ResourceContext
from repro_torch.core.profiler import Calibration
from repro_torch.fleet.registry import DeviceSpec
from repro_torch.offload.placer import NO_NEXT_LINK, DeviceProfile

# a host never surrenders its whole budget to tenants/backlog: the
# synthesized profile keeps at least this fraction of derated capability
MIN_CAPACITY_FRAC = 0.1


@dataclass
class MemberState:
    """What the placer knows about one fleet member right now.

    ``ctx`` is the member's last observed resource context; ``own_load``
    is the fraction of its compute already consumed by local work (an
    engine-backed device reports its serving duty cycle here);
    ``hosted`` maps requester device-id → compute fraction this member
    spends hosting that requester's offloaded partitions."""
    spec: DeviceSpec
    ctx: ResourceContext = field(default_factory=ResourceContext)
    calibration: Calibration = field(default_factory=Calibration)
    own_load: float = 0.0
    hosted: Dict[str, float] = field(default_factory=dict)
    alive: bool = True
    # flap hysteresis: until this fleet-clock instant the member is not
    # offered as a helper for NEW placements (existing chains through it
    # keep working — it is alive, just on probation after blinking)
    quarantined_until_s: float = 0.0

    def tenant_load(self, excluding: Optional[str] = None) -> float:
        """Compute fraction consumed hosting *other* requesters — the
        multi-tenant term a prospective requester must discount."""
        return sum(f for rid, f in self.hosted.items() if rid != excluding)

    def busy_frac(self, excluding: Optional[str] = None) -> float:
        """Total utilization a new requester would contend with."""
        return min(0.95, self.own_load + self.tenant_load(excluding))


def synthesize_profile(state: MemberState, *,
                       for_requester: Optional[str] = None,
                       link_bw: float = NO_NEXT_LINK) -> DeviceProfile:
    """One member's live offloading profile.

    Capability = spec peaks × chips, derated by (a) the context's DVFS /
    competing-process factor, (b) the crowd-calibrated latency scale
    (observed ≈ scale × predicted ⇒ the device achieves 1/scale of its
    analytic FLOP/s), and (c) the busy fraction from its own serving
    work plus partitions hosted for members other than
    ``for_requester``.  Memory = HBM × headroom × the context's free
    fraction.  ``link_bw`` is the bandwidth toward the NEXT device in
    whatever chain the caller is assembling (the topology decides it)."""
    spec, ctx = state.spec, state.ctx
    peak = spec.hw.peak_flops * spec.chips
    flops = ctx.effective_flops(peak)
    scale = state.calibration.latency_scale \
        if state.calibration.samples else 1.0
    flops /= max(scale, 1e-3)
    free = max(1.0 - state.busy_frac(excluding=for_requester),
               MIN_CAPACITY_FRAC)
    flops *= free
    mem_bw = spec.hw.hbm_bw * spec.chips * free / max(scale, 1e-3)
    mem = spec.hw.hbm_bytes * spec.chips * spec.mem_headroom \
        * ctx.mem_free_frac
    return DeviceProfile(
        name=spec.device_id,
        flops=max(flops, 1.0),
        mem_bytes=max(mem, 0.0),
        mem_bw=max(mem_bw, 1.0),
        link_bw=link_bw,
        power_w=spec.hw.peak_w,
        kind="fleet")
