"""Heterogeneous device registry (the "15 platforms" of paper §IV-A).

Each platform is a ``PlatformProfile``: a :class:`HardwareProfile` (the
roofline/Eq.1/Eq.2 substrate the profiler consumes) plus the resource
envelope the monitor projects shared scenarios through — battery
capacity, typical memory headroom, DVFS floor — and the *latent*
prediction error the analytic profiler makes on that silicon.  The
latent factors are ground truth for the telemetry simulation: the
profiler never sees them directly; it only observes their effect on
measured step timings, which is exactly the gap crowd-shared
calibration exists to close.

Tiers group platforms by capability class (heavy / medium / light);
devices of one tier share most of their systematic profiler bias (same
ISA family, same memory subsystem idioms), which is what makes
cross-device calibration transfer — the "crowd" in CrowdHMTware —
well-posed.
"""
from __future__ import annotations

import dataclasses
import random
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core.monitor import (ResourceContext, case_study_trace,
                                      shaped_trace)
from repro_torch.core.profiler import HardwareProfile, MOBILE_CPU

# The simulated fleet's TPU v5e slice.  Like every row of PLATFORMS below
# it is data of the simulated fleet, copied from the JAX package so that
# both packages step the same fleet: order-of-magnitude public specs, not
# measurements, and not this port's card.
TPU_V5E = HardwareProfile(
    name="tpu_v5e", peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
    hbm_bytes=16e9, idle_w=80.0, peak_w=220.0)

HEAVY, MEDIUM, LIGHT = "heavy", "medium", "light"
TIERS = (HEAVY, MEDIUM, LIGHT)

# Nominal seconds of simulated time between adaptation-loop wakes per
# tier.  Heavy silicon re-evaluates its deployment more often than a
# little-core phone: its monitor sampling, profiler sweep and apply step
# all cost a fraction of what they cost downmarket.  These set the
# *relative* tick rates of the event-driven fleet scheduler; absolute
# values are arbitrary simulated seconds.
TIER_TICK_S: Dict[str, float] = {HEAVY: 0.25, MEDIUM: 0.5, LIGHT: 1.0}

# site a device lives at unless build_fleet says otherwise — a
# single-site fleet is the legacy behavior (every peer one LAN hop away)
DEFAULT_SITE = "site0"


@dataclass(frozen=True)
class TickEnvelope:
    """Per-device bounds on the adaptation-loop wake period.

    ``nominal_s`` is the steady-state period between wakes (the tier's
    base rate scaled by :attr:`DeviceSpec.tick_scale`); ``min_s`` is the
    fastest the device is allowed to re-adapt (its nominal rate — a
    device never runs its loop faster than designed); ``max_s`` is the
    slowest it degrades to under a full DVFS throttle
    (``nominal_s / dvfs_floor``).  The event scheduler derives every
    next-wake time by clamping the DVFS-derated period into this
    envelope, then adding any measured execution latency on top."""
    nominal_s: float
    min_s: float
    max_s: float

    def clamp(self, period_s: float) -> float:
        """Bound a candidate wake period into [min_s, max_s]."""
        return min(max(period_s, self.min_s), self.max_s)


@dataclass(frozen=True)
class PlatformProfile:
    """One of the registry's hardware platforms."""
    platform: str
    tier: str
    hw: HardwareProfile
    battery_wh: float            # ∞-ish for wall-powered platforms
    mem_headroom: float          # fraction of hbm_bytes typically free
    dvfs_floor: float            # worst-case sustained clock derate
    chips: int = 1
    # systematic analytic-profiler bias on this platform (ground truth the
    # telemetry loop must discover; >1 = profiler is optimistic)
    latency_bias: float = 1.0
    energy_bias: float = 1.0


def _hw(name, flops, bw, link, mem, idle, peak) -> HardwareProfile:
    return HardwareProfile(name=name, peak_flops=flops, hbm_bw=bw,
                           ici_bw=link, hbm_bytes=mem, idle_w=idle,
                           peak_w=peak)


# The simulated catalog, copied from the JAX package row for row: ~15
# platforms spanning TPU pods down to little-core phone CPUs.  Numbers are
# order-of-magnitude public specs, not measurements: the fleet they make
# is simulated silicon, whatever card the port itself runs on.
PLATFORMS: Dict[str, PlatformProfile] = {p.platform: p for p in (
    # ---------------------------------------------------------- heavy -----
    PlatformProfile("tpu_v5e", HEAVY, TPU_V5E, 1e9, 0.85, 0.95, chips=4,
                    latency_bias=1.18, energy_bias=1.10),
    PlatformProfile("tpu_v4i", HEAVY,
                    _hw("tpu_v4i", 138e12, 615e9, 50e9, 8e9, 55, 175),
                    1e9, 0.85, 0.95, chips=4,
                    latency_bias=1.22, energy_bias=1.12),
    PlatformProfile("edge_server_a100", HEAVY,
                    _hw("edge_server_a100", 312e12, 1555e9, 25e9, 40e9,
                        100, 400),
                    1e9, 0.80, 0.90,
                    latency_bias=1.15, energy_bias=1.20),
    PlatformProfile("desktop_4090", HEAVY,
                    _hw("desktop_4090", 165e12, 1008e9, 8e9, 24e9, 60, 450),
                    1e9, 0.75, 0.90,
                    latency_bias=1.20, energy_bias=1.25),
    PlatformProfile("jetson_agx_orin", HEAVY,
                    _hw("jetson_agx_orin", 10.6e12, 204e9, 1e9, 64e9, 15, 60),
                    90.0, 0.70, 0.80,
                    latency_bias=1.25, energy_bias=1.15),
    # --------------------------------------------------------- medium -----
    PlatformProfile("jetson_orin_nano", MEDIUM,
                    _hw("jetson_orin_nano", 2.5e12, 68e9, 0.5e9, 8e9, 5, 15),
                    40.0, 0.60, 0.70,
                    latency_bias=1.38, energy_bias=1.30),
    PlatformProfile("apple_a17_npu", MEDIUM,
                    _hw("apple_a17_npu", 2.1e12, 51e9, 0.2e9, 8e9, 0.5, 8),
                    13.0, 0.55, 0.65,
                    latency_bias=1.35, energy_bias=1.28),
    PlatformProfile("snapdragon_8g3_npu", MEDIUM,
                    _hw("snapdragon_8g3_npu", 1.7e12, 77e9, 0.2e9, 12e9,
                        0.5, 7),
                    19.0, 0.55, 0.65,
                    latency_bias=1.42, energy_bias=1.33),
    PlatformProfile("mali_g720_gpu", MEDIUM,
                    _hw("mali_g720_gpu", 0.9e12, 60e9, 0.1e9, 8e9, 0.4, 6),
                    18.0, 0.50, 0.60,
                    latency_bias=1.45, energy_bias=1.35),
    PlatformProfile("raspberry_pi5", MEDIUM,
                    _hw("raspberry_pi5", 30e9, 17e9, 0.1e9, 8e9, 2.5, 12),
                    1e9, 0.65, 0.85,
                    latency_bias=1.40, energy_bias=1.25),
    # ---------------------------------------------------------- light -----
    PlatformProfile("snapdragon_8g3_cpu", LIGHT, dataclasses.replace(
        MOBILE_CPU, name="snapdragon_8g3_cpu", peak_flops=40e9, hbm_bw=9e9),
        19.0, 0.45, 0.55,
        latency_bias=1.60, energy_bias=1.45),
    PlatformProfile("dimensity_700_cpu", LIGHT, dataclasses.replace(
        MOBILE_CPU, name="dimensity_700_cpu", peak_flops=18e9, hbm_bw=6e9),
        16.0, 0.40, 0.50,
        latency_bias=1.68, energy_bias=1.50),
    PlatformProfile("pixel_6_cpu", LIGHT, dataclasses.replace(
        MOBILE_CPU, name="pixel_6_cpu", peak_flops=24e9, hbm_bw=7e9),
        17.0, 0.45, 0.55,
        latency_bias=1.62, energy_bias=1.48),
    PlatformProfile("raspberry_pi4", LIGHT, dataclasses.replace(
        MOBILE_CPU, name="raspberry_pi4", peak_flops=13e9, hbm_bw=4e9,
        hbm_bytes=4e9),
        1e9, 0.50, 0.75,
        latency_bias=1.55, energy_bias=1.40),
    PlatformProfile("cortex_a55_quad", LIGHT, dataclasses.replace(
        MOBILE_CPU, name="cortex_a55_quad", peak_flops=8e9, hbm_bw=3e9,
        hbm_bytes=1e9),
        10.0, 0.35, 0.45,
        latency_bias=1.72, energy_bias=1.55),
)}


def platforms_by_tier(tier: str) -> List[PlatformProfile]:
    """All registry platforms in one capability tier (``"heavy"``,
    ``"medium"`` or ``"light"``), in registry declaration order — the
    order :func:`build_fleet` round-robins over when instantiating a
    mixed fleet."""
    return [p for p in PLATFORMS.values() if p.tier == tier]


# ----------------------------------------------------------- device spec ---
@dataclass(frozen=True)
class DeviceSpec:
    """One concrete device in the fleet: a platform instance plus the
    per-unit silicon-lottery jitter on the platform's latent bias."""
    device_id: str
    platform: str
    tier: str
    hw: HardwareProfile
    chips: int
    battery_wh: float
    mem_headroom: float
    dvfs_floor: float
    latent_latency_factor: float      # true observed/predicted latency ratio
    latent_energy_factor: float
    trace_seed: int = 0
    # multiplier on the tier's nominal wake period — >1 slows this unit's
    # adaptation loop (a busy or degraded device); tests use it to pin an
    # artificially slow fleet member
    tick_scale: float = 1.0
    # physical location: devices sharing a site reach each other over the
    # LAN link of the fleet's SiteTopology; cross-site hops pay WAN cost.
    # Cross-device placement prefers idle same-site helpers.
    site: str = DEFAULT_SITE
    # how far the analytic accuracy proxy overshoots the *crowd-labeled*
    # task accuracy on this unit (ground truth for the accuracy telemetry
    # channel; the proxy never sees it directly)
    latent_accuracy_bias: float = 0.0

    @property
    def wall_powered(self) -> bool:
        return self.battery_wh >= 1e6

    @property
    def tick_envelope(self) -> TickEnvelope:
        """The device's wake-period bounds for the event-driven fleet
        scheduler: nominal period = tier base rate × ``tick_scale``,
        degrading at worst to ``nominal / dvfs_floor`` under throttle."""
        base = TIER_TICK_S[self.tier] * self.tick_scale
        return TickEnvelope(nominal_s=base, min_s=base,
                            max_s=base / max(self.dvfs_floor, 1e-3))

    @property
    def compile_domain(self) -> str:
        """Namespace for shared serving programs: compiled artifacts are
        platform/toolchain-specific, so devices of one platform can reuse
        each other's programs while cross-platform reuse is forbidden.
        The fleet compile cache keys on this."""
        return self.platform


def make_device(platform: str, index: int, seed: int = 0,
                site: str = DEFAULT_SITE) -> DeviceSpec:
    """Instantiate device ``index`` of a platform at ``site``.  The
    per-unit jitter is small (±5%) relative to the platform's systematic
    bias, so same-tier calibration transfers while still leaving a
    residual only per-device measurements could remove."""
    p = PLATFORMS[platform]
    # zlib.crc32, not hash(): str hashing is salted per-process and would
    # break cross-run determinism of the fleet
    phash = zlib.crc32(platform.encode())
    rng = random.Random((phash & 0xFFFF) * 1009 + index * 97 + seed)
    jit_l = 1.0 + rng.uniform(-0.05, 0.05)
    jit_e = 1.0 + rng.uniform(-0.05, 0.05)
    # proxy overshoot grows downmarket: heavy silicon runs closer to the
    # reference task pipeline the proxy was anchored on
    acc_base = {HEAVY: 0.015, MEDIUM: 0.03, LIGHT: 0.05}[p.tier]
    return DeviceSpec(
        device_id=f"{platform}#{index}",
        platform=platform, tier=p.tier, hw=p.hw, chips=p.chips,
        battery_wh=p.battery_wh, mem_headroom=p.mem_headroom,
        dvfs_floor=p.dvfs_floor,
        latent_latency_factor=p.latency_bias * jit_l,
        latent_energy_factor=p.energy_bias * jit_e,
        trace_seed=seed + index * 31 + (phash & 0xFF),
        site=site,
        latent_accuracy_bias=acc_base * (1.0 + rng.uniform(-0.3, 0.3)))


def build_fleet(n: int, seed: int = 0,
                tiers: Tuple[str, ...] = TIERS,
                sites: Tuple[str, ...] = (DEFAULT_SITE,)) -> List[DeviceSpec]:
    """A heterogeneous fleet of ``n`` devices, round-robin over every
    platform in the requested tiers (so any n ≥ #platforms covers all of
    them, and smaller fleets still mix tiers).  The pool interleaves
    tiers — heavy[0], medium[0], light[0], heavy[1], … — so even a
    3-device fleet spans all capability classes.  ``sites`` assigns each
    device a location round-robin (default: everyone at one site, i.e.
    every peer one LAN hop away)."""
    per_tier = [platforms_by_tier(t) for t in tiers]
    if not any(per_tier):
        raise ValueError(f"no platforms in tiers {tiers}")
    pool = []
    for i in range(max(len(ps) for ps in per_tier)):
        for ps in per_tier:
            if i < len(ps):
                pool.append(ps[i])
    counts: Dict[str, int] = {}
    fleet = []
    for i in range(n):
        p = pool[i % len(pool)]
        idx = counts.get(p.platform, 0)
        counts[p.platform] = idx + 1
        fleet.append(make_device(p.platform, idx, seed=seed,
                                 site=sites[i % len(sites)]))
    return fleet


# -------------------------------------------------------- per-device trace --
def device_trace(spec: DeviceSpec, n: int = 24,
                 base: Optional[Iterator[ResourceContext]] = None
                 ) -> Iterator[ResourceContext]:
    """The shared day-long scenario projected through this device's
    envelope.  Wall-powered devices don't drain; small batteries drain
    faster than the fleet-wide curve; weak coolers throttle harder but
    never below the platform's DVFS floor."""
    if base is None:
        base = case_study_trace(n, seed=spec.trace_seed)
    battery_scale = 1.0 if spec.wall_powered else min(
        1.0, spec.battery_wh / 20.0 + 0.35)
    return shaped_trace(
        base,
        battery_scale=battery_scale,
        mem_scale=spec.mem_headroom / 0.85,
        derate_floor=spec.dvfs_floor,
        chips=spec.chips)
