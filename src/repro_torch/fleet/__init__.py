"""Heterogeneous device-fleet simulation with crowd-shared telemetry
calibration (the "Crowd" level of CrowdHMTware): a registry of ~15
platform profiles in three hardware tiers, per-device context traces,
one co-adaptation loop per device, and a telemetry store that feeds
observed step timings back into the profiler's estimates — pooled per
``(tier, channel)`` so devices learn from each other's measurements
without mixing engine wall-times and simulated-silicon scales.

Stepping is event-driven by default: :class:`FleetController` keeps a
min-heap of per-device next-wake times derived from each
:class:`DeviceSpec`'s :class:`TickEnvelope`, so fast devices tick at
their own rate, slow devices never gate them, and telemetry reports
arrive at the :class:`TelemetryStore` out of order (which its
timestamp-sorted calibrators absorb).  ``step_mode="lockstep"`` restores
the legacy one-global-tick-advances-everyone behavior.
"""
from .controller import (DEFAULT_SHAPE, STEP_MODES, FleetController,
                         FleetTickRecord)
from .placement import (FleetPlacer, LinkSpec, MemberState,
                        PlacementDecision, SiteTopology,
                        synthesize_profile)
from .registry import (DEFAULT_SITE, DeviceSpec, HEAVY, LIGHT, MEDIUM,
                       PLATFORMS, PlatformProfile, TIER_TICK_S, TIERS,
                       TickEnvelope, build_fleet, device_trace,
                       make_device, platforms_by_tier)
from .report import FleetReport, TierSummary, fleet_report
from .telemetry import (ACCURACY, CHANNELS, ENGINE, SIMULATED,
                        AccuracyRecord, EwmaLsqCalibrator,
                        MeasurementRecord, TelemetryStore)

__all__ = ["DEFAULT_SHAPE", "STEP_MODES", "FleetController",
           "FleetTickRecord", "FleetPlacer", "LinkSpec", "MemberState",
           "PlacementDecision", "SiteTopology", "synthesize_profile",
           "DEFAULT_SITE", "DeviceSpec", "HEAVY", "LIGHT", "MEDIUM",
           "PLATFORMS", "PlatformProfile", "TIER_TICK_S", "TIERS",
           "TickEnvelope", "build_fleet", "device_trace", "make_device",
           "platforms_by_tier", "FleetReport", "TierSummary",
           "fleet_report", "ACCURACY", "CHANNELS", "ENGINE", "SIMULATED",
           "AccuracyRecord", "EwmaLsqCalibrator", "MeasurementRecord",
           "TelemetryStore"]
