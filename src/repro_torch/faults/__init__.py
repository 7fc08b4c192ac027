"""Fault injection + self-healing for the fleet (chaos layer).

``injector`` breaks things on a deterministic, seed-driven schedule;
``detector`` notices (heartbeat suspect→dead on the fleet's own wake
clock); ``recovery`` bounds what a broken offload chain may cost
before the requester degrades to a local elastic variant; ``report``
turns the resulting trace events into MTTD/MTTR numbers.  See
``docs/RESILIENCE.md`` for the taxonomy, state machine and defaults.
"""
from .detector import (ALIVE, DEAD, RECOVERED, SUSPECT, DetectorConfig,
                       HeartbeatDetector, Transition)
from .injector import (CRASH, FAULT_KINDS, FREEZE, LINK_DEGRADE,
                       LINK_KINDS, LOAD_SPIKE, OOM, PARTITION,
                       SILENT_KINDS, STRAGGLER, TELEMETRY_CORRUPT,
                       TELEMETRY_DELAY, TELEMETRY_LOSS, FaultInjector,
                       FaultSpec, TelemetryFault, random_schedule)
from .recovery import (ChainOutcome, MigrationOutcome, RetryPolicy,
                       execute_chain, plan_migration)
from .report import FaultOutcome, schedule_to_json, summarize_faults

__all__ = [
    "ALIVE", "SUSPECT", "DEAD", "RECOVERED",
    "DetectorConfig", "HeartbeatDetector", "Transition",
    "CRASH", "FREEZE", "LINK_DEGRADE", "PARTITION", "TELEMETRY_LOSS",
    "TELEMETRY_DELAY", "TELEMETRY_CORRUPT", "STRAGGLER", "LOAD_SPIKE",
    "OOM", "FAULT_KINDS", "LINK_KINDS", "SILENT_KINDS",
    "FaultSpec", "TelemetryFault", "FaultInjector", "random_schedule",
    "RetryPolicy", "ChainOutcome", "execute_chain",
    "MigrationOutcome", "plan_migration",
    "FaultOutcome", "summarize_faults", "schedule_to_json",
]
