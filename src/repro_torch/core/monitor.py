"""Resource availability monitor (paper §III-D, first loop component).

Tracks compute/memory availability within and across devices.  On mobile
the signals are battery, DVFS state, competing processes and cache
contention; the datacenter analogues are power caps, free device-memory
fraction, available chips (preemptions / co-tenancy) and interconnect
contention.  A context trace drives benchmarks and the real-world
case-study reproduction (paper Fig. 13) with battery/memory curves over
time.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Iterator, List, Optional

from ..obs import NULL_RECORDER


@dataclass(frozen=True)
class ResourceContext:
    """A snapshot of runtime resource availability."""
    time_s: float = 0.0
    battery_frac: float = 1.0        # mobile battery  <-> power headroom
    mem_free_frac: float = 1.0       # free device-memory fraction
    chips_available: int = 256
    ici_contention: float = 0.0      # 0..1 fraction of link bw lost
    cpu_temp_derate: float = 1.0     # DVFS clock derate (1 = full speed)
    competing_procs: int = 0
    data_drift: float = 0.0          # distribution-shift magnitude (0..1)
    request_rate: float = 1.0        # relative inference request pressure

    def mem_budget_bytes(self, hbm_bytes: float) -> float:
        return self.mem_free_frac * hbm_bytes

    def effective_flops(self, peak: float) -> float:
        derate = self.cpu_temp_derate / (1.0 + 0.15 * self.competing_procs)
        return peak * derate

    def effective_link_bw(self, peak: float) -> float:
        return peak * (1.0 - self.ici_contention)


class ResourceMonitor:
    """Polls a context source (synthetic trace or live callbacks).

    ``recorder``/``obs_pid`` are the observability hooks: when a
    :class:`~repro_torch.obs.recorder.TraceRecorder` is installed (the fleet
    controller wires its own into every member's monitor), each context
    update lands as a ``monitor.context`` trace instant."""

    def __init__(self, source: Optional[Iterator[ResourceContext]] = None):
        self._source = source
        self._history: List[ResourceContext] = []
        self.current = ResourceContext()
        self.recorder = NULL_RECORDER
        self.obs_pid = "monitor"

    def tick(self) -> ResourceContext:
        if self._source is not None:
            try:
                self.current = next(self._source)
            except StopIteration:
                pass
        self._history.append(self.current)
        return self.current

    def history(self) -> List[ResourceContext]:
        return list(self._history)

    def set(self, ctx: ResourceContext) -> None:
        if self.recorder.enabled:
            self.recorder.instant(
                "monitor.context", pid=self.obs_pid, tid="monitor",
                cat="fleet",
                args={"battery_frac": ctx.battery_frac,
                      "mem_free_frac": ctx.mem_free_frac,
                      "cpu_temp_derate": ctx.cpu_temp_derate,
                      "competing_procs": ctx.competing_procs,
                      "data_drift": ctx.data_drift})
        self.current = ctx


# -------------------------------------------------------------- traces -----
def constant_trace(ctx: ResourceContext, n: int) -> Iterator[ResourceContext]:
    for i in range(n):
        yield dataclasses.replace(ctx, time_s=float(i))


def case_study_trace(n: int = 24, seed: int = 0) -> Iterator[ResourceContext]:
    """The paper's Fig. 13 scenario: a day of operation — battery drains
    90%→21%, memory availability dips mid-run (e2: 85%→28%), lighting/scene
    drift rises in the evening."""
    import random
    rng = random.Random(seed)
    for i in range(n):
        t = i / max(n - 1, 1)
        battery = 0.90 - 0.69 * t
        if 0.35 < t < 0.6:
            mem = 0.28 + 0.06 * rng.random()          # e2: memory pressure
        else:
            mem = 0.85 - 0.1 * t + 0.05 * rng.random()
        drift = 0.1 + (0.5 * max(0.0, t - 0.7) / 0.3)  # evening lighting
        yield ResourceContext(
            time_s=i * 3600.0 / n, battery_frac=battery,
            mem_free_frac=mem,
            chips_available=256,
            ici_contention=0.1 * rng.random(),
            cpu_temp_derate=1.0 - 0.2 * max(0.0, t - 0.5),
            competing_procs=rng.randint(0, 3),
            data_drift=min(drift, 1.0),
            request_rate=0.5 + 0.8 * math.sin(math.pi * t) ** 2)


def budget_sweep_trace(levels=(1.0, 0.75, 0.5, 0.25)) -> Iterator[ResourceContext]:
    """Paper Table II: stepped memory-budget restriction."""
    for i, m in enumerate(levels):
        yield ResourceContext(time_s=float(i), mem_free_frac=m)


def dvfs_spike_trace(n: int = 10) -> Iterator[ResourceContext]:
    """Thermal throttling event mid-run (paper's DVFS discussion)."""
    for i in range(n):
        derate = 0.55 if n // 3 <= i < 2 * n // 3 else 1.0
        yield ResourceContext(time_s=float(i), cpu_temp_derate=derate,
                              competing_procs=2 if derate < 1 else 0)


# ------------------------------------------- per-device trace plumbing -----
def shape_context(ctx: ResourceContext, *, battery_scale: float = 1.0,
                  mem_scale: float = 1.0, derate_floor: float = 0.0,
                  chips: Optional[int] = None,
                  extra_procs: int = 0) -> ResourceContext:
    """Project a fleet-wide context onto one device's resource envelope.

    A shared scenario (the case-study day) hits every device, but each
    device has its own battery capacity, memory headroom and DVFS floor —
    the same evening drains a small phone's battery faster than a plugged
    edge server's."""
    return dataclasses.replace(
        ctx,
        battery_frac=min(1.0, max(0.0, ctx.battery_frac * battery_scale)),
        mem_free_frac=min(1.0, max(0.02, ctx.mem_free_frac * mem_scale)),
        cpu_temp_derate=max(derate_floor, ctx.cpu_temp_derate),
        chips_available=(chips if chips is not None else ctx.chips_available),
        competing_procs=ctx.competing_procs + extra_procs)


def shaped_trace(base: Iterator[ResourceContext], **envelope
                 ) -> Iterator[ResourceContext]:
    """Map ``shape_context`` over a base trace — the monitor-level hook the
    fleet registry uses to derive per-device traces from one scenario."""
    for ctx in base:
        yield shape_context(ctx, **envelope)
