"""FleetController: one co-adaptation loop per device, crowd-calibrated.

Runs the paper's monitor→profiler→optimizer→apply loop for every device
in a heterogeneous fleet over interleaved per-device context traces.
Each tick produces a (predicted, observed) measurement pair; telemetry
fits per-tier corrections and the controller pushes them back into every
same-tier loop's evaluator — back-end measurements steering front-end
decisions, across devices.

Stepping is **event-driven** by default (``step_mode="event"``): a
min-heap of per-device next-wake times lets every device tick at its own
rate — the wake period comes from the device's
:attr:`~repro_torch.fleet.registry.DeviceSpec.tick_envelope` (tier base rate,
DVFS-derated, clamped) plus, for engine-backed devices, the engine's
measured step-time EWMA.  A throttled little-core phone therefore never
gates an idle heavy-tier member, and telemetry reports reach the
:class:`TelemetryStore` out of order (per-device reporting jitter),
which the store's timestamp-sorted calibrators absorb.  The legacy
synchronized path is kept as ``step_mode="lockstep"``: one global tick
advances every device in unison, exactly the pre-event behavior.

Observations come from either (a) the device's latent ground-truth bias
(simulated silicon, default) or (b) a real :class:`ServingEngine`
attached to the device, whose measured step wall-times become the
observed latencies (see ``attach_engine``).
"""
from __future__ import annotations

import dataclasses
import heapq
import random
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.actions import Action, OffloadChoice
from repro_torch.core.loop import AdaptationLoop, Decision
from repro_torch.core.monitor import ResourceContext
from repro_torch.core.optimizer import DRIFT_ACCURACY_COST, Budgets
from repro_torch.faults.detector import (DEAD, SUSPECT, DetectorConfig,
                                   HeartbeatDetector, Transition)
from repro_torch.faults.recovery import (RetryPolicy, execute_chain,
                                   plan_migration)
from repro_torch.models.configs import InputShape, ModelConfig
from repro_torch.models.layers import tree_leaves
from repro_torch.models.runtime import DEFAULT_OPTIONS
from repro_torch.obs import NULL_RECORDER, MetricsRegistry
from repro_torch.offload.placer import DEVICE_POOLS
from repro_torch.serving import DEFAULT_SAMPLING, CompileCache, ServingEngine

from .placement import FleetPlacer, PlacementDecision, SiteTopology
from .registry import DeviceSpec, device_trace
from .telemetry import (ENGINE, SIMULATED, AccuracyRecord,
                        MeasurementRecord, TelemetryStore)

# the workload shape fleet loops adapt for unless a caller overrides it
DEFAULT_SHAPE = InputShape("fleet", 256, 4, "prefill")

# "event": min-heap of per-device next-wake times (default);
# "lockstep": legacy synchronized stepping, one global tick for everyone
STEP_MODES = ("event", "lockstep")

def _same_device(have: torch.device, want: torch.device) -> bool:
    """``cuda`` names the current card, so it matches any ``cuda:i``."""
    return have.type == want.type and (want.index is None
                                       or have.index == want.index)


# reserved heap ids ("<" cannot appear in a device_id, which is always
# "<platform>#<index>"): fleet-wide re-placement wakes, failure-detector
# sweeps, and one-shot scheduled callbacks (fault injection)
_PLACEMENT_WAKE = "<placement>"
_DETECTOR_WAKE = "<detector>"
_CALLBACK_WAKE = "<callback>"


@dataclass
class FleetTickRecord:
    """What one device did and what it cost on one fleet tick.

    ``tick`` is the device's own wake counter (in lockstep mode it
    coincides with the global tick); ``timestamp_s`` is the simulated
    fleet-clock instant of the wake — under event stepping, same-tick
    records from different devices carry different timestamps."""
    device_id: str
    tier: str
    tick: int
    ctx: ResourceContext
    decision: Decision
    predicted_raw_s: float        # uncalibrated analytic estimate
    predicted_s: float            # what the optimizer believed (calibrated)
    observed_s: float             # measured (simulated silicon or engine)
    observed_energy_j: float
    sla_s: float
    violated: bool
    timestamp_s: float = 0.0


@dataclass
class _DeviceRuntime:
    spec: DeviceSpec
    loop: AdaptationLoop
    trace: Iterator[ResourceContext]
    rng: random.Random
    sla_s: float
    engine: object = None         # optional ServingEngine
    engine_steps: int = 4
    exhausted: bool = False
    ticks: int = 0                # wakes taken so far
    dropped: bool = False         # left the fleet (drop_device)
    failed: Optional[str] = None  # active silence fault: "crash"|"freeze"
    scheduled: bool = False       # has a live heap entry (event mode)
    penalty_s: float = 0.0        # pending chain-recovery latency penalty


class FleetController:
    """Steps a heterogeneous fleet through shared scenarios, closing the
    telemetry loop per hardware tier.

    ``step_mode="event"`` (default) schedules devices on a min-heap of
    next-wake times so each ticks at its envelope's rate;
    ``step_mode="lockstep"`` advances all devices once per global tick
    (the legacy synchronized behavior).  In both modes ``run(ticks)``
    and ``step()`` work; event mode additionally exposes
    ``run_for(duration_s)`` to advance the simulated clock by a fixed
    horizon, which is where differential tick counts come from."""

    def __init__(self, fleet: Sequence[DeviceSpec], cfg: ModelConfig,
                 shape: InputShape = DEFAULT_SHAPE, *,
                 budget_margin: float = 1.5,
                 share_calibration: bool = True,
                 warmup_ticks: int = 6,
                 recalibrate_every: int = 2,
                 observation_noise: float = 0.03,
                 allow_offload: bool = False,
                 trace_ticks: int = 24,
                 trace_factory=None,
                 compile_cache: Optional[CompileCache] = None,
                 step_mode: str = "event",
                 telemetry_jitter_s: Optional[float] = None,
                 placement: bool = False,
                 topology: Optional[SiteTopology] = None,
                 placement_every_s: Optional[float] = None,
                 placement_drift: float = 0.15,
                 placement_hysteresis: float = 0.15,
                 detection: bool = True,
                 detector_config: Optional[DetectorConfig] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 recorder=NULL_RECORDER,
                 metrics: Optional[MetricsRegistry] = None,
                 slo=None,
                 seed: int = 0):
        if step_mode not in STEP_MODES:
            raise ValueError(f"unknown step_mode {step_mode!r}; "
                             f"expected one of {STEP_MODES}")
        self.cfg = cfg
        self.shape = shape
        self.step_mode = step_mode
        # ---- observability ------------------------------------------
        # One recorder, one simulated clock: the controller installs its
        # fleet clock into the recorder, so engine spans (wall-time) and
        # fleet clock events export onto a single shared timebase.  The
        # metrics registry replaces the old scattered tallies (_wakes,
        # placement_events); the public attributes below are views.
        self.recorder = recorder
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if recorder.enabled and getattr(recorder, "sim_clock", None) is None:
            recorder.sim_clock = self._sim_now
        self._wake_counter = self.metrics.counter("fleet.wakes")
        self._placement_counter = self.metrics.counter(
            "fleet.placement_events")
        self._violation_counter = self.metrics.counter("fleet.violations")
        self._energy_counter = self.metrics.counter("fleet.energy_j")
        self._recal_counter = self.metrics.counter("fleet.recalibrations")
        # ---- SLO burn-rate feedback ---------------------------------
        # When an SLOTracker is installed, engine-backed devices feed it
        # TTFT/TPOT observations and the wake path polls its pressure
        # signal; pressure transitions push `set_pressure` into every
        # device's adaptation loop and pull placement forward.  With no
        # tracker (the default) none of this runs — SLO-healthy and
        # tracker-free runs are bit-identical.
        self.slo = slo
        self._slo_pressure = 0.0
        self._slo_counter = self.metrics.counter("fleet.slo_pressure_events")
        if slo is not None:
            slo.bind(clock=self._sim_now, recorder=recorder)
        self.telemetry = TelemetryStore()
        self.telemetry.recorder = recorder
        # fleet-level program cache: engine-backed devices of the same
        # platform share compiled decode/prefill programs through this
        self.compile_cache = (compile_cache if compile_cache is not None
                              else CompileCache())
        self.share_calibration = share_calibration
        self.warmup_ticks = warmup_ticks
        self.recalibrate_every = recalibrate_every
        self.observation_noise = observation_noise
        self.records: List[FleetTickRecord] = []
        self._tick = 0
        self._budget_margin = budget_margin
        self._devices: Dict[str, _DeviceRuntime] = {}
        nominal = ResourceContext()
        for spec in fleet:
            loop = AdaptationLoop(
                cfg=cfg, shape=shape, hw=spec.hw,
                allow_offload=allow_offload)
            # per-device SLA: margin × the *raw* full-variant estimate on
            # this silicon under a nominal context — tight enough that the
            # profiler's latent optimism causes real violations until the
            # feedback loop corrects it
            full = loop.evaluator.evaluate(Action(), nominal, calibrate=False)
            sla = budget_margin * full.latency_s
            loop.budgets = Budgets(
                latency_s=sla,
                memory_bytes=spec.hw.hbm_bytes * spec.chips)
            trace = (trace_factory(spec, trace_ticks) if trace_factory
                     else device_trace(spec, trace_ticks))
            # each member's loop + monitor report onto this device's
            # trace track
            loop.recorder = self.recorder
            loop.obs_pid = spec.device_id
            loop.monitor.recorder = self.recorder
            loop.monitor.obs_pid = spec.device_id
            self._devices[spec.device_id] = _DeviceRuntime(
                spec=spec, loop=loop, trace=iter(trace),
                rng=random.Random(seed * 7919 + spec.trace_seed),
                sla_s=sla)
        # ---- event-scheduler state (inert under lockstep) -------------
        periods = [d.spec.tick_envelope.nominal_s
                   for d in self._devices.values()] or [1.0]
        # run(ticks) horizon unit: the slowest member's nominal period,
        # so one "tick" of run() gives even the slowest device one wake
        self._base_period_s = max(periods)
        self._min_period_s = min(periods)
        # calibration cadence on the fleet clock, scaled so the fastest
        # devices see the same warmup/recalibrate tick counts as lockstep
        self._cal_period_s = recalibrate_every * self._min_period_s
        self._warmup_end_s = warmup_ticks * self._min_period_s
        self._next_cal_s = self._warmup_end_s
        self._now = 0.0
        self._seq = 0
        # telemetry reporting jitter: reports arrive at the store this
        # long after the observation (deterministic per (device, tick)),
        # de-ordering same-window reports across devices
        self._jitter_s = (telemetry_jitter_s if telemetry_jitter_s
                          is not None else 0.5 * self._min_period_s)
        self._pending: List[Tuple[float, int, MeasurementRecord]] = []
        self._heap: List[Tuple[float, int, str]] = []
        n = max(len(fleet), 1)
        for i, d in enumerate(self._devices.values()):
            # stagger first wakes across each device's own period so the
            # fleet doesn't start phase-locked
            self._push_device(d, d.spec.tick_envelope.nominal_s * i / n)
        # ---- cross-device placement (the fleet IS the device pool) ----
        self.placement = placement
        self.placer: Optional[FleetPlacer] = None
        self.placement_log: List[Tuple[float, int, PlacementDecision]] = []
        self._placement_drift = placement_drift
        self._place_period_s = (placement_every_s if placement_every_s
                                is not None else self._cal_period_s)
        self._next_place_s: Optional[float] = None
        if placement:
            self.placer = FleetPlacer(cfg, topology,
                                      hysteresis=placement_hysteresis)
            self.placer.recorder = self.recorder
            for d in self._devices.values():
                self.placer.register(d.spec)
                # placements flow back through the evaluator: fleet-peer
                # OffloadChoices resolve to live calibrated profiles
                d.loop.evaluator.pool_resolver = self._resolve_pool
            if step_mode == "event":
                # first re-placement after the calibration warmup
                self._next_place_s = self._warmup_end_s
                self._push(self._next_place_s, _PLACEMENT_WAKE)
        # ---- failure detection + recovery (the self-healing plane) ----
        # Heartbeat detection rides the same min-heap: every device wake
        # is a beat, a dedicated sweep wake advances the suspect→dead
        # state machine.  Detector/callback wakes deliberately do NOT
        # run the telemetry-flush/recalibration block, so a fault-free
        # run with detection on is bit-identical to one without it.
        self.retry_policy = (retry_policy if retry_policy is not None
                             else RetryPolicy())
        self._suspect_counter = self.metrics.counter(
            "fleet.detector_suspects")
        self._dead_counter = self.metrics.counter("fleet.detector_deaths")
        self._evict_counter = self.metrics.counter("fleet.evictions")
        self._retry_counter = self.metrics.counter("fleet.offload_retries")
        self._degrade_counter = self.metrics.counter(
            "fleet.degraded_fallbacks")
        self._readmit_counter = self.metrics.counter("fleet.readmissions")
        self._migration_counter = self.metrics.counter("fleet.migrations")
        self._telem_drop_counter = self.metrics.counter(
            "fleet.telemetry_dropped")
        self._derate_caps: Dict[str, float] = {}
        self._telem_faults: Dict[str, object] = {}
        self._fault_rng = random.Random(seed * 104729 + 7)
        self._callbacks: Dict[Tuple[float, int], Callable[[], None]] = {}
        self._detect_period_s = self._min_period_s
        self.detector: Optional[HeartbeatDetector] = None
        if detection and step_mode == "event":
            self.detector = HeartbeatDetector(detector_config)
            for d in self._devices.values():
                self.detector.track(d.spec.device_id,
                                    d.spec.tick_envelope.max_s)
            self._push(self._detect_period_s, _DETECTOR_WAKE)

    # ----------------------------------------------------------- plumbing --
    def _device(self, device_id: str) -> _DeviceRuntime:
        """Runtime lookup that fails usefully: an unknown id raises a
        KeyError naming the fleet's actual members instead of a bare
        repr (typos in device ids are a debugging tarpit otherwise)."""
        try:
            return self._devices[device_id]
        except KeyError:
            raise KeyError(
                f"unknown device_id {device_id!r}; known devices: "
                f"{sorted(self._devices)}") from None

    def _sim_now(self) -> float:
        """The simulated fleet-clock reading trace events are stamped
        with: the event clock under event stepping, the global tick
        under lockstep."""
        return self._now if self.step_mode == "event" else float(self._tick)

    @property
    def placement_events(self) -> int:
        """Re-placement sweeps run (view over ``fleet.placement_events``
        in the metrics registry)."""
        return self._placement_counter.value

    @property
    def migrations(self) -> int:
        """Requests live-migrated (frozen on an evicted member, thawed
        on a peer) so far — view over ``fleet.migrations``."""
        return self._migration_counter.value

    @property
    def devices(self) -> List[DeviceSpec]:
        return [d.spec for d in self._devices.values()]

    @property
    def now_s(self) -> float:
        """Current simulated fleet-clock time."""
        return self._now

    @property
    def tick_counts(self) -> Dict[str, int]:
        """Wakes taken per device so far — under event stepping fast
        devices accumulate strictly more than slow ones over the same
        simulated horizon."""
        return {did: d.ticks for did, d in self._devices.items()}

    def loop_for(self, device_id: str) -> AdaptationLoop:
        return self._device(device_id).loop

    def sla_for(self, device_id: str) -> float:
        return self._device(device_id).sla_s

    def set_sla(self, device_id: str, sla_s: float) -> None:
        """Override a device's latency SLA (e.g. an externally mandated
        budget for an engine-backed device whose real step times live on
        a different scale than the analytic estimate)."""
        d = self._device(device_id)
        d.sla_s = sla_s
        d.loop.budgets = Budgets(latency_s=sla_s,
                                 memory_bytes=d.loop.budgets.memory_bytes)

    def attach_engine(self, device_id: str, engine, steps_per_tick: int = 4
                      ) -> None:
        """Back a device with a real ServingEngine: its measured step
        wall-times replace the simulated observation for that device,
        and (in event mode) its step-time EWMA feeds the device's
        next-wake estimate.  An engine still carrying the no-op default
        recorder adopts the fleet's, with this device's id as its trace
        pid — its step/prefill/request spans then land on the device's
        track of the fleet timeline."""
        d = self._device(device_id)
        erec = getattr(engine, "recorder", None)
        if erec is not None and not erec.enabled and self.recorder.enabled:
            engine.recorder = self.recorder
            engine.pid = device_id
        d.engine = engine
        d.engine_steps = steps_per_tick
        # SLO feed: engine-backed devices report TTFT/TPOT into the
        # fleet's tracker (an engine with its own tracker keeps it)
        if self.slo is not None and getattr(engine, "slo", None) is None:
            engine.slo = self.slo

    def build_engine(self, device_id: str, params, *, cfg=None, slots: int = 4,
                     max_seq: int = 256, opts=None, steps_per_tick: int = 4,
                     decode_mode: str = "batched",
                     prefill_mode: str = "batched", sampling=None,
                     block_size: Optional[int] = None,
                     pool_blocks: Optional[int] = None,
                     prefix_entries: Optional[int] = None,
                     params_version: Optional[int] = None,
                     device: str = "cuda"):
        """Construct and attach a ServingEngine for a device, wired to the
        fleet's shared compile cache under the device's compile domain —
        same-platform fleet members reuse each other's bound decode and
        prefill programs instead of binding ~identical ones per device.
        ``sampling`` sets the engine's default :class:`SamplingOpts`;
        per-slot sampling state is runtime data, so heterogeneous sampling
        across the fleet still shares every compiled program.

        ``cfg`` defaults to the fleet's model config; demos and tests pass
        a reduced variant so real decode steps stay cheap.  The paging
        knobs (``block_size``/``pool_blocks``/``prefix_entries``) only
        matter under ``decode_mode="paged"``; ``params_version`` tags the
        weights for freeze/thaw compatibility — engines built from the
        same params object agree by default, so in-flight requests
        migrate between them with zero re-prefill.

        ``device`` is where the engine runs (``"cuda"`` unless the caller
        asks for the CPU); ``params`` must already be there, as
        :class:`ServingEngine` requires."""
        spec = self._device(device_id).spec
        target = torch.device(device)
        misplaced = sorted({str(leaf.device) for leaf in tree_leaves(params)
                            if not _same_device(leaf.device, target)})
        if misplaced:
            raise ValueError(f"params live on {misplaced}; build_engine "
                             f"was asked for {device!r}")
        paged_kw = {}
        if block_size is not None:
            paged_kw["block_size"] = block_size
        if pool_blocks is not None:
            paged_kw["pool_blocks"] = pool_blocks
        if prefix_entries is not None:
            paged_kw["prefix_entries"] = prefix_entries
        engine = ServingEngine(
            cfg if cfg is not None else self.cfg, params,
            slots=slots, max_seq=max_seq,
            opts=opts if opts is not None else DEFAULT_OPTIONS,
            decode_mode=decode_mode, prefill_mode=prefill_mode,
            sampling=sampling if sampling is not None else DEFAULT_SAMPLING,
            compile_cache=self.compile_cache,
            compile_domain=spec.compile_domain,
            recorder=self.recorder, pid=device_id,
            params_version=params_version, device=device, **paged_kw)
        self.attach_engine(device_id, engine, steps_per_tick)
        return engine

    # ---------------------------------------------------------- fault plane --
    # The surface the FaultInjector drives.  Each call is also usable
    # directly by tests: the controller doesn't know *why* a device
    # failed, only that it did.
    def device_is_up(self, device_id: str) -> bool:
        """False once the device crashed/froze, dropped, or ran out of
        trace — i.e. it will not wake again until thawed."""
        d = self._device(device_id)
        return not (d.exhausted or d.dropped) and d.failed is None

    def engine_of(self, device_id: str):
        """The device's attached ServingEngine (None when simulated)."""
        return self._device(device_id).engine

    def fail_device(self, device_id: str, mode: str = "crash") -> None:
        """Silence a device without telling anyone: it stops waking (and
        therefore heartbeating) but — unlike ``drop_device`` — nothing
        is announced; the detector must discover it.  ``"freeze"`` holds
        its loop/trace state for a later :meth:`thaw_device`;
        ``"crash"`` is permanent."""
        if mode not in ("crash", "freeze"):
            raise ValueError(f"unknown failure mode {mode!r}; "
                             f"expected 'crash' or 'freeze'")
        self._device(device_id).failed = mode

    def thaw_device(self, device_id: str) -> None:
        """End a freeze: the device wakes immediately and resumes its
        trace where it stopped.  Its first beat back is a *flap* — the
        detector quarantines it before the placer may use it again."""
        d = self._device(device_id)
        if d.failed is None:
            return
        d.failed = None
        if not d.scheduled and not d.exhausted \
                and self.step_mode == "event":
            self._push_device(d, self._now)

    def set_derate_cap(self, device_id: str,
                       cap: Optional[float]) -> None:
        """Straggler onset: clamp the device's effective DVFS derate to
        ``cap`` (< 1 slows its wakes and its raw latency — the fleet
        sees a device that suddenly runs hot).  ``None`` clears."""
        self._device(device_id)
        if cap is None:
            self._derate_caps.pop(device_id, None)
        else:
            self._derate_caps[device_id] = cap

    def set_telemetry_fault(self, device_id: str, fault) -> None:
        """Attach a :class:`~repro_torch.faults.injector.TelemetryFault` to
        the device's reporting path (loss/delay/corruption applied at
        report time).  ``None`` clears."""
        self._device(device_id)
        if fault is None:
            self._telem_faults.pop(device_id, None)
        else:
            self._telem_faults[device_id] = fault

    def schedule_at(self, when_s: float,
                    fn: Callable[[], None]) -> None:
        """Run ``fn`` when the simulated clock reaches ``when_s`` — the
        hook fault schedules arm themselves with.  Callback wakes skip
        the telemetry-flush/recalibration block, so scheduling callbacks
        never perturbs a fault-free run's calibration stream."""
        if self.step_mode != "event":
            raise RuntimeError("schedule_at() requires step_mode='event'")
        self._seq += 1
        heapq.heappush(self._heap, (when_s, self._seq, _CALLBACK_WAKE))
        self._callbacks[(when_s, self._seq)] = fn

    # ------------------------------------------------------------ observe --
    def _observe(self, d: _DeviceRuntime, raw_pred_s: float,
                 raw_pred_j: float) -> Optional[tuple]:
        """One wake's (latency, energy, channel) observation.

        An engine-backed member takes up to ``engine_steps`` engine steps
        and observes their mean ``step_times`` entry: the host-clock time
        of a decode sweep, which ends in a device→host read of the
        sampled tokens, so on the card it covers the step's device work
        (a CUDA-graph replay after the first step of a binding).  The
        ENGINE channel is therefore host-clock seconds of real steps; a
        simulated member draws its observation from the latent bias."""
        if d.engine is not None:
            times = []
            for _ in range(d.engine_steps):
                if not d.engine.has_work:
                    break
                d.engine.step()
                times.append(d.engine.step_times[-1])
            if times:
                obs_s = sum(times) / len(times)
                # energy ≈ observed time at the device's sustained power
                obs_j = obs_s * d.spec.hw.peak_w
                return obs_s, obs_j, ENGINE
            # engine idle: no measurement this tick.  Falling back to the
            # simulated channel would mix wall-clock and analytic scales
            # in one calibrator and fake SLA violations.
            return None
        eps = d.rng.gauss(0.0, self.observation_noise)
        eps = max(-0.5, min(0.5, eps))
        obs_s = raw_pred_s * d.spec.latent_latency_factor * (1.0 + eps)
        eps_e = d.rng.gauss(0.0, self.observation_noise)
        obs_j = raw_pred_j * d.spec.latent_energy_factor * (1.0 + eps_e)
        return obs_s, obs_j, SIMULATED

    # ------------------------------------------------------- shared tick ---
    def _advance(self, d: _DeviceRuntime, now_s: float
                 ) -> Tuple[Optional[FleetTickRecord],
                            Optional[ResourceContext]]:
        """Advance one device by one wake at fleet-clock ``now_s``:
        consume a trace context, adapt, execute, report telemetry.
        The whole wake is one ``fleet.wake`` span on the device's track,
        enclosing (in time) the loop decision, any engine steps, and the
        telemetry report it produced."""
        rec_on = self.recorder.enabled
        if rec_on:
            self.recorder.begin("fleet.wake", pid=d.spec.device_id,
                                tid="wake", cat="fleet",
                                args={"tick": d.ticks + 1})
        out = self._advance_inner(d, now_s)
        if rec_on:
            frec = out[0]
            args = {"exhausted": d.exhausted}
            if frec is not None:
                args.update(observed_s=frec.observed_s,
                            violated=frec.violated)
            self.recorder.end("fleet.wake", pid=d.spec.device_id,
                              tid="wake", cat="fleet", args=args)
        return out

    def _advance_inner(self, d: _DeviceRuntime, now_s: float
                       ) -> Tuple[Optional[FleetTickRecord],
                                  Optional[ResourceContext]]:
        try:
            ctx = next(d.trace)
        except StopIteration:
            d.exhausted = True
            return None, None
        d.ticks += 1
        self._wake_counter.inc()
        cap = self._derate_caps.get(d.spec.device_id)
        if cap is not None:
            # straggler fault: DVFS collapse caps the effective derate —
            # slower wakes, slower raw execution, visible to the placer
            ctx = dataclasses.replace(
                ctx, cpu_temp_derate=min(ctx.cpu_temp_derate, cap))
        self._sync_member(d, ctx)
        decision = d.loop.tick(ctx)
        peers = decision.action.offload.peers
        if peers and self._chain_lost(peers):
            decision = self._recover_chain(d, ctx, decision)
        raw = d.loop.evaluator.evaluate(decision.action, ctx,
                                        calibrate=False)
        obs = self._observe(d, raw.latency_s, raw.energy_j)
        if obs is None:
            return None, ctx
        obs_s, obs_j, chan = obs
        if d.penalty_s > 0.0:
            # chain recovery happened this wake: the timeouts + backoff
            # it burned are real observed latency, not a side channel
            obs_s += d.penalty_s
            d.penalty_s = 0.0
        if chan == SIMULATED:
            self._observe_accuracy(d, decision, ctx, now_s)
        mrec = MeasurementRecord(
            device_id=d.spec.device_id, tier=d.spec.tier,
            tick=d.ticks,
            predicted_latency_s=raw.latency_s,
            observed_latency_s=obs_s,
            predicted_energy_j=raw.energy_j,
            observed_energy_j=obs_j,
            channel=chan, timestamp_s=now_s)
        self._report(mrec)
        rec = FleetTickRecord(
            device_id=d.spec.device_id, tier=d.spec.tier,
            tick=d.ticks, ctx=ctx, decision=decision,
            predicted_raw_s=raw.latency_s,
            predicted_s=decision.eval.latency_s,
            observed_s=obs_s, observed_energy_j=obs_j,
            sla_s=d.sla_s, violated=obs_s > d.sla_s,
            timestamp_s=now_s)
        if rec.violated:
            self._violation_counter.inc()
        self._energy_counter.inc(obs_j)
        self.records.append(rec)
        return rec, ctx

    def _sync_member(self, d: _DeviceRuntime, ctx: ResourceContext) -> None:
        """Refresh the placer's view of this member (context + serving
        load) and trigger an immediate re-placement wake when the
        member's effective speed moved past the drift threshold — a
        helper throttling down is a placement-relevant event, not just a
        telemetry sample."""
        if self.placer is None:
            return
        did = d.spec.device_id
        if did not in self.placer.members:
            return
        prev = self.placer.member(did).ctx
        own_load = None
        if d.engine is not None:
            est = getattr(d.engine, "step_time_ewma_s", None)
            if est:
                busy = d.engine_steps * est
                own_load = busy / (busy + d.spec.tick_envelope.nominal_s)
        self.placer.update_member(did, ctx=ctx, own_load=own_load)
        drift = abs(ctx.cpu_temp_derate - prev.cpu_temp_derate) \
            + 0.15 * abs(ctx.competing_procs - prev.competing_procs)
        if drift >= self._placement_drift:
            self._schedule_placement(self._now)

    # ---------------------------------------------------- chain recovery ---
    def _peer_down(self, peer: str) -> bool:
        """Is this chain hop unusable right now?  Down means failed,
        dropped, exhausted, unknown, or already evicted from the placer
        — quarantined members are alive (just not *preferred*), so an
        existing chain through one keeps working."""
        d = self._devices.get(peer)
        if d is None or d.dropped or d.exhausted or d.failed is not None:
            return True
        return self.placer is not None and peer not in self.placer.members

    def _chain_lost(self, peers: Tuple[str, ...]) -> bool:
        return any(self._peer_down(p) for p in peers[1:])

    def _recover_chain(self, d: _DeviceRuntime, ctx: ResourceContext,
                       decision: Decision) -> Decision:
        """The decision's offload chain references a dead hop.  Pay the
        bounded retry/timeout price (:class:`RetryPolicy`), strip the
        dead fleet target, and re-decide **locally** — the optimizer
        falls back to the compressed elastic variants already in the
        action space, so the requester keeps producing instead of
        stalling until the next placement sweep (which this pulls
        forward)."""
        hosts = decision.action.offload.peers
        hop_s = decision.eval.latency_s / max(len(hosts) - 1, 1)
        outcome = execute_chain(hosts, hop_s,
                                alive=lambda p: not self._peer_down(p),
                                policy=self.retry_policy)
        self._retry_counter.inc(outcome.retries)
        self._degrade_counter.inc()
        d.penalty_s += outcome.penalty_s
        if self.recorder.enabled:
            self.recorder.instant(
                "recovery.retry", pid=d.spec.device_id, tid="recovery",
                cat="fleet",
                args={"failed_hop": outcome.failed_hop,
                      "attempts": outcome.attempts,
                      "penalty_s": outcome.penalty_s})
            self.recorder.instant(
                "recovery.degraded", pid=d.spec.device_id,
                tid="recovery", cat="fleet",
                args={"requester": d.spec.device_id,
                      "lost": outcome.failed_hop, "cause": "chain_loss"})
        d.loop.set_offload_targets(())
        d.loop.abandon_current()     # dead chain must not "hold"
        self._schedule_placement(self._now)
        return d.loop.tick(ctx)

    def _observe_accuracy(self, d: _DeviceRuntime, decision: Decision,
                          ctx: ResourceContext, now_s: float) -> None:
        """Simulate crowd labeling of the decision's task accuracy: the
        analytic proxy overshoots by the device's latent accuracy bias,
        and real drift costs twice what the model budgets.  The record
        lands in the telemetry accuracy channel; ``recalibrate`` feeds
        the pooled per-variant estimates back into every same-tier
        evaluator's ``measured`` dict."""
        variant = decision.action.variant
        pure = d.loop.evaluator.proxy_accuracy(variant)
        noise = max(-0.05, min(0.05,
                               d.rng.gauss(0.0, self.observation_noise / 3)))
        true_acc = max(0.0, pure - d.spec.latent_accuracy_bias
                       - 2.0 * DRIFT_ACCURACY_COST * ctx.data_drift + noise)
        self.telemetry.record_accuracy(AccuracyRecord(
            device_id=d.spec.device_id, tier=d.spec.tier, tick=d.ticks,
            variant=variant,
            predicted_accuracy=decision.eval.accuracy,
            observed_accuracy=true_acc,
            drift=ctx.data_drift, timestamp_s=now_s))

    # -------------------------------------------------- telemetry arrival --
    def _report(self, mrec: MeasurementRecord) -> None:
        """Route a measurement toward the store.  Lockstep (or zero
        jitter) delivers immediately; event mode delays each report by a
        deterministic per-(device, tick) latency, so arrival order at the
        store differs from observation order across devices.  An active
        :class:`~repro_torch.faults.injector.TelemetryFault` on the device is
        applied here: reports may be dropped, delayed, or corrupted
        before the store ever sees them."""
        tf = self._telem_faults.get(mrec.device_id)
        extra_delay_s = 0.0
        if tf is not None:
            if tf.loss_p > 0.0 and self._fault_rng.random() < tf.loss_p:
                self._telem_drop_counter.inc()
                if self.recorder.enabled:
                    self.recorder.instant(
                        "telemetry.lost", pid=mrec.device_id,
                        tid="telemetry", cat="fleet",
                        args={"tick": mrec.tick})
                return
            if tf.corrupt_scale != 1.0:
                mrec = dataclasses.replace(
                    mrec, observed_latency_s=(mrec.observed_latency_s
                                              * tf.corrupt_scale))
            extra_delay_s = tf.delay_s
        if self.step_mode == "lockstep" or self._jitter_s <= 0:
            self.telemetry.record(mrec)
            return
        frac = ((zlib.crc32(mrec.device_id.encode())
                 + mrec.tick * 2654435761) % 1000) / 1000.0
        arrival = mrec.timestamp_s + frac * self._jitter_s + extra_delay_s
        if self.recorder.enabled:
            self.recorder.instant(
                "telemetry.report", pid=mrec.device_id, tid="telemetry",
                cat="fleet",
                args={"tick": mrec.tick, "channel": mrec.channel,
                      "arrival_s": arrival})
        self._seq += 1
        heapq.heappush(self._pending, (arrival, self._seq, mrec))

    def _flush_reports(self, upto_s: float) -> None:
        while self._pending and self._pending[0][0] <= upto_s:
            _, _, mrec = heapq.heappop(self._pending)
            self.telemetry.record(mrec)

    # ------------------------------------------------------ event engine ---
    def _push(self, when_s: float, device_id: str) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (when_s, self._seq, device_id))

    def _push_device(self, d: _DeviceRuntime, when_s: float) -> None:
        """Schedule a device wake, tracking that exactly one heap entry
        is outstanding for it — a thaw must not double-schedule a device
        whose frozen-era entry hasn't popped yet."""
        d.scheduled = True
        self._push(when_s, d.spec.device_id)

    # ----------------------------------------------------- failure detect --
    def _detector_sweep(self) -> None:
        """One detector wake: advance every tracked device's
        suspect→dead state machine on the current clock.  A device
        reaching DEAD is evicted through the same shared path
        ``drop_device`` uses — discovery and announcement converge."""
        rec_on = self.recorder.enabled
        for edge in self.detector.sweep(self._now):
            if edge.state == SUSPECT:
                self._suspect_counter.inc()
                if rec_on:
                    self.recorder.instant(
                        "detector.suspect", pid="fleet", tid="detector",
                        cat="fleet", args={"device": edge.device_id,
                                           "silent_s": edge.silent_s})
            elif edge.state == DEAD:
                self._dead_counter.inc()
                if rec_on:
                    self.recorder.instant(
                        "detector.dead", pid="fleet", tid="detector",
                        cat="fleet", args={"device": edge.device_id,
                                           "silent_s": edge.silent_s})
                self._evict(edge.device_id, cause="detected")

    def _on_recovered(self, d: _DeviceRuntime,
                      edge: Transition) -> None:
        """A suspect/dead device heartbeated again — a flap.  Readmit it
        (re-register with the placer if it was evicted) but under the
        detector's quarantine window: the placer will not select it as
        a helper until the window expires, so a blinking device can't
        ping-pong placements."""
        did = d.spec.device_id
        if self.recorder.enabled:
            self.recorder.instant(
                "detector.recovered", pid="fleet", tid="detector",
                cat="fleet",
                args={"device": did, "was": edge.was,
                      "flaps": edge.flaps,
                      "quarantined_until_s": edge.quarantined_until_s})
        if self.placer is None:
            return
        if did not in self.placer.members:
            self._readmit_counter.inc()
            st = self.placer.register(d.spec)
            st.quarantined_until_s = edge.quarantined_until_s
            self._schedule_placement(self._now)
        else:
            self.placer.member(did).quarantined_until_s = \
                edge.quarantined_until_s

    def _migration_peer(self, device_id: str) -> Optional[str]:
        """A live engine-backed fleet member sharing the evicted device's
        compile domain — frozen KV thaws only where the compiled
        programs (and therefore the weights binding) can match."""
        src = self._device(device_id)
        for did, d in self._devices.items():
            if did == device_id or d.engine is None:
                continue
            if not self.device_is_up(did):
                continue
            if d.spec.compile_domain != src.spec.compile_domain:
                continue
            return did
        return None

    def migrate_engine_requests(self, src_id: str,
                                dst_id: Optional[str] = None) -> int:
        """Move the source engine's entire in-flight + waiting workload
        to a same-domain peer: active requests freeze (pages + sampling
        subtree + consumed count serialized host-side) and thaw on the
        destination with **zero token loss and zero re-prefill** when
        the fingerprints match; waiting requests simply re-submit.
        Returns the number of requests moved (0 when the source has no
        engine or no live peer exists — in-flight work then requeues
        locally so nothing is lost either way)."""
        src = self._device(src_id)
        eng = src.engine
        if eng is None or not eng.has_work:
            return 0
        if dst_id is None:
            dst_id = self._migration_peer(src_id)
        if dst_id is None:
            eng.requeue_active(reason="evict_requeue")
            return 0
        dst = self._device(dst_id).engine
        moved = eng.freeze_all(reason="migrate")
        waiting = eng.drain_waiting()
        plan = plan_migration(moved, dst.can_thaw)
        rec_on = self.recorder.enabled
        for r in reversed(moved):
            ok = dst.thaw(r)
            if rec_on:
                self.recorder.instant(
                    "req.migrate", pid=src_id, tid="migration",
                    cat="request",
                    args={"rid": r.rid, "src": src_id, "dst": dst_id,
                          "reprefill": not ok})
        for r in waiting:
            dst.submit(r)
        n = len(moved) + len(waiting)
        self._migration_counter.inc(n)
        if rec_on:
            self.recorder.instant(
                "fleet.migrate", pid="fleet", tid="control", cat="fleet",
                args={"src": src_id, "dst": dst_id, "frozen": len(moved),
                      "waiting": len(waiting),
                      "zero_reprefill": list(plan.migrated),
                      "fallback": list(plan.fallback),
                      "recovered_tokens": plan.recovered_tokens})
        return n

    def _evict(self, device_id: str, cause: str) -> List[str]:
        """Shared eviction path (detector discovery and ``drop_device``
        announcement both land here): migrate the member's in-flight
        serving work to a same-domain peer (freeze/thaw — zero token
        loss, zero re-prefill), remove it from the placer, degrade every
        requester whose placement used it back to local (zero stall —
        their action spaces lose the dead fleet target immediately), and
        pull the next placement sweep forward.  Returns the affected
        requester ids."""
        self._evict_counter.inc()
        if self.recorder.enabled:
            self.recorder.instant(
                "fleet.evict", pid="fleet", tid="control", cat="fleet",
                args={"device": device_id, "cause": cause})
        self.migrate_engine_requests(device_id)
        if self.placer is None:
            return []
        affected = self.placer.remove_member(device_id)
        for rid in affected:
            dec = self.placer.current(rid)
            if rid in self._devices and dec is not None:
                self._devices[rid].loop.set_offload_targets(())
                self._devices[rid].loop.abandon_current()
                self.placement_log.append((self._now, self.wakes, dec))
                self._degrade_counter.inc()
                if self.recorder.enabled:
                    self.recorder.instant(
                        "recovery.degraded", pid=rid, tid="recovery",
                        cat="fleet",
                        args={"requester": rid, "lost": device_id,
                              "cause": cause})
        self._schedule_placement(self._now)
        return affected

    # -------------------------------------------------------- slo feedback --
    def _slo_feedback(self) -> None:
        """Poll the SLO tracker on the wake path and propagate pressure
        transitions.  While the error budget burns (pressure > 0) every
        device's adaptation loop flips latency-first via
        ``set_pressure``, and on the rising edge the next placement
        sweep is pulled forward so offload targets refresh under load.
        Pressure is pushed only on *change*: a healthy run never calls
        ``set_pressure`` at all, keeping it bit-identical to a
        tracker-free run."""
        p = self.slo.update(self._now)
        if p == self._slo_pressure:
            return
        rising = self._slo_pressure == 0.0
        self._slo_pressure = p
        for dd in self._devices.values():
            dd.loop.set_pressure(p)
        if rising and p > 0.0:
            self._slo_counter.inc()
            self._schedule_placement(self._now)

    # ---------------------------------------------------------- placement --
    def _schedule_placement(self, when_s: float) -> None:
        """Pull the next re-placement wake forward to ``when_s`` (no-op
        when one is already due sooner, or under lockstep — where
        placement runs on the recalibration cadence instead).  Never
        pulls a sweep before the calibration warmup ends: placing on
        zero-sample calibrations would commit a blind placement that
        hysteresis then defends."""
        if self.placer is None or self.step_mode != "event":
            return
        when_s = max(when_s, self._warmup_end_s)
        if self._next_place_s is None or when_s < self._next_place_s - 1e-9:
            self._next_place_s = when_s
            self._push(when_s, _PLACEMENT_WAKE)

    def _placement_wake(self, when_s: float) -> None:
        """One popped placement heap entry.  Entries superseded by a
        pulled-forward wake are stale and skipped; a live one runs the
        fleet-wide re-placement sweep and schedules the next periodic
        wake."""
        if self._next_place_s is not None \
                and when_s < self._next_place_s - 1e-9:
            return                      # superseded by an earlier wake
        self._placement_event(self._now)
        self._next_place_s = self._now + self._place_period_s
        self._push(self._next_place_s, _PLACEMENT_WAKE)

    def _placement_event(self, now_s: float) -> None:
        """Fleet-wide re-placement sweep (a clock event): refresh every
        member's crowd calibration in the placer, re-place each live
        requester over the current fleet state, and push changed
        placements back into that device's action space as fleet-peer
        ``OffloadChoice`` targets — the optimizer then weighs them
        against local variants on its next wake."""
        if self.placer is None:
            return
        self._placement_counter.inc()
        if self.recorder.enabled:
            self.recorder.begin("placement.sweep", pid="fleet",
                                tid="placement", cat="placement",
                                args={"sweep": self._placement_counter.value})
        changed = 0
        for d in self._devices.values():
            if d.spec.device_id not in self.placer.members:
                continue
            chan = ENGINE if d.engine is not None else SIMULATED
            cal = (self.telemetry.calibration_for_tier(d.spec.tier, chan)
                   if self.share_calibration else
                   self.telemetry.calibration_for_device(
                       d.spec.device_id, chan))
            self.placer.update_member(d.spec.device_id, calibration=cal)
        for d in self._devices.values():
            if d.dropped or d.exhausted or d.failed is not None:
                continue
            did = d.spec.device_id
            prev = self.placer.current(did)
            dec = self.placer.place(did, now_s=now_s)
            if prev is not None and dec.hosts == prev.hosts:
                continue
            changed += 1
            self.placement_log.append((now_s, self.wakes, dec))
            if dec.offloaded:
                d.loop.set_offload_targets((OffloadChoice(
                    enabled=True, pool="fleet", level=self.placer.level,
                    peers=dec.hosts),))
            else:
                d.loop.set_offload_targets(())
        if self.recorder.enabled:
            self.recorder.end("placement.sweep", pid="fleet",
                              tid="placement", cat="placement",
                              args={"changed": changed})

    def _resolve_pool(self, offload):
        """Evaluator hook: fleet-peer choices resolve through the placer
        to live calibrated profiles; pool keys stay static."""
        if offload.peers and self.placer is not None:
            return self.placer.resolve_profiles(offload.peers)
        return DEVICE_POOLS[offload.pool]

    def inject_load(self, device_id: str, own_load: float) -> None:
        """Externally mark a member as (un)loaded — e.g. a helper whose
        owner started a game — and pull the next re-placement wake
        forward so the fleet reacts within a bounded number of clock
        events."""
        self._device(device_id)
        if self.placer is None:
            raise RuntimeError("placement is not enabled on this fleet")
        if self.recorder.enabled:
            self.recorder.instant("fleet.inject_load", pid="fleet",
                                  tid="control", cat="fleet",
                                  args={"device": device_id,
                                        "own_load": own_load})
        self.placer.update_member(device_id, own_load=own_load)
        self._schedule_placement(self._now)

    def drop_device(self, device_id: str) -> List[str]:
        """A member leaves the fleet mid-run — the *announced* caller of
        the shared eviction path (the failure detector is the
        *discovered* one).  Its loop stops waking; any requester whose
        placement used it falls back to local-only immediately (the
        placer rewrites their decisions) and their action spaces lose
        the dead fleet target.  Returns the affected requester ids."""
        d = self._device(device_id)
        d.dropped = True
        d.exhausted = True
        if self.detector is not None:
            # announced departures are expected silences, not failures
            self.detector.untrack(device_id)
        if self.recorder.enabled:
            self.recorder.instant("fleet.drop_device", pid="fleet",
                                  tid="control", cat="fleet",
                                  args={"device": device_id})
        return self._evict(device_id, cause="announced")

    def placement_of(self, device_id: str) -> Optional[PlacementDecision]:
        """The device's current placement decision (None before the
        first sweep or when placement is disabled)."""
        return self.placer.current(device_id) if self.placer else None

    @property
    def wakes(self) -> int:
        """Device wakes processed so far — the clock-event count used to
        bound re-placement reaction time (view over ``fleet.wakes`` in
        the metrics registry)."""
        return self._wake_counter.value

    def _next_period(self, d: _DeviceRuntime,
                     ctx: Optional[ResourceContext]) -> float:
        """Seconds until this device's next wake: DVFS-derated envelope
        period, plus the engine's measured step latency when one is
        attached (the serving hook feeding next-wake estimates)."""
        env = d.spec.tick_envelope
        derate = ctx.cpu_temp_derate if ctx is not None else 1.0
        period = env.clamp(env.nominal_s / max(derate, 1e-3))
        if d.engine is not None:
            est = getattr(d.engine, "step_time_ewma_s", None)
            if est:
                period += d.engine_steps * est
        return period

    def run_for(self, duration_s: float) -> List[FleetTickRecord]:
        """Event mode: advance the simulated clock by ``duration_s``,
        processing every device wake that falls due.  Fast devices wake
        many times per slow-device wake; devices whose traces end go
        idle without holding anyone back.  Finishes with a telemetry
        flush and recalibration so loop corrections reflect everything
        observed inside the horizon."""
        if self.step_mode != "event":
            raise RuntimeError("run_for() requires step_mode='event'; "
                               "use step()/run() under lockstep")
        horizon = self._now + duration_s
        out: List[FleetTickRecord] = []
        while self._heap and self._heap[0][0] <= horizon:
            when, seq, did = heapq.heappop(self._heap)
            if did == _DETECTOR_WAKE:
                # detector/callback wakes advance the clock but skip the
                # telemetry-flush/recalibration block below — a fault-free
                # run's calibration points stay bit-identical to a run
                # without detection
                self._now = max(self._now, when)
                self._detector_sweep()
                self._push(self._now + self._detect_period_s,
                           _DETECTOR_WAKE)
                continue
            if did == _CALLBACK_WAKE:
                self._now = max(self._now, when)
                cb = self._callbacks.pop((when, seq), None)
                if cb is not None:
                    cb()
                continue
            self._now = max(self._now, when)
            self._flush_reports(self._now)
            while self._now >= self._next_cal_s:
                self.recalibrate()
                self._next_cal_s += self._cal_period_s
            if did == _PLACEMENT_WAKE:
                self._placement_wake(when)
                continue
            d = self._devices[did]
            d.scheduled = False
            if d.exhausted:
                continue
            if d.failed is not None:
                # crashed/frozen: silent — no trace advance, no report,
                # no heartbeat, no re-push (thaw_device re-pushes)
                continue
            rec, ctx = self._advance(d, self._now)
            if self.slo is not None:
                self._slo_feedback()
            if self.detector is not None:
                edge = self.detector.beat(
                    did, self._now, period_s=self._next_period(d, ctx))
                if edge is not None:
                    self._on_recovered(d, edge)
            if d.exhausted:
                if self.detector is not None:
                    # ran out of trace: an expected silence
                    self.detector.untrack(did)
            else:
                self._push_device(d, self._now + self._next_period(d, ctx))
            if rec is not None:
                out.append(rec)
        self._now = horizon
        # every pending report was observed inside the horizon — deliver
        # even those whose jittered arrival would land past it, so the
        # closing recalibration and any post-run report see everything
        self._flush_reports(float("inf"))
        if self._now >= self._warmup_end_s:
            self.recalibrate()
        return out

    # --------------------------------------------------------------- step --
    def step(self) -> List[FleetTickRecord]:
        """One fleet step.  Lockstep: every device advances its trace by
        one context in unison.  Event: the simulated clock advances by
        one base period (the slowest member's nominal wake interval) and
        whichever wakes fall due are processed — fast devices several,
        slow devices at most one."""
        if self.step_mode == "event":
            return self.run_for(self._base_period_s)
        self._tick += 1
        out: List[FleetTickRecord] = []
        for d in self._devices.values():
            if d.exhausted:           # trace ended or drop_device()
                continue
            rec, _ = self._advance(d, float(self._tick))
            if rec is not None:
                out.append(rec)
        if self._tick >= self.warmup_ticks \
                and (self._tick - self.warmup_ticks) \
                % self.recalibrate_every == 0:
            self.recalibrate()
            if self.placer is not None:
                # under lockstep, re-placement rides the recalibration
                # cadence instead of being its own clock event
                self._placement_event(float(self._tick))
        return out

    def run(self, ticks: int) -> List[FleetTickRecord]:
        """Advance the fleet by ``ticks`` steps (see :meth:`step` for
        what one step means per mode), stopping early once every trace
        is exhausted."""
        out = []
        for _ in range(ticks):
            if all(d.exhausted for d in self._devices.values()):
                break
            out.extend(self.step())
        return out

    # -------------------------------------------------------- calibration --
    def recalibrate(self) -> None:
        """Push telemetry-fitted corrections back into every loop — tier-
        pooled (crowd-shared) or per-device, always on the device's own
        measurement channel (engine wall-times and simulated silicon live
        on unrelated scales and must never share a fit).  Crowd-measured
        task accuracy flows back the same way: the tier's per-variant
        drift-free estimates land in each evaluator's ``measured`` dict,
        so the accuracy proxy is corrected alongside latency/energy."""
        self._recal_counter.inc()
        if self.recorder.enabled:
            self.recorder.begin("fleet.recalibrate", pid="fleet",
                                tid="calibration", cat="fleet",
                                args={"round": self._recal_counter.value})
        acc_by_tier: Dict[str, Dict] = {}
        for d in self._devices.values():
            chan = ENGINE if d.engine is not None else SIMULATED
            if self.share_calibration:
                cal = self.telemetry.calibration_for_tier(d.spec.tier, chan)
            else:
                cal = self.telemetry.calibration_for_device(
                    d.spec.device_id, chan)
            if cal.samples:
                d.loop.set_calibration(cal)
            tier = d.spec.tier
            if tier not in acc_by_tier:
                acc_by_tier[tier] = \
                    self.telemetry.measured_accuracy_for_tier(tier)
            if acc_by_tier[tier]:
                d.loop.evaluator.measured.update(acc_by_tier[tier])
                d.loop.front = []
        if self.recorder.enabled:
            self.recorder.end("fleet.recalibrate", pid="fleet",
                              tid="calibration", cat="fleet")

    def calibration_of(self, device_id: str):
        return self._device(device_id).loop.evaluator.calibration

    # ------------------------------------------------------------ queries --
    def probe_loop(self, spec: DeviceSpec,
                   channel: str = SIMULATED) -> AdaptationLoop:
        """A fresh loop for this device class — no decision history, same
        SLA recipe as ``__init__``, carrying only the tier's crowd-learned
        calibration on the probe's measurement ``channel``.  What a
        brand-new fleet member would decide with.  Under
        ``share_calibration=False`` there is no crowd transfer, so the
        probe (like any new member in that regime) starts uncalibrated."""
        loop = AdaptationLoop(cfg=self.cfg, shape=self.shape, hw=spec.hw,
                              allow_offload=False)
        full = loop.evaluator.evaluate(Action(), ResourceContext(),
                                       calibrate=False)
        loop.budgets = Budgets(
            latency_s=self._budget_margin * full.latency_s,
            memory_bytes=spec.hw.hbm_bytes * spec.chips)
        if self.share_calibration:
            loop.set_calibration(
                self.telemetry.calibration_for_tier(spec.tier, channel))
        return loop

    def violations(self, tier: Optional[str] = None,
                   first_tick: int = 0, last_tick: int = 10 ** 9,
                   first_s: Optional[float] = None,
                   last_s: Optional[float] = None) -> int:
        """Count SLA violations, filtered by tier and either per-device
        tick range (``first_tick``/``last_tick``) or fleet-clock window
        (``first_s``/``last_s`` — the natural filter under event
        stepping, where tick numbers aren't comparable across devices)."""
        def keep(r: FleetTickRecord) -> bool:
            if not r.violated or (tier is not None and r.tier != tier):
                return False
            if first_s is not None and r.timestamp_s < first_s:
                return False
            if last_s is not None and r.timestamp_s > last_s:
                return False
            return first_tick <= r.tick <= last_tick
        return sum(1 for r in self.records if keep(r))
