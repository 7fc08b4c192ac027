"""The automated cross-level co-adaptation loop (paper §III-D, Fig. 6).

monitor → profiler → (violation | drift | context change?) → optimizer →
apply (θ_p variant switch, θ_o re-placement, θ_s engine reconfig) — at a
fixed tick frequency.  On-device execution is preferred;
offloading engages only when local resources cannot meet the budgets,
mirroring the paper's policy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..elastic.operators import FULL_SPEC, VariantSpec
from ..elastic.supernet import ElasticSupernet
from ..engine.schedule import EngineConfig
from ..models.configs import InputShape, ModelConfig
from ..obs import NULL_RECORDER
from .actions import Action, OffloadChoice, default_action_space
from .monitor import ResourceContext, ResourceMonitor
from .optimizer import (ActionEvaluator, Budgets, Evaluation, evolve_pareto,
                        nondominated_front, select_online)
from .profiler import H100_SXM, Calibration, HardwareProfile


@dataclass
class Decision:
    tick: int
    ctx: ResourceContext
    action: Action
    eval: Evaluation
    reason: str


@dataclass
class AdaptationLoop:
    cfg: ModelConfig
    shape: InputShape
    supernet: Optional[ElasticSupernet] = None
    hw: HardwareProfile = H100_SXM
    budgets: Budgets = field(default_factory=Budgets)
    measured_accuracy: Dict[VariantSpec, float] = field(default_factory=dict)
    allow_offload: bool = True
    hysteresis: float = 0.05        # don't switch for <5% predicted gain
    # observability hooks: the fleet controller installs its recorder and
    # the owning device's id, so each decision lands as a loop.decide
    # trace instant on that device's track
    recorder: object = None
    obs_pid: str = "loop"

    def __post_init__(self):
        if self.recorder is None:
            self.recorder = NULL_RECORDER
        self.monitor = ResourceMonitor()
        self.evaluator = ActionEvaluator(self.cfg, self.shape, self.hw,
                                         measured=self.measured_accuracy)
        variants = (self.supernet.action_space() if self.supernet
                    else (FULL_SPEC,
                          VariantSpec(depth_ratio=0.75),
                          VariantSpec(width_ratio=0.5),
                          VariantSpec(rank_ratio=0.5, width_ratio=0.5)))
        self._variants = tuple(variants)
        self.actions = default_action_space(
            variants, allow_offload=self.allow_offload,
            decode=self.shape.is_decode)
        self._base_actions = self.actions
        self.front: List[Evaluation] = []
        self.current: Optional[Decision] = None
        self.decisions: List[Decision] = []
        self._tick = 0
        # SLO burn-rate pressure (0.0 = healthy).  Set by the fleet
        # controller while an SLO is burning; tick() then short-circuits
        # to the cheapest variant instead of the accuracy-first policy.
        self._pressure = 0.0

    # ----------------------------------------------------- slo pressure --
    def set_pressure(self, p: float) -> None:
        """Install (or clear, with 0.0) SLO burn-rate pressure.  The
        healthy path is untouched while pressure is zero — SLO-healthy
        runs stay bit-identical to pressure-free ones."""
        self._pressure = float(p)

    @property
    def pressure(self) -> float:
        return self._pressure

    # --------------------------------------------------- placement targets --
    def set_offload_targets(self, choices: Sequence[OffloadChoice]) -> None:
        """Install fleet-peer offload targets into the action space.

        Each choice (typically one ``OffloadChoice`` with ``peers`` set,
        produced by the fleet placer) is crossed with the loop's variant
        ladder and appended to the static action space; previous fleet
        targets are replaced and the Pareto front invalidated.  An empty
        sequence strips fleet targets (back to static pools only)."""
        extra = tuple(Action(variant=v, offload=ch,
                             engine=EngineConfig(fuse=True))
                      for ch in choices for v in self._variants)
        self.actions = self._base_actions + extra
        self.front = []

    def abandon_current(self) -> None:
        """Forget the held decision.  Failure-path only: hysteresis
        re-evaluates the incumbent action each tick, so a decision whose
        offload chain just died would otherwise survive as "hold" even
        after its fleet targets were stripped from the action space."""
        self.current = None

    # ------------------------------------------------------- calibration --
    def set_calibration(self, cal: Optional[Calibration]) -> None:
        """Install a telemetry-derived correction into the evaluator and
        invalidate the Pareto front (its stored latencies/energies were
        computed under the previous correction)."""
        self.evaluator.calibration = cal
        self.front = []

    # ---------------------------------------------------------- offline ---
    def build_pareto(self, ctx: Optional[ResourceContext] = None,
                     evolve: bool = True) -> List[Evaluation]:
        ctx = ctx or ResourceContext()
        evals = [self.evaluator.evaluate(a, ctx) for a in self.actions]
        self.front = nondominated_front(evals)
        if evolve:
            # evolutionary refinement around the seed front
            refined = evolve_pareto(self.evaluator,
                                    [e.action for e in self.front] or
                                    list(self.actions)[:8], ctx)
            self.front = nondominated_front(list(self.front) + list(refined))
        return self.front

    # ----------------------------------------------------------- online ---
    def tick(self, ctx: ResourceContext) -> Decision:
        """One adaptation-loop iteration."""
        self.monitor.set(ctx)
        self._tick += 1
        budgets = Budgets(
            latency_s=self.budgets.latency_s,
            memory_bytes=min(self.budgets.memory_bytes,
                             ctx.mem_budget_bytes(
                                 self.hw.hbm_bytes * ctx.chips_available)))
        if not self.front:
            self.build_pareto(ctx, evolve=False)

        if self._pressure > 0.0:
            # SLO burn feedback: while the error budget is burning, the
            # objective flips from accuracy-first to latency-first —
            # take the *cheapest* variant on the front (local preferred)
            # and skip hysteresis, which would otherwise defend the
            # expensive incumbent against a <5%-gain downshift.
            pool = ([e for e in self.front if not e.action.offload.enabled]
                    or list(self.front))
            cheap = min(pool, key=lambda e: (e.latency_s, e.energy_j))
            choice = self.evaluator.evaluate(cheap.action, ctx)
            d = Decision(tick=self._tick, ctx=ctx, action=choice.action,
                         eval=choice, reason="slo_pressure")
            if self.recorder.enabled:
                self.recorder.instant(
                    "loop.decide", pid=self.obs_pid, tid="loop",
                    cat="fleet",
                    args={"tick": self._tick, "reason": "slo_pressure",
                          "pressure": self._pressure,
                          "variant": str(choice.action.variant),
                          "offloaded": choice.action.offload.enabled,
                          "latency_s": choice.latency_s,
                          "accuracy": choice.accuracy})
            self.current = d
            self.decisions.append(d)
            return d

        # prefer local: filter offloaded actions unless local infeasible
        local = [e for e in self.front if not e.action.offload.enabled]
        choice = select_online(local, ctx, budgets)
        reason = "local"
        if choice is None or choice.latency_s > budgets.latency_s \
                or choice.memory_bytes > budgets.memory_bytes:
            full = select_online(self.front, ctx, budgets)
            if full is not None:
                choice, reason = full, "offloaded (local infeasible)"
        if choice is None:
            raise RuntimeError("no action available")
        # re-evaluate under the live context (DVFS derate etc.)
        choice = self.evaluator.evaluate(choice.action, ctx)

        if self.current is not None:
            cur = self.evaluator.evaluate(self.current.action, ctx)
            cur_feasible = (cur.latency_s <= budgets.latency_s
                            and cur.memory_bytes <= budgets.memory_bytes)
            gain = (choice.accuracy - cur.accuracy) \
                + (cur.energy_j - choice.energy_j) / max(cur.energy_j, 1e-9)
            if cur_feasible and gain < self.hysteresis:
                choice, reason = cur, "hold (hysteresis)"
        d = Decision(tick=self._tick, ctx=ctx, action=choice.action,
                     eval=choice, reason=reason)
        if self.recorder.enabled:
            self.recorder.instant(
                "loop.decide", pid=self.obs_pid, tid="loop", cat="fleet",
                args={"tick": self._tick, "reason": reason,
                      "variant": str(choice.action.variant),
                      "offloaded": choice.action.offload.enabled,
                      "latency_s": choice.latency_s,
                      "accuracy": choice.accuracy})
        self.current = d
        self.decisions.append(d)
        return d

    def run_trace(self, trace) -> List[Decision]:
        return [self.tick(ctx) for ctx in trace]

    def materialize(self):
        """Return (variant_cfg, variant_params, runtime_options) for the
        currently selected action (requires a supernet)."""
        if self.current is None or self.supernet is None:
            raise RuntimeError("no decision or no supernet attached")
        a = self.current.action
        vcfg, vparams = self.supernet.variant(a.variant)
        return vcfg, vparams, a.engine.to_runtime_options()
