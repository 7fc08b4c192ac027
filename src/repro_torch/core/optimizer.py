"""Two-stage runtime optimizer (paper §III-D2).

Offline: evolutionary search (NSGA-II-style nondominated sorting with
channel-wise variance / Gaussian-noise diversity injection) over the
cross-level action space, producing a Pareto front of (accuracy, energy)
— importance-free, as the paper insists.

Online: the decision variables adjust to the live context; an analytical
hierarchy process (AHP) derives the importance weights, μ = Norm(B_r)
balances accuracy vs energy, and the feasible action maximizing
μ·Norm(A) − (1−μ)·Norm(E) subject to T ≤ T_bgt, M ≤ M_bgt is selected.
"""
from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..elastic.operators import VariantSpec, variant_cost
from ..engine.remat import POLICY_LADDER, activation_bytes
from ..models.configs import InputShape, ModelConfig
from ..offload.graph_ir import build_model_graph
from ..offload.partition import pre_partition
from ..offload.placer import DEVICE_POOLS, place_dp
from .actions import Action, OffloadChoice
from .monitor import ResourceContext
from .profiler import (H100_SXM, Calibration, HardwareProfile,
                       estimate_energy, estimate_latency, layer_costs)

# the modeled accuracy cost of one unit of unmitigated data drift
# (``accuracy_of`` subtracts DRIFT_ACCURACY_COST × ctx.data_drift); the
# telemetry accuracy channel uses the same constant to back modeled
# drift out of crowd-labeled observations before pooling them
DRIFT_ACCURACY_COST = 0.10


@dataclass
class Evaluation:
    accuracy: float          # proxy or measured, higher better
    energy_j: float
    latency_s: float
    memory_bytes: float
    action: Action


# pre-partitions are pure functions of (cfg, batch, seq); memoize them so
# re-evaluating offload actions (which the fleet placer makes routine)
# doesn't rebuild the op graph on every profiler call
_PP_CACHE: Dict[tuple, object] = {}


def _prepartition(cfg: ModelConfig, batch: int, seq: int):
    key = (cfg, batch, seq)
    if key not in _PP_CACHE:
        if len(_PP_CACHE) > 64:        # bound: variant ladders are small
            _PP_CACHE.clear()
        _PP_CACHE[key] = pre_partition(
            build_model_graph(cfg, batch, seq))
    return _PP_CACHE[key]


class ActionEvaluator:
    """Maps an Action + context -> (A, E, T, M) through the profiler.

    Accuracy is a calibrated proxy: monotone in retained FLOPs, penalized
    by unmitigated data drift, with optional measured overrides (the
    benchmarks inject real accuracies for the paper-backbone model, and
    the fleet's accuracy telemetry channel feeds crowd-measured values
    back in here).

    ``pool_resolver`` maps an ``OffloadChoice`` to the device chain it
    places onto; the default resolves ``offload.pool`` in the static
    ``DEVICE_POOLS``, while a fleet-attached evaluator gets a resolver
    that synthesizes live calibrated profiles for ``offload.peers``
    chains.  A resolver returning an empty chain marks the action
    infeasible (e.g. every helper in the chain left the fleet)."""

    def __init__(self, cfg: ModelConfig, shape: InputShape,
                 hw: HardwareProfile = H100_SXM, base_accuracy: float = 0.76,
                 measured: Optional[Dict[VariantSpec, float]] = None,
                 calibration: Optional[Calibration] = None,
                 pool_resolver: Optional[Callable[
                     [OffloadChoice], Sequence]] = None):
        self.cfg = cfg
        self.shape = shape
        self.hw = hw
        self.base_accuracy = base_accuracy
        self.measured = measured or {}
        self.calibration = calibration
        self.pool_resolver = pool_resolver
        self._full = variant_cost(cfg, VariantSpec(), shape.seq_len)

    def resolve_pool(self, offload: OffloadChoice) -> Sequence:
        """The device chain an offload choice places onto (see
        ``pool_resolver``)."""
        if self.pool_resolver is not None:
            return self.pool_resolver(offload)
        return DEVICE_POOLS[offload.pool]

    def _variant_cfg(self, spec: VariantSpec) -> ModelConfig:
        c = self.cfg
        if spec.depth_ratio < 1.0:
            c = c.with_updates(num_layers=max(1, int(round(
                c.num_layers * spec.depth_ratio))))
        if spec.width_ratio < 1.0 and c.d_ff:
            c = c.with_updates(d_ff=max(8, int(c.d_ff * spec.width_ratio)
                                        // 8 * 8))
        return c

    def proxy_accuracy(self, spec: VariantSpec) -> float:
        """The drift-free analytic accuracy proxy for one variant —
        never consults ``measured`` (the telemetry accuracy channel fits
        crowd observations *against* this value)."""
        ratio = (variant_cost(self.cfg, spec, self.shape.seq_len)
                 ["flops_per_token"] / self._full["flops_per_token"])
        # empirical supernet curve: gentle until ~50% FLOPs, then steep
        return self.base_accuracy * (1.0 - 0.25 * (1 - ratio) ** 2
                                     - 0.35 * max(0.0, 0.45 - ratio))

    def accuracy_of(self, spec: VariantSpec, ctx: ResourceContext) -> float:
        a = (self.measured[spec] if spec in self.measured
             else self.proxy_accuracy(spec))
        a -= DRIFT_ACCURACY_COST * ctx.data_drift   # unmitigated drift cost
        return max(a, 0.0)

    def evaluate(self, action: Action, ctx: ResourceContext,
                 calibrate: bool = True) -> Evaluation:
        """Evaluate an action.  ``calibrate=False`` yields the raw analytic
        prediction even when a telemetry ``Calibration`` is installed —
        telemetry stores need the uncorrected value to fit against."""
        cfg = self._variant_cfg(action.variant)
        decode = self.shape.is_decode
        costs = layer_costs(cfg, self.shape.global_batch, self.shape.seq_len,
                            decode=decode)
        # engine effects on the M_l terms / ε
        eps = 0.55
        if action.engine.fuse:
            eps = 0.70                     # fusion keeps intermediates on chip
        kv_scale = 0.5 if action.engine.kv_cache_dtype == "int8" else 1.0
        if decode and kv_scale != 1.0:
            costs = [dataclasses.replace(c, bytes=c.bytes * kv_scale)
                     for c in costs]
        eff_flops = ctx.effective_flops(self.hw.peak_flops)
        lat = estimate_latency(costs, eps, self.hw, effective_flops=eff_flops)
        if action.engine.parallel_streams > 1:
            lat /= min(1.35, 1.0 + 0.35 * (action.engine.parallel_streams - 1))
        energy = estimate_energy(costs, eps, self.hw)

        # memory: params + activations (remat policy) + KV cache
        keep = dict((n, k) for n, k, _ in POLICY_LADDER)[
            action.engine.remat_policy]
        act_b = activation_bytes(cfg, self.shape.global_batch,
                                 self.shape.seq_len) * keep
        act_b /= max(action.engine.sub_batches, 1)
        if action.engine.sub_batches > 1:
            lat *= 1.0 + 0.05 * (action.engine.sub_batches - 1)
        mem = cfg.param_count() * 2 + act_b
        if decode:
            mem += cfg.kv_cache_bytes(self.shape.global_batch,
                                      self.shape.seq_len) * kv_scale

        # offloading: replace local latency with the placed pipeline's
        if action.offload.enabled:
            pp = _prepartition(cfg, 1, min(self.shape.seq_len, 512))
            devices = self.resolve_pool(action.offload)
            try:
                if not devices:
                    raise ValueError("empty device chain")
                pl = place_dp(pp, devices, level=action.offload.level)
                scale = (self.shape.global_batch * self.shape.seq_len
                         / (1 * min(self.shape.seq_len, 512)))
                lat = pl.latency_s * scale
                # the LOCAL device is what the memory budget constrains
                mem = pl.per_device_mem[0]
            except ValueError:
                lat = float("inf")
        if calibrate and self.calibration is not None \
                and not action.offload.enabled:
            lat = self.calibration.latency(lat)
            energy = self.calibration.energy(energy)
        return Evaluation(accuracy=self.accuracy_of(action.variant, ctx),
                          energy_j=energy, latency_s=lat, memory_bytes=mem,
                          action=action)


# ----------------------------------------------------- offline: Pareto -----
def nondominated_front(evals: Sequence[Evaluation]) -> List[Evaluation]:
    """Pareto front over (maximize accuracy, minimize energy) — no
    importance coefficients, per the paper."""
    front = []
    for e in evals:
        dominated = False
        for f in evals:
            if f is e:
                continue
            if (f.accuracy >= e.accuracy and f.energy_j <= e.energy_j
                    and (f.accuracy > e.accuracy or f.energy_j < e.energy_j)):
                dominated = True
                break
        if not dominated:
            front.append(e)
    return sorted(front, key=lambda e: -e.accuracy)


def mutate_spec(spec: VariantSpec, rng: random.Random) -> VariantSpec:
    """Diversity injection: channel-wise variance + Gaussian noise on the
    continuous knobs (paper's candidate-diversity enhancement)."""
    def jitter(x, lo, hi, s=0.1):
        return float(np.clip(x + rng.gauss(0, s), lo, hi))
    return VariantSpec(
        rank_ratio=round(jitter(spec.rank_ratio, 0.25, 1.0), 2),
        kv_merge=spec.kv_merge if rng.random() > 0.2 else
        rng.choice((1, 2)),
        ghost=spec.ghost if rng.random() > 0.2 else not spec.ghost,
        depth_ratio=round(jitter(spec.depth_ratio, 0.25, 1.0), 2),
        width_ratio=round(jitter(spec.width_ratio, 0.25, 1.0), 2),
        head_ratio=spec.head_ratio,
        window=spec.window)


def evolve_pareto(evaluator: ActionEvaluator, seed_actions: Sequence[Action],
                  ctx: ResourceContext, generations: int = 6,
                  population: int = 32, seed: int = 0) -> List[Evaluation]:
    """Offline evolutionary stage: static problem, broad exploration."""
    rng = random.Random(seed)
    pop = list(seed_actions)[:population]
    while len(pop) < population:
        base = rng.choice(seed_actions)
        pop.append(dataclasses.replace(
            base, variant=mutate_spec(base.variant, rng)))
    for _ in range(generations):
        evals = [evaluator.evaluate(a, ctx) for a in pop]
        front = nondominated_front(evals)
        parents = [e.action for e in front] or pop[:4]
        children = []
        while len(children) + len(parents) < population:
            p = rng.choice(parents)
            children.append(dataclasses.replace(
                p, variant=mutate_spec(p.variant, rng)))
        pop = parents + children
    final = [evaluator.evaluate(a, ctx) for a in pop]
    return nondominated_front(final)


# ------------------------------------------------------- online: AHP + μ ---
def ahp_weights(pairwise: np.ndarray) -> np.ndarray:
    """Principal-eigenvector weights from a pairwise comparison matrix."""
    vals, vecs = np.linalg.eig(pairwise)
    w = np.abs(np.real(vecs[:, np.argmax(np.real(vals))]))
    return w / w.sum()


def context_ahp(ctx: ResourceContext) -> np.ndarray:
    """Importance of (accuracy, energy, latency, memory) given the context.
    Battery low -> energy dominates; memory scarce -> memory dominates."""
    a_vs_e = max(0.2, 5.0 * ctx.battery_frac)       # rich battery favors A
    a_vs_m = max(0.2, 5.0 * ctx.mem_free_frac)
    a_vs_t = 1.0 / max(ctx.request_rate, 0.25)
    m = np.array([
        [1.0,       a_vs_e,    a_vs_t,   a_vs_m],
        [1/a_vs_e,  1.0,       1.0,      1.0],
        [1/a_vs_t,  1.0,       1.0,      1.0],
        [1/a_vs_m,  1.0,       1.0,      1.0]])
    return ahp_weights(m)


@dataclass
class Budgets:
    latency_s: float = float("inf")
    memory_bytes: float = float("inf")


def select_online(front: Sequence[Evaluation], ctx: ResourceContext,
                  budgets: Budgets) -> Optional[Evaluation]:
    """μ = Norm(B_r); score = μ·Norm(A) − (1−μ)·Norm(E) over feasible set."""
    feasible = [e for e in front
                if e.latency_s <= budgets.latency_s
                and e.memory_bytes <= budgets.memory_bytes]
    pool = feasible or None
    if pool is None:
        # constraint relaxation: fall back to minimum-violation action
        def viol(e):
            return (max(0.0, e.latency_s / budgets.latency_s - 1)
                    + max(0.0, e.memory_bytes / budgets.memory_bytes - 1))
        return min(front, key=viol) if front else None
    mu = float(np.clip(ctx.battery_frac, 0.05, 0.95))
    accs = np.array([e.accuracy for e in pool])
    ens = np.array([e.energy_j for e in pool])
    def norm(x):
        lo, hi = float(x.min()), float(x.max())
        return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
    w = context_ahp(ctx)
    lat = np.array([e.latency_s for e in pool])
    mem = np.array([e.memory_bytes for e in pool])
    score = mu * norm(accs) - (1 - mu) * norm(ens) \
        - w[2] * norm(lat) - w[3] * norm(mem)
    return pool[int(np.argmax(score))]
