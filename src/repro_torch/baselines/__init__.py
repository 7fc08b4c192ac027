"""Baselines from the paper's evaluation (§IV-A), adapted to the
transformer substrate.

Handcrafted compression:
  * Fire / SqueezeNet  -> fixed squeeze-expand (KV merge + width 0.5)
  * SVD                -> fixed low-rank factorization (rank 0.5)
  * MobileNetV2        -> fixed inverted-bottleneck analogue (rank 0.75 +
                          ghost features)
On-demand compression:
  * AdaDeep            -> greedy operator combination under a latency budget
  * Once-for-all (OFA) -> supernet sampling, best accuracy under constraint
Partition/offloading baselines (CAS, DADS) live in the port's
``offload.placer``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.core.actions import Action
from repro_torch.core.monitor import ResourceContext
from repro_torch.core.optimizer import ActionEvaluator
from repro_torch.elastic.operators import FULL_SPEC, VariantSpec
from repro_torch.models.configs import InputShape, ModelConfig

HANDCRAFTED: Dict[str, VariantSpec] = {
    "fire": VariantSpec(kv_merge=2, width_ratio=0.5),
    "svd": VariantSpec(rank_ratio=0.5),
    "mobilenetv2": VariantSpec(rank_ratio=0.75, ghost=True),
}


def adadeep_select(cfg: ModelConfig, shape: InputShape,
                   latency_budget_s: float,
                   evaluator: Optional[ActionEvaluator] = None,
                   ctx: Optional[ResourceContext] = None) -> VariantSpec:
    """AdaDeep: greedily stack compression operators until the latency
    budget is met, preferring the operator with the best predicted
    accuracy-per-latency gain (a meta-learner in the paper; a profiler-
    guided greedy here)."""
    ev = evaluator or ActionEvaluator(cfg, shape)
    ctx = ctx or ResourceContext()
    steps = [
        VariantSpec(rank_ratio=0.5),
        VariantSpec(width_ratio=0.75),
        VariantSpec(width_ratio=0.5),
        VariantSpec(depth_ratio=0.75),
        VariantSpec(depth_ratio=0.5),
    ]
    cur = FULL_SPEC
    for _ in range(4):
        e = ev.evaluate(Action(variant=cur), ctx)
        if e.latency_s <= latency_budget_s:
            break
        best, best_gain = None, -1e30
        for s in steps:
            cand = VariantSpec(
                rank_ratio=min(cur.rank_ratio, s.rank_ratio),
                width_ratio=min(cur.width_ratio, s.width_ratio),
                depth_ratio=min(cur.depth_ratio, s.depth_ratio),
                ghost=cur.ghost or s.ghost,
                kv_merge=max(cur.kv_merge, s.kv_merge))
            ce = ev.evaluate(Action(variant=cand), ctx)
            gain = (e.latency_s - ce.latency_s) / max(
                e.accuracy - ce.accuracy, 1e-4)
            if gain > best_gain:
                best, best_gain = cand, gain
        cur = best
    return cur


def ofa_select(cfg: ModelConfig, shape: InputShape, latency_budget_s: float,
               candidates: Sequence[VariantSpec],
               evaluator: Optional[ActionEvaluator] = None) -> VariantSpec:
    """Once-for-all: pick the highest-accuracy subnetwork meeting the
    budget from a pre-enumerated supernet grid."""
    ev = evaluator or ActionEvaluator(cfg, shape)
    ctx = ResourceContext()
    feasible = []
    for spec in candidates:
        e = ev.evaluate(Action(variant=spec), ctx)
        if e.latency_s <= latency_budget_s:
            feasible.append((e.accuracy, spec))
    if not feasible:
        return min(candidates,
                   key=lambda s: ev.evaluate(Action(variant=s),
                                             ctx).latency_s)
    return max(feasible, key=lambda t: t[0])[1]
