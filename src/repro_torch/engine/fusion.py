"""Runtime operator fusion — the engine's five strategies (paper §III-C1 ❶).

The engine classifies ops by input→output mapping and progressively attempts
fusion across types, extending the offload component's generic chain fusion
with strategy-targeted passes.  Each pass reports the memory traffic it
eliminates (intermediate feature-map bytes) — that number feeds the
profiler's M_l terms, closing the paper's back-to-front feedback loop.

In the port the same decisions surface as hand-written kernels: on the
card the fused gated-FFN kernel (K3) and the flash-attention kernel (K2)
replace the unfused chains whatever ``use_pallas`` says.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.offload import transform as T
from repro_torch.offload.graph_ir import Graph, OpNode
from repro_torch.offload.transform import (eliminate_duplicates,
                                           fuse_linear_chains)

STRATEGIES = ("linear", "conv_norm", "elementwise", "channelwise", "reduction")


@dataclass
class FusionReport:
    strategy: str
    ops_before: int
    ops_after: int
    bytes_saved: int        # intermediate tensors no longer materialized

    @property
    def ops_fused(self) -> int:
        return self.ops_before - self.ops_after


def _classify(n: OpNode) -> str:
    """Classify by input->output mapping (the paper's fusion taxonomy)."""
    if n.kind in ("matmul",):
        return "linear"
    if n.kind in ("conv",):
        return "conv_norm"
    if n.kind in ("act", "add", "mul"):
        return "elementwise"
    if n.kind in ("norm", "softmax"):
        return "channelwise"
    if n.kind in ("reduce",):
        return "reduction"
    return "opaque"


def fuse_graph(graph: Graph, strategies: Tuple[str, ...] = STRATEGIES
               ) -> Tuple[Graph, List[FusionReport]]:
    """Progressively apply fusion strategies; report per-strategy savings."""
    reports: List[FusionReport] = []
    g = graph
    before_bytes = _intermediate_bytes(g)
    for strat in strategies:
        ops_before = len(g.nodes)
        g2 = _apply_strategy(g, strat)
        saved = _intermediate_bytes(g) - _intermediate_bytes(g2)
        reports.append(FusionReport(strategy=strat, ops_before=ops_before,
                                    ops_after=len(g2.nodes),
                                    bytes_saved=max(0, saved)))
        g = g2
    return g, reports


def _apply_strategy(graph: Graph, strategy: str) -> Graph:
    # all strategies reduce to targeted chain fusion over their op classes;
    # the generic fuser already walks matmul/conv heads, so strategies
    # narrow WHICH tails fuse by temporarily filtering eligibility.
    saved_tail, saved_bin = T.FUSABLE_TAIL, T.FUSABLE_BIN
    try:
        if strategy == "linear":
            T.FUSABLE_TAIL, T.FUSABLE_BIN = ("act",), ("add",)
        elif strategy == "conv_norm":
            T.FUSABLE_TAIL, T.FUSABLE_BIN = ("norm",), ()
        elif strategy == "elementwise":
            T.FUSABLE_TAIL, T.FUSABLE_BIN = ("act",), ("add", "mul")
        elif strategy == "channelwise":
            T.FUSABLE_TAIL, T.FUSABLE_BIN = ("norm", "softmax"), ()
        elif strategy == "reduction":
            T.FUSABLE_TAIL, T.FUSABLE_BIN = ("reduce",), ()
        return fuse_linear_chains(graph)
    finally:
        T.FUSABLE_TAIL, T.FUSABLE_BIN = saved_tail, saved_bin


def _intermediate_bytes(graph: Graph) -> int:
    outs = set(graph.outputs)
    return sum(n.out_bytes for n in graph.nodes if n.output not in outs)


def fusion_memory_saving(graph: Graph) -> Dict[str, int]:
    """bytes saved per strategy if applied alone (for optimizer napkin math)."""
    out = {}
    for s in STRATEGIES:
        g2 = _apply_strategy(graph, s)
        out[s] = max(0, _intermediate_bytes(graph) - _intermediate_bytes(g2))
    return out
