"""Tensor-lifetime-aware memory allocation (paper §III-C1 ❸).

From the computation graph's topological order we derive each tensor's
[first-def, last-use] lifetime interval, build global lifecycle constraints
(operator dependencies), and run a best-fit offset allocator with idle-block
reuse — the heuristic conflict-resolution step of the paper.  Outputs a
static allocation plan (tensor → offset) and the peak arena size, compared
against the no-reuse baseline.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.offload.graph_ir import Graph


@dataclass
class Lifetime:
    tensor: str
    size: int
    start: int     # producing step
    end: int       # last consuming step (inclusive)


@dataclass
class AllocationPlan:
    offsets: Dict[str, int]
    peak_bytes: int
    naive_bytes: int
    lifetimes: List[Lifetime]

    @property
    def reuse_ratio(self) -> float:
        return self.peak_bytes / max(self.naive_bytes, 1)

    def validate(self) -> None:
        """No two temporally-overlapping tensors may overlap in address."""
        lt = {l.tensor: l for l in self.lifetimes}
        items = list(self.offsets.items())
        for i, (t1, o1) in enumerate(items):
            for t2, o2 in items[i + 1:]:
                a, b = lt[t1], lt[t2]
                time_overlap = not (a.end < b.start or b.end < a.start)
                addr_overlap = not (o1 + a.size <= o2 or o2 + b.size <= o1)
                if time_overlap and addr_overlap:
                    raise AssertionError(
                        f"overlap: {t1}@{o1}+{a.size} vs {t2}@{o2}+{b.size}")


def tensor_lifetimes(graph: Graph, donate_inputs: bool = False
                     ) -> List[Lifetime]:
    order = graph.toposort()
    step_of = {n.output: i for i, n in enumerate(order)}
    last_use: Dict[str, int] = {}
    for i, n in enumerate(order):
        for inp in n.inputs:
            last_use[inp] = i
    for o in graph.outputs:
        last_use[o] = len(order)  # outputs live to the end
    lts = []
    for n in order:
        if n.kind == "const":
            continue  # weights/constants live in the param arena
        end = last_use.get(n.output, step_of[n.output])
        lts.append(Lifetime(tensor=n.output, size=max(n.out_bytes, 1),
                            start=step_of[n.output], end=end))
    return lts


def plan_memory(graph: Graph, alignment: int = 512) -> AllocationPlan:
    """Best-fit-with-reuse offset assignment over lifetime intervals.

    Tensors are placed in order of decreasing size (classic offset
    allocation); each placement scans existing allocations that overlap in
    time and picks the lowest gap that fits (idle-block reuse priority,
    paper ❸)."""
    lts = tensor_lifetimes(graph)
    naive = sum(l.size for l in lts)
    placed: List[Tuple[Lifetime, int]] = []
    offsets: Dict[str, int] = {}
    for l in sorted(lts, key=lambda x: (-x.size, x.start)):
        conflicts = [(off, p.size) for p, off in placed
                     if not (p.end < l.start or l.end < p.start)]
        conflicts.sort()
        best: Optional[int] = None
        cursor = 0
        for off, size in conflicts:
            if off - cursor >= l.size:
                best = cursor
                break
            cursor = max(cursor, off + size)
            cursor = (cursor + alignment - 1) // alignment * alignment
        if best is None:
            best = cursor
        offsets[l.tensor] = best
        placed.append((l, best))
    peak = max((off + l.size for l, off in placed), default=0)
    plan = AllocationPlan(offsets=offsets, peak_bytes=peak,
                          naive_bytes=naive, lifetimes=lts)
    plan.validate()
    return plan


def greedy_no_reuse(graph: Graph) -> int:
    """Baseline: every tensor gets fresh memory (what the paper compares
    its allocator against)."""
    return sum(l.size for l in tensor_lifetimes(graph))


def peak_live_bytes(graph: Graph) -> int:
    """Information-theoretic lower bound: max over time of live bytes."""
    lts = tensor_lifetimes(graph)
    horizon = max((l.end for l in lts), default=0) + 1
    live = [0] * (horizon + 1)
    for l in lts:
        for t in range(l.start, min(l.end, horizon) + 1):
            live[t] += l.size
    return max(live, default=0)
