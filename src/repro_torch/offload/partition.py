"""Operator-based DL model pre-partitioning (paper §III-B1).

Hierarchical hybrid granularity: the graph is decoupled bottom-up into
  level-0  minimal operator units (IR nodes)
  level-1  sublayer flows (attention / ffn / mamba of one layer)
  level-2  layers
  level-3  coarse stages (layer ranges)
independently of any latency requirement or device profile — partitioning
is *decoupled* from the offloading search, which later just combines
pre-partitioned units (the paper's key universality claim).  Topological
sorting yields independent operation flows; a sparse tensor↔op incidence
map records the cut tensors each boundary would transfer.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph_ir import Graph, OpNode


@dataclass(frozen=True)
class Unit:
    """A partitionable unit: a contiguous set of ops with one entry/exit."""
    name: str
    node_names: Tuple[str, ...]
    flops: float
    param_bytes: int
    peak_act_bytes: int
    boundary_bytes: int         # bytes crossing if cut AFTER this unit
    level: int                  # granularity level (0..3)


@dataclass
class PrePartition:
    graph: Graph
    levels: Dict[int, List[Unit]]          # granularity -> ordered units
    incidence: Dict[str, Tuple[str, ...]]  # tensor -> consumer op names

    def units(self, level: int) -> List[Unit]:
        return self.levels[level]

    def cut_points(self, level: int) -> List[int]:
        """Indices i such that cutting after unit i is legal (all are, for
        the sequential flows produced by topological decoupling)."""
        return list(range(len(self.levels[level]) - 1))


def _boundary_bytes(graph: Graph, covered: set, order: Sequence[OpNode]) -> int:
    """Bytes of tensors produced inside `covered` consumed outside it."""
    produced = {n.output for n in order if n.output in covered}
    out = 0
    for n in order:
        if n.output in covered:
            continue
        for i in n.inputs:
            if i in produced:
                out += graph.tensors.get(i, 0)
                produced.discard(i)  # count each tensor once
    for o in graph.outputs:
        if o in produced:
            out += graph.tensors.get(o, 0)
    return out


def _make_units(graph: Graph, groups: List[List[OpNode]], level: int,
                prefix: str) -> List[Unit]:
    order = graph.toposort()
    units = []
    covered: set = set()
    for gi, grp in enumerate(groups):
        covered |= {n.output for n in grp}
        units.append(Unit(
            name=f"{prefix}{gi}",
            node_names=tuple(n.output for n in grp),
            flops=sum(n.flops for n in grp),
            param_bytes=sum(n.param_bytes for n in grp),
            peak_act_bytes=max((n.out_bytes for n in grp), default=0),
            boundary_bytes=_boundary_bytes(graph, covered, order),
            level=level))
    return units


def pre_partition(graph: Graph, coarse_stages: int = 8) -> PrePartition:
    order = graph.toposort()
    # level 0: each op is a unit
    l0 = _make_units(graph, [[n] for n in order], 0, "op")
    # level 1: (layer, sublayer) flows; out-of-layer ops attach to neighbors
    flows: List[List[OpNode]] = []
    keymap: Dict[Tuple[int, str], int] = {}
    for n in order:
        key = (n.layer, n.sublayer)
        if n.layer < 0:
            # pre/post ops (embed, final norm, head) join the adjacent flow
            if not flows:
                flows.append([])
            flows[-1].append(n)
            continue
        if key not in keymap:
            keymap[key] = len(flows)
            flows.append([])
        flows[keymap[key]].append(n)
    l1 = _make_units(graph, flows, 1, "flow")
    # level 2: whole layers
    layers: List[List[OpNode]] = []
    lmap: Dict[int, int] = {}
    for n in order:
        if n.layer < 0:
            if not layers:
                layers.append([])
            layers[-1].append(n)
            continue
        if n.layer not in lmap:
            lmap[n.layer] = len(layers)
            layers.append([])
        layers[lmap[n.layer]].append(n)
    l2 = _make_units(graph, layers, 2, "layer")
    # level 3: coarse stages of roughly equal FLOPs
    total = sum(n.flops for n in order)
    per = total / coarse_stages if coarse_stages else total
    stages: List[List[OpNode]] = [[]]
    acc = 0.0
    for grp in layers:
        stages[-1].extend(grp)
        acc += sum(n.flops for n in grp)
        if acc >= per and len(stages) < coarse_stages:
            stages.append([])
            acc = 0.0
    if not stages[-1]:
        stages.pop()
    l3 = _make_units(graph, stages, 3, "stage")

    incidence = {t: tuple(c.output for c in cons)
                 for t, cons in graph.consumers().items()}
    return PrePartition(graph=graph, levels={0: l0, 1: l1, 2: l2, 3: l3},
                        incidence=incidence)


def independent_flows(graph: Graph) -> List[List[str]]:
    """Topologically independent op chains that may execute in parallel
    (the paper's 'independent operation flows' for operator parallelism).
    Two ops are in the same flow iff connected via producer/consumer edges
    at the same topological frontier."""
    order = graph.toposort()
    depth: Dict[str, int] = {}
    for n in order:
        depth[n.output] = 1 + max([depth.get(i, 0) for i in n.inputs] or [0])
    levels: Dict[int, List[str]] = {}
    for n in order:
        levels.setdefault(depth[n.output], []).append(n.output)
    return [levels[d] for d in sorted(levels)]
