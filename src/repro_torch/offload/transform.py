"""Redundancy-aware cross-platform model transformation (paper §III-B2).

Two-stage conversion over the IR:
  Stage 1 — dependency/data-flow analysis: operator fusion opportunities
            (matmul+bias+act chains, norm folding) and duplicate-operator
            elimination (CSE), computation-preserving.
  Stage 2 — global traversal classifying ops as dynamic vs constant;
            constant subgraphs are folded to precomputed values, redundant
            constants removed, dead ops eliminated.

Each pass returns a new Graph; semantic equivalence is checked by tests
against the executable interpreter (the paper's "guarantees that critical
computational steps are preserved").
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .graph_ir import Graph, OpNode, execute

FUSABLE_TAIL = ("act", "norm", "reduce")
FUSABLE_BIN = ("add", "mul")


def _rewrite_inputs(nodes: List[OpNode], mapping: Dict[str, str]) -> None:
    for n in nodes:
        n.inputs = tuple(mapping.get(i, i) for i in n.inputs)


# ----------------------------------------------------------- stage 1: fuse --
def fuse_linear_chains(graph: Graph) -> Graph:
    """Fuse matmul -> (add|mul|act|norm|reduce)* single-consumer chains into
    one fused op (strategies ❶ linear, ❷ conv/norm, ❸ element-wise,
    ❹ channel-wise, ❺ reduction — all realized as chain fusion over the
    respective op kinds)."""
    cons = graph.consumers()
    node_of = graph.node_map()
    fused_away: set = set()
    new_nodes: List[OpNode] = []
    for n in graph.toposort():
        if n.output in fused_away:
            continue
        if n.kind not in ("matmul", "conv"):
            new_nodes.append(OpNode(**vars(n)))
            continue
        # walk the single-consumer chain
        chain = [n]
        cur = n
        while True:
            cs = cons.get(cur.output, [])
            if len(cs) != 1:
                break
            nxt = cs[0]
            if nxt.kind in FUSABLE_TAIL:
                chain.append(nxt)
                cur = nxt
            elif nxt.kind in FUSABLE_BIN and all(
                    (i == cur.output or i not in node_of
                     or node_of[i].constant or node_of[i].kind == "const"
                     or node_of[i].kind == "matmul")
                    for i in nxt.inputs):
                # binary with the chain output + const/param-like operand:
                # only fuse when the other operand is produced before the
                # chain head (no cycle); conservatively require const
                other = [i for i in nxt.inputs if i != cur.output]
                if all(i not in node_of or node_of[i].kind == "const"
                       for i in other):
                    chain.append(nxt)
                    cur = nxt
                else:
                    break
            else:
                break
        if len(chain) == 1:
            new_nodes.append(OpNode(**vars(n)))
            continue
        head = {"kind": n.kind}
        head.update({k: v for k, v in n.attrs.items() if k in ("fn", "axis")})
        recipe = [head]
        extra_inputs: List[str] = list(n.inputs)
        for step in chain[1:]:
            entry = {"kind": step.kind}
            entry.update({k: v for k, v in step.attrs.items()
                          if k in ("fn", "axis")})
            recipe.append(entry)
            # binary steps consume inputs POSITIONALLY in recipe order, so
            # duplicates are appended again (e.g. the same const twice)
            for i in step.inputs:
                if i not in [c.output for c in chain]:
                    extra_inputs.append(i)
            fused_away.add(step.output)
        tail = chain[-1]
        new_nodes.append(OpNode(
            name=f"fused:{n.name}+{len(chain)-1}",
            kind="fused", inputs=tuple(extra_inputs), output=tail.output,
            flops=sum(c.flops for c in chain),
            param_bytes=sum(c.param_bytes for c in chain),
            out_bytes=tail.out_bytes,
            attrs={"recipe": recipe, "head_kind": n.kind},
            layer=n.layer, sublayer=n.sublayer))
    g = Graph(nodes=new_nodes, inputs=graph.inputs, outputs=graph.outputs,
              tensors=dict(graph.tensors))
    g.validate()
    return g


def eliminate_duplicates(graph: Graph) -> Graph:
    """CSE: ops with identical (kind, inputs, attrs) compute the same tensor;
    keep the first, rewire consumers (the paper's duplicate-operator
    removal after framework conversion)."""
    seen: Dict[str, str] = {}
    mapping: Dict[str, str] = {}
    new_nodes: List[OpNode] = []
    for n in graph.toposort():
        inputs = tuple(mapping.get(i, i) for i in n.inputs)
        sig_attrs = {k: v for k, v in n.attrs.items() if k != "value"}
        if n.kind == "const":
            v = np.asarray(n.attrs.get("value"))
            sig_attrs["value_hash"] = hashlib.sha1(
                v.tobytes() + str(v.shape).encode()).hexdigest()
        sig = f"{n.kind}|{inputs}|{sorted(sig_attrs.items())!r}"
        if n.kind != "input" and sig in seen:
            mapping[n.output] = seen[sig]
            continue
        seen[sig] = n.output
        m = OpNode(**vars(n))
        m.inputs = inputs
        new_nodes.append(m)
    g = Graph(nodes=new_nodes, inputs=graph.inputs,
              outputs=tuple(mapping.get(o, o) for o in graph.outputs),
              tensors=dict(graph.tensors))
    g.validate()
    return g


# ------------------------------------------------- stage 2: constants/dead --
def classify_constants(graph: Graph) -> Dict[str, bool]:
    """Global traversal: an op is constant iff all its inputs are constants
    (paper: 'operators classified as dynamic or constant')."""
    const: Dict[str, bool] = {}
    for i in graph.inputs:
        const[i] = False
    for n in graph.toposort():
        if n.kind == "const":
            const[n.output] = True
        else:
            const[n.output] = all(const.get(i, False) for i in n.inputs) \
                and len(n.inputs) > 0
    return const


def fold_constants(graph: Graph,
                   params: Optional[Dict[str, np.ndarray]] = None) -> Graph:
    """Replace constant subgraphs by precomputed const nodes."""
    constness = classify_constants(graph)
    node_of = graph.node_map()
    # evaluate maximal constant frontier
    foldable = [n for n in graph.toposort()
                if constness[n.output] and n.kind != "const"]
    if not foldable:
        return graph
    env: Dict[str, np.ndarray] = {}
    for n in graph.toposort():
        if n.kind == "const":
            env[n.output] = np.asarray(n.attrs["value"])
    sub = Graph(nodes=[n for n in graph.nodes
                       if constness[n.output]],
                inputs=(), outputs=tuple(n.output for n in foldable),
                tensors=graph.tensors)
    vals = execute(sub, {}, params or {})
    new_nodes = []
    for n in graph.nodes:
        if n.output in vals:
            new_nodes.append(OpNode(name=n.name, kind="const", inputs=(),
                                    output=n.output,
                                    out_bytes=int(vals[n.output].nbytes),
                                    attrs={"value": vals[n.output]},
                                    layer=n.layer, sublayer=n.sublayer))
        else:
            new_nodes.append(OpNode(**vars(n)))
    g = Graph(nodes=new_nodes, inputs=graph.inputs, outputs=graph.outputs,
              tensors=dict(graph.tensors))
    return eliminate_dead(g)


def eliminate_dead(graph: Graph) -> Graph:
    """Drop ops whose outputs nothing consumes."""
    live: set = set(graph.outputs)
    for n in reversed(graph.toposort()):
        if n.output in live:
            live.update(n.inputs)
    g = Graph(nodes=[n for n in graph.nodes if n.output in live],
              inputs=graph.inputs, outputs=graph.outputs,
              tensors=dict(graph.tensors))
    g.validate()
    return g


def convert(graph: Graph, params: Optional[Dict[str, np.ndarray]] = None
            ) -> Graph:
    """The full two-stage conversion pipeline."""
    g = eliminate_duplicates(graph)
    g = fuse_linear_chains(g)
    g = fold_constants(g, params)
    return eliminate_dead(g)
