"""Minimal computation-graph IR (the paper's "intermediary computational
graph format", §III-B2).

The IR serves three middleware components:
  * scalable offloading — pre-partition + placement search over op units,
  * the model-adaptive engine — fusion / memory passes,
  * the profiler — per-op FLOPs and byte counts feed Eq. (1)/(2).

Small graphs are *executable* over numpy tensors so transformation passes
can be verified semantically (the redundancy-elimination guarantee of the
paper's two-stage conversion).  ``execute`` stays on numpy, as in the JAX
package, so its results can be compared with the reference's exactly; it
runs on the host and takes CPU tensors as well (through ``np.asarray``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.models.configs import ATTN, LOCAL, MAMBA, ModelConfig


@dataclass
class OpNode:
    name: str
    kind: str                     # matmul | add | mul | act | norm | softmax |
                                  # attention | embed | const | input | output |
                                  # conv | reduce | fused(...)
    inputs: Tuple[str, ...]
    output: str
    flops: float = 0.0
    param_bytes: int = 0
    out_bytes: int = 0
    attrs: Dict[str, Any] = field(default_factory=dict)
    # grouping metadata for hierarchical pre-partition
    layer: int = -1               # transformer layer index (-1 = outside)
    sublayer: str = ""            # "attn" | "ffn" | "moe" | "mamba" | ""
    constant: bool = False        # output independent of graph inputs


@dataclass
class Graph:
    nodes: List[OpNode]
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    tensors: Dict[str, int] = field(default_factory=dict)  # name -> bytes

    def node_map(self) -> Dict[str, OpNode]:
        return {n.output: n for n in self.nodes}

    def consumers(self) -> Dict[str, List[OpNode]]:
        cons: Dict[str, List[OpNode]] = {}
        for n in self.nodes:
            for i in n.inputs:
                cons.setdefault(i, []).append(n)
        return cons

    def toposort(self) -> List[OpNode]:
        produced = set(self.inputs)
        remaining = list(self.nodes)
        order: List[OpNode] = []
        while remaining:
            progressed = False
            rest = []
            for n in remaining:
                if all(i in produced for i in n.inputs):
                    order.append(n)
                    produced.add(n.output)
                    progressed = True
                else:
                    rest.append(n)
            remaining = rest
            if not progressed:
                raise ValueError("cycle or missing producer in graph")
        return order

    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes)

    def total_param_bytes(self) -> int:
        return sum(n.param_bytes for n in self.nodes)

    def validate(self) -> None:
        self.toposort()
        names = [n.output for n in self.nodes]
        if len(names) != len(set(names)):
            raise ValueError("duplicate tensor producers")


# ------------------------------------------------------------ execution ----
_ACTS = {"relu": lambda x: np.maximum(x, 0),
         "gelu": lambda x: 0.5 * x * (1 + np.tanh(0.79788456 * (x + 0.044715 * x ** 3))),
         "silu": lambda x: x / (1 + np.exp(-np.clip(x, -30, 30)))}


def execute(graph: Graph, feeds: Dict[str, np.ndarray],
            params: Optional[Dict[str, np.ndarray]] = None
            ) -> Dict[str, np.ndarray]:
    """Reference interpreter for small graphs (tests / transform checks).
    Runs on the host: feeds and params are numpy arrays or CPU tensors,
    and the outputs are numpy arrays."""
    env: Dict[str, np.ndarray] = {k: np.asarray(v) for k, v in feeds.items()}
    env.update({k: np.asarray(v) for k, v in (params or {}).items()})
    for n in graph.toposort():
        x = [env[i] for i in n.inputs]
        k = n.kind
        if k == "matmul":
            env[n.output] = x[0] @ x[1]
        elif k == "add":
            env[n.output] = x[0] + x[1]
        elif k == "mul":
            env[n.output] = x[0] * x[1]
        elif k == "act":
            env[n.output] = _ACTS[n.attrs.get("fn", "relu")](x[0])
        elif k == "norm":
            mu = x[0].mean(-1, keepdims=True)
            var = x[0].var(-1, keepdims=True)
            y = (x[0] - mu) / np.sqrt(var + 1e-6)
            if len(x) > 1:
                y = y * x[1]
            if len(x) > 2:
                y = y + x[2]
            env[n.output] = y
        elif k == "softmax":
            e = np.exp(x[0] - x[0].max(-1, keepdims=True))
            env[n.output] = e / e.sum(-1, keepdims=True)
        elif k == "const":
            env[n.output] = np.asarray(n.attrs["value"])
        elif k == "reduce":
            fn = {"sum": np.sum, "mean": np.mean, "max": np.max}[
                n.attrs.get("fn", "sum")]
            env[n.output] = fn(x[0], axis=n.attrs.get("axis", -1))
        elif k.startswith("fused"):
            env[n.output] = _exec_fused(n, x)
        else:
            raise NotImplementedError(k)
    return {o: env[o] for o in graph.outputs}


def _exec_fused(n: OpNode, x: List[np.ndarray]) -> np.ndarray:
    """Execute a fused op from its recorded sub-op recipe.

    Convention: y starts as the first input; each binary step (matmul /
    add / mul) consumes the next unused input; unary steps transform y.
    The recipe INCLUDES the head op.
    """
    env = list(x)
    y = env[0]
    used = 1
    for step in n.attrs["recipe"]:
        kind = step["kind"]
        if kind in ("matmul", "conv"):
            y = y @ env[used]; used += 1
        elif kind == "add":
            y = y + env[used]; used += 1
        elif kind == "mul":
            y = y * env[used]; used += 1
        elif kind == "act":
            y = _ACTS[step.get("fn", "relu")](y)
        elif kind == "norm":
            mu = y.mean(-1, keepdims=True)
            var = y.var(-1, keepdims=True)
            y = (y - mu) / np.sqrt(var + 1e-6)
        elif kind == "reduce":
            fn = {"sum": np.sum, "mean": np.mean, "max": np.max}[
                step.get("fn", "sum")]
            y = fn(y, axis=step.get("axis", -1))
        else:
            raise NotImplementedError(kind)
    return y


# ----------------------------------------------- model-config -> IR --------
def build_model_graph(cfg: ModelConfig, batch: int, seq: int,
                      dtype_bytes: int = 2) -> Graph:
    """Lower a ModelConfig to the op-level IR (forward pass).

    One node per weight-touching op plus norms/activations/residuals —
    the granularity at which the paper's pre-partition and fusion operate.
    """
    nodes: List[OpNode] = []
    tensors: Dict[str, int] = {}
    t = batch * seq
    act_bytes = t * cfg.d_model * dtype_bytes

    def emit(name, kind, inputs, flops=0.0, pbytes=0, obytes=None, layer=-1,
             sub="", **attrs):
        nodes.append(OpNode(name=name, kind=kind, inputs=tuple(inputs),
                            output=name, flops=flops, param_bytes=pbytes,
                            out_bytes=obytes if obytes is not None else act_bytes,
                            attrs=attrs, layer=layer, sublayer=sub))
        tensors[name] = nodes[-1].out_bytes
        return name

    x = emit("embed", "embed", ["tokens"],
             pbytes=cfg.vocab_size * cfg.d_model * dtype_bytes)
    hd = cfg.resolved_head_dim
    pattern = cfg.block_pattern()
    li = 0
    for kind in pattern:
        l = li
        if kind == MAMBA:
            di = cfg.ssm_d_inner
            h = emit(f"l{l}.norm", "norm", [x], layer=l, sub="mamba",
                     flops=5 * t * cfg.d_model)
            pj = emit(f"l{l}.in_proj", "matmul", [h], layer=l, sub="mamba",
                      flops=2 * t * cfg.d_model * (2 * di + 2 * cfg.ssm_ngroups
                                                   * cfg.ssm_state_dim
                                                   + cfg.ssm_num_heads),
                      pbytes=cfg.d_model * (2 * di + 2 * cfg.ssm_ngroups
                                            * cfg.ssm_state_dim
                                            + cfg.ssm_num_heads) * dtype_bytes)
            cv = emit(f"l{l}.conv", "conv", [pj], layer=l, sub="mamba",
                      flops=2 * t * cfg.ssm_conv_dim * cfg.ssm_conv_width,
                      pbytes=cfg.ssm_conv_dim * cfg.ssm_conv_width * dtype_bytes)
            sc = emit(f"l{l}.ssd", "attention", [cv], layer=l, sub="mamba",
                      flops=2 * 6 * t * cfg.ssm_num_heads * cfg.ssm_head_dim
                      * cfg.ssm_state_dim)
            op = emit(f"l{l}.out_proj", "matmul", [sc], layer=l, sub="mamba",
                      flops=2 * t * di * cfg.d_model,
                      pbytes=di * cfg.d_model * dtype_bytes)
            x = emit(f"l{l}.res", "add", [x, op], layer=l, sub="mamba")
            li += 1
            continue
        # attention sublayer
        window = cfg.sliding_window if kind == LOCAL else 0
        ctx = min(seq, window) if window else seq
        h = emit(f"l{l}.ln1", "norm", [x], layer=l, sub="attn",
                 flops=5 * t * cfg.d_model)
        q = emit(f"l{l}.wq", "matmul", [h], layer=l, sub="attn",
                 flops=2 * t * cfg.d_model * cfg.q_dim,
                 pbytes=cfg.d_model * cfg.q_dim * dtype_bytes)
        kk = emit(f"l{l}.wk", "matmul", [h], layer=l, sub="attn",
                  flops=2 * t * cfg.d_model * cfg.kv_dim,
                  pbytes=cfg.d_model * cfg.kv_dim * dtype_bytes)
        vv = emit(f"l{l}.wv", "matmul", [h], layer=l, sub="attn",
                  flops=2 * t * cfg.d_model * cfg.kv_dim,
                  pbytes=cfg.d_model * cfg.kv_dim * dtype_bytes)
        at = emit(f"l{l}.attn", "attention", [q, kk, vv], layer=l, sub="attn",
                  flops=2 * 2 * t * cfg.num_heads * hd * (ctx / 2 if not window
                                                          else ctx),
                  window=window)
        ao = emit(f"l{l}.wo", "matmul", [at], layer=l, sub="attn",
                  flops=2 * t * cfg.q_dim * cfg.d_model,
                  pbytes=cfg.q_dim * cfg.d_model * dtype_bytes)
        x = emit(f"l{l}.res1", "add", [x, ao], layer=l, sub="attn")
        # ffn / moe sublayer
        sub = "moe" if cfg.arch_type == "moe" else "ffn"
        h2 = emit(f"l{l}.ln2", "norm", [x], layer=l, sub=sub,
                  flops=5 * t * cfg.d_model)
        f = cfg.d_ff
        if cfg.arch_type == "moe":
            active = cfg.experts_per_token + (1 if cfg.moe_shared_expert else 0)
            rt = emit(f"l{l}.router", "matmul", [h2], layer=l, sub=sub,
                      flops=2 * t * cfg.d_model * cfg.num_experts,
                      pbytes=cfg.d_model * cfg.num_experts * 4)
            mats = 3 if cfg.gated_ffn else 2
            up = emit(f"l{l}.experts", "matmul", [h2, rt], layer=l, sub=sub,
                      flops=2 * mats * t * active * cfg.d_model * f,
                      pbytes=mats * cfg.num_experts * cfg.d_model * f
                      * dtype_bytes)
            y = up
        else:
            up = emit(f"l{l}.w_up", "matmul", [h2], layer=l, sub=sub,
                      flops=2 * t * cfg.d_model * f,
                      pbytes=cfg.d_model * f * dtype_bytes,
                      obytes=t * f * dtype_bytes)
            if cfg.gated_ffn:
                g = emit(f"l{l}.w_gate", "matmul", [h2], layer=l, sub=sub,
                         flops=2 * t * cfg.d_model * f,
                         pbytes=cfg.d_model * f * dtype_bytes,
                         obytes=t * f * dtype_bytes)
                ga = emit(f"l{l}.act", "act", [g], layer=l, sub=sub,
                          flops=4 * t * f, fn=cfg.activation,
                          obytes=t * f * dtype_bytes)
                up = emit(f"l{l}.gate_mul", "mul", [ga, up], layer=l, sub=sub,
                          obytes=t * f * dtype_bytes)
            else:
                up = emit(f"l{l}.act", "act", [up], layer=l, sub=sub,
                          flops=4 * t * f, fn=cfg.activation,
                          obytes=t * f * dtype_bytes)
            y = emit(f"l{l}.w_down", "matmul", [up], layer=l, sub=sub,
                     flops=2 * t * f * cfg.d_model,
                     pbytes=f * cfg.d_model * dtype_bytes)
        x = emit(f"l{l}.res2", "add", [x, y], layer=l, sub=sub)
        li += 1
    x = emit("final_norm", "norm", [x], flops=5 * t * cfg.d_model)
    x = emit("lm_head", "matmul", [x],
             flops=2 * t * cfg.d_model * cfg.vocab_size,
             pbytes=0 if cfg.tie_embeddings else
             cfg.vocab_size * cfg.d_model * dtype_bytes,
             obytes=t * cfg.vocab_size * dtype_bytes)
    g = Graph(nodes=nodes, inputs=("tokens",), outputs=(x,), tensors=tensors)
    g.validate()
    return g
