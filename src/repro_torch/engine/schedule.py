"""Engine scheduling: operator parallelism + backprop reordering + the
EngineConfig → RuntimeOptions bridge (paper §III-C ❷/❹).

Cross-core operator parallelism: on mobile the paper co-schedules CPU+GPU;
on one GPU the analogue is independent op flows issued on concurrent CUDA
streams.  ``plan_parallelism`` computes the critical path over the IR and
the achievable speedup with n concurrent streams — the number the
profiler charges.

Backprop operator reordering: gradients are applied per-layer immediately
(discarding the gradient right after its update).  The JAX package's
docstring attributes it to a layerwise-update mode of its optimizer, but
neither package's optimizer has one (``optim/adamw.py`` has ``init``,
``global_norm`` and ``apply`` in both), so here it is the byte count
only.

``EngineConfig.to_runtime_options`` gives the same options as the JAX
package, ``kv_cache_dtype="int8"`` mapped to ``"bfloat16"`` included (the
int8 cache is not wired to the codec there either).  ``use_pallas`` is
carried over unchanged; in the port the tensor's device, not the flag,
picks the hand-written kernel.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.models.runtime import RuntimeOptions
from repro_torch.offload.graph_ir import Graph
from repro_torch.offload.partition import independent_flows


@dataclass(frozen=True)
class EngineConfig:
    """θ_s: the backend scheduling action surface."""
    fuse: bool = True
    parallel_streams: int = 2
    remat_policy: str = "none"          # none | dots | full
    kv_cache_dtype: str = "bfloat16"    # bfloat16 | int8 (via act_compress)
    attn_impl: str = "auto"
    q_chunk: int = 512
    k_chunk: int = 1024
    decode_window: int = 0
    use_pallas: bool = False
    sub_batches: int = 1
    host_swap: bool = False

    def to_runtime_options(self) -> RuntimeOptions:
        return RuntimeOptions(
            attn_impl=self.attn_impl, q_chunk=self.q_chunk,
            k_chunk=self.k_chunk, decode_window=self.decode_window,
            remat=self.remat_policy,
            use_pallas=self.use_pallas,
            kv_cache_dtype=("bfloat16" if self.kv_cache_dtype == "int8"
                            else self.kv_cache_dtype))


@dataclass
class ParallelPlan:
    serial_cost: float
    critical_path: float
    streams: int
    speedup: float
    level_widths: List[int]


def plan_parallelism(graph: Graph, streams: int = 2,
                     core_speed_ratio: float = 1.0) -> ParallelPlan:
    """Critical-path schedule of independent op flows over `streams` units.

    speedup = serial / max(critical_path, serial/streams) — the classic
    DAG bound; ``core_speed_ratio`` derates the second core (the paper's
    heterogeneous CPU+GPU case)."""
    levels = independent_flows(graph)
    node_cost = {n.output: max(n.flops, 1.0) for n in graph.nodes}
    serial = sum(node_cost.values())
    crit = 0.0
    widths = []
    eff_streams = 1.0 + (streams - 1) * core_speed_ratio
    for level in levels:
        costs = sorted((node_cost.get(t, 0.0) for t in level), reverse=True)
        widths.append(len(costs))
        # greedy LPT onto streams
        lanes = [0.0] * max(1, int(streams))
        for c in costs:
            lanes[lanes.index(min(lanes))] += c
        crit += max(lanes) if core_speed_ratio >= 1.0 else sum(costs) / eff_streams
    speedup = serial / max(crit, serial / eff_streams, 1e-30)
    return ParallelPlan(serial_cost=serial, critical_path=crit,
                        streams=streams, speedup=min(speedup, eff_streams),
                        level_widths=widths)


def backprop_reorder_savings(n_layers: int, grad_bytes_per_layer: int
                             ) -> Tuple[int, int]:
    """Engine ❹: retaining all gradients vs immediate per-layer update.

    Returns (bytes held at peak without reordering, with reordering)."""
    return n_layers * grad_bytes_per_layer, grad_bytes_per_layer
