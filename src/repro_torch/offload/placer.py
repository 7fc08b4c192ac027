"""Adaptive cross-device operator offloading (paper §III-B1).

Given the pre-partitioned units and a pool of device profiles, a
graph-search (exact DP over the sequential unit chain) picks the cut
points and device assignment minimizing end-to-end latency including
transmission (feature bytes / link bandwidth), subject to per-device
memory.  Baselines from the paper's evaluation:

  * CAS  — context-aware heuristic: greedy biggest-bottleneck first
  * DADS — min-cut formulation (for chain graphs the DP is the exact
           min-cut, so DADS here = DP restricted to 2 devices)

The JAX package also maps units onto TPU *mesh slices* with the same
placer (a DeviceProfile is then a slice of chips); ``DEVICE_POOLS`` keeps
those profiles as data so that placements equal the JAX ones.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .partition import PrePartition, Unit

#: Sentinel ``link_bw`` for the LAST device in a chain: there is no next
#: device, so no egress link exists.  The placement DP never reads the
#: last device's ``link_bw`` (transfers are charged on the *previous*
#: device's link), so any value would work — this constant makes the
#: "terminal device" intent explicit instead of a bare ``0``.  The fleet
#: placement (``repro_torch.fleet.placement``, as in the JAX package)
#: synthesizes real per-hop bandwidths from its site topology and uses
#: this only for the chain tail.
NO_NEXT_LINK: float = 0.0


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    flops: float            # achievable FLOP/s
    mem_bytes: float        # memory available for params + activations
    mem_bw: float           # bytes/s
    # bytes/s to the NEXT device in the chain; NO_NEXT_LINK marks the
    # terminal device (no egress — never consulted by the DP)
    link_bw: float = NO_NEXT_LINK
    power_w: float = 5.0
    kind: str = "edge"      # edge | hub | tpu_slice

    def compute_seconds(self, unit: Unit, eps: float = 0.5) -> float:
        """Roofline-ish unit latency: max(compute, memory) with the paper's
        cache-hit-rate ε folding into effective bandwidth."""
        comp = unit.flops / self.flops
        eff_bw = self.mem_bw * (eps + (1 - eps) / 6.0)  # misses cost ~6x
        mem = (unit.param_bytes + unit.peak_act_bytes) / eff_bw
        return max(comp, mem)


# a small heterogeneous pool mirroring the paper's testbed spirit
# (Raspberry-Pi-class, Jetson-class, phone-class) plus TPU slices: the
# profiles of the simulated fleet, copied from the JAX package as data.
# They describe the modelled devices, not the card this port runs on.
DEVICE_POOLS: Dict[str, Tuple[DeviceProfile, ...]] = {
    "edge_pair": (
        DeviceProfile("rpi4b-class", 12e9, 2e9, 4e9, 10e6 / 8 * 1e3),  # ~1Gbps
        DeviceProfile("jetson-class", 470e9, 6e9, 25e9, NO_NEXT_LINK),
    ),
    "edge_trio": (
        DeviceProfile("watch-class", 4e9, 0.8e9, 2e9, 100e6),
        DeviceProfile("phone-class", 80e9, 4e9, 15e9, 200e6),
        DeviceProfile("hub-class", 470e9, 8e9, 25e9, NO_NEXT_LINK),
    ),
    "pod_pipeline": (
        DeviceProfile("pod0-slice", 256 * 197e12, 256 * 16e9, 256 * 819e9,
                      50e9, kind="tpu_slice"),
        DeviceProfile("pod1-slice", 256 * 197e12, 256 * 16e9, 256 * 819e9,
                      NO_NEXT_LINK, kind="tpu_slice"),
    ),
}


@dataclass
class Placement:
    cuts: Tuple[int, ...]            # unit index AFTER which each cut happens
    assignment: Tuple[int, ...]      # per-unit device index
    latency_s: float
    transfer_s: float
    per_device_mem: Tuple[float, ...]
    level: int

    def describe(self, units: Sequence[Unit],
                 devices: Sequence[DeviceProfile]) -> str:
        segs = []
        start = 0
        for c in list(self.cuts) + [len(units) - 1]:
            d = devices[self.assignment[start]]
            segs.append(f"[{units[start].name}..{units[c].name}]@{d.name}")
            start = c + 1
        return " -> ".join(segs)


def place_dp(pp: PrePartition, devices: Sequence[DeviceProfile],
             level: int = 2, eps: float = 0.5,
             allow_skip: bool = False) -> Placement:
    """Exact DP: best[i][d] = min latency of units[0..i] ending on device d,
    devices used in order (pipeline chain).  O(N^2 * D)."""
    units = pp.units(level)
    n, nd = len(units), len(devices)
    comp = np.array([[dev.compute_seconds(u, eps) for dev in devices]
                     for u in units])                      # (N, D)
    mem = np.array([u.param_bytes + u.peak_act_bytes for u in units])
    bnd = np.array([u.boundary_bytes for u in units])
    pre_comp = np.cumsum(comp, axis=0)
    pre_mem = np.cumsum(mem)

    INF = float("inf")
    best = np.full((n, nd), INF)
    back: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for i in range(n):
        for d in range(nd):
            # units 0..i all on device d (d must be first device used)
            seg_mem = pre_mem[i]
            if d == 0 and seg_mem <= devices[0].mem_bytes:
                best[i][d] = pre_comp[i][d]
            # or: cut after j on previous device e < d
            for j in range(i):
                seg_mem = pre_mem[i] - pre_mem[j]
                if seg_mem > devices[d].mem_bytes:
                    continue
                e_range = range(d) if allow_skip else ([d - 1] if d else [])
                for e in e_range:
                    if best[j][e] == INF:
                        continue
                    xfer = bnd[j] / max(devices[e].link_bw, 1.0)
                    cand = best[j][e] + xfer + (pre_comp[i][d] - pre_comp[j][d])
                    if cand < best[i][d]:
                        best[i][d] = cand
                        back[(i, d)] = (j, e)
    d_end = int(np.argmin(best[n - 1]))
    if best[n - 1][d_end] == INF:
        raise ValueError("no feasible placement (memory limits too tight)")
    # reconstruct
    cuts: List[int] = []
    assign = [0] * n
    i, d = n - 1, d_end
    while True:
        if (i, d) not in back:
            for k in range(i + 1):
                assign[k] = d
            break
        j, e = back[(i, d)]
        for k in range(j + 1, i + 1):
            assign[k] = d
        cuts.append(j)
        i, d = j, e
    cuts = sorted(cuts)
    transfer = sum(bnd[j] / max(devices[assign[j]].link_bw, 1.0) for j in cuts)
    per_mem = [float(mem[np.array(assign) == d].sum()) for d in range(nd)]
    return Placement(cuts=tuple(cuts), assignment=tuple(assign),
                     latency_s=float(best[n - 1][d_end]),
                     transfer_s=float(transfer),
                     per_device_mem=tuple(per_mem), level=level)


def place_cas(pp: PrePartition, devices: Sequence[DeviceProfile],
              level: int = 2, eps: float = 0.5) -> Placement:
    """CAS-style heuristic: walk units in order, move to the next device
    when the current one's accumulated latency exceeds its fair share."""
    units = pp.units(level)
    nd = len(devices)
    total = sum(dev.compute_seconds(u, eps) for u in units
                for dev in [devices[0]])
    share = total / nd
    assign = []
    d, acc = 0, 0.0
    for u in units:
        c = devices[d].compute_seconds(u, eps)
        if acc + c > share * 1.25 and d < nd - 1:
            d, acc = d + 1, 0.0
        assign.append(d)
        acc += devices[d].compute_seconds(u, eps)
    cuts = tuple(i for i in range(len(units) - 1)
                 if assign[i] != assign[i + 1])
    lat = 0.0
    for i, u in enumerate(units):
        lat += devices[assign[i]].compute_seconds(u, eps)
    transfer = sum(units[i].boundary_bytes
                   / max(devices[assign[i]].link_bw, 1.0) for i in cuts)
    mem = np.array([u.param_bytes + u.peak_act_bytes for u in units])
    per_mem = [float(mem[np.array(assign) == dd].sum()) for dd in range(nd)]
    return Placement(cuts=cuts, assignment=tuple(assign),
                     latency_s=lat + transfer, transfer_s=transfer,
                     per_device_mem=tuple(per_mem), level=level)


def place_dads(pp: PrePartition, devices: Sequence[DeviceProfile],
               level: int = 2, eps: float = 0.5) -> Placement:
    """DADS: DAG min-cut between local and remote.  For the sequential
    chains produced by pre-partitioning this is the 2-device exact cut."""
    return place_dp(pp, devices[:2], level=level, eps=eps)


def local_only(pp: PrePartition, devices: Sequence[DeviceProfile],
               level: int = 2, eps: float = 0.5) -> Placement:
    units = pp.units(level)
    lat = sum(devices[0].compute_seconds(u, eps) for u in units)
    mem = float(sum(u.param_bytes + u.peak_act_bytes for u in units))
    return Placement(cuts=(), assignment=tuple([0] * len(units)),
                     latency_s=lat, transfer_s=0.0,
                     per_device_mem=(mem,) + (0.0,) * (len(devices) - 1),
                     level=level)
