"""FleetPlacer: offload partitions onto live fleet peers.

The scalable-offloading search (``repro_torch.offload.placer``) is kept as-is
— an exact DP over a device chain — but the chain is no longer a
hard-coded pool.  The placer maintains a :class:`MemberState` per fleet
member (capability spec × crowd calibration × current context × tenancy
load), selects candidate helper chains (idle same-site members first),
synthesizes live :class:`DeviceProfile` chains with per-hop link
bandwidths from the :class:`SiteTopology`, and runs the DP over each
candidate chain.  A placement only changes when it clears two bars:

* **hysteresis** — the new chain must beat the *re-predicted* latency of
  the current one by a relative margin, so two near-equal placements
  never ping-pong;
* **migration** — parameter bytes that must move to newly assigned
  hosts are priced over the actual link, and the per-inference gain
  must amortize that cost within ``amortize_steps`` inferences.

Accepted placements update the multi-tenant ledger: each helper's
``hosted`` map records the compute fraction it now spends on this
requester, which discounts the profile every *other* requester sees.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.monitor import ResourceContext
from repro_torch.core.profiler import Calibration
from repro_torch.fleet.registry import DeviceSpec
from repro_torch.models.configs import ModelConfig
from repro_torch.obs import NULL_RECORDER
from repro_torch.offload.graph_ir import build_model_graph
from repro_torch.offload.partition import PrePartition, pre_partition
from repro_torch.offload.placer import (NO_NEXT_LINK, DeviceProfile, Placement,
                                  local_only, place_dp)

from .profiles import MemberState, synthesize_profile
from .topology import SiteTopology

# decision reasons
LOCAL, PLACED, HOLD, FALLBACK, INFEASIBLE = (
    "local", "placed", "hold", "fallback", "infeasible")


@dataclass(frozen=True)
class PlacementDecision:
    """One requester's current placement.

    ``hosts`` is the device chain in execution order — ``hosts[0]`` is
    always the requester itself; a 1-chain means run everything locally.
    ``placement`` carries the DP's cut/assignment detail (``None`` when
    local or infeasible).  ``latency_s`` is the end-to-end predicted
    latency under the live profiles at decision time; ``migration_s``
    the one-off cost of moving parameters onto newly assigned hosts."""
    requester: str
    hosts: Tuple[str, ...]
    placement: Optional[Placement]
    latency_s: float
    migration_s: float
    reason: str
    timestamp_s: float = 0.0

    @property
    def offloaded(self) -> bool:
        return len(self.hosts) > 1 and self.placement is not None

    def describe(self) -> str:
        chain = " -> ".join(self.hosts)
        return (f"{self.requester}: [{chain}] lat={self.latency_s:.4g}s "
                f"migrate={self.migration_s:.3g}s ({self.reason})")


@dataclass(frozen=True)
class PlacementAudit:
    """Why one :meth:`FleetPlacer.place` call decided what it decided —
    the decision log the benchmarks serialize and the trace's
    ``placement.decide`` instants carry.

    ``considered`` lists every candidate chain enumerated (in search
    order) with its DP-predicted latency in ``latencies`` (``inf`` for
    chains the DP rejected as infeasible, counted in ``infeasible``).
    ``held_by_hysteresis`` marks sweeps where a challenger beat the
    incumbent but not by the hysteresis margin (or couldn't amortize its
    migration), so the incumbent was kept; ``incumbent_latency_s`` is
    then the incumbent's *re-predicted* live latency the challenger was
    judged against."""
    requester: str
    timestamp_s: float
    considered: Tuple[Tuple[str, ...], ...]
    latencies: Tuple[float, ...]
    infeasible: int
    chosen: Tuple[str, ...]
    chosen_latency_s: float
    reason: str
    held_by_hysteresis: bool = False
    incumbent_latency_s: Optional[float] = None
    migration_s: float = 0.0


class FleetPlacer:
    """Turns the live fleet into the offloading device pool.

    ``considered`` caps how many candidate helpers feed the chain
    search; ``max_helpers`` caps the chain length (requester + helpers).
    ``hysteresis`` and ``amortize_steps`` gate re-placement (see module
    docstring)."""

    def __init__(self, cfg: ModelConfig,
                 topology: Optional[SiteTopology] = None, *,
                 level: int = 2, seq: int = 512,
                 max_helpers: int = 2, considered: int = 4,
                 hysteresis: float = 0.15, amortize_steps: int = 20):
        self.topology = topology or SiteTopology()
        self.level = level
        self.max_helpers = max_helpers
        self.considered = considered
        self.hysteresis = hysteresis
        self.amortize_steps = amortize_steps
        graph = build_model_graph(cfg, 1, min(cfg.max_seq_len, seq))
        self.pp: PrePartition = pre_partition(graph)
        units = self.pp.units(level)
        # nominal per-hop tensor size for folding link RTT into a flat
        # bandwidth: the mean boundary the DP might cut at
        cut_bytes = [u.boundary_bytes for u in units[:-1]] or [1]
        self._nominal_boundary = max(
            1.0, sum(cut_bytes) / len(cut_bytes))
        self._members: Dict[str, MemberState] = {}
        self._current: Dict[str, PlacementDecision] = {}
        # decision log: one PlacementAudit per place() call; the fleet
        # controller points ``recorder`` at its TraceRecorder so each
        # audit also lands as a placement.decide trace instant
        self.audits: List[PlacementAudit] = []
        self.recorder = NULL_RECORDER
        self.obs_pid = "fleet"
        # clock of the most recent place() call — candidate_helpers
        # judges quarantine windows against it
        self._place_now_s = 0.0

    # ------------------------------------------------------- membership ----
    def register(self, spec: DeviceSpec) -> MemberState:
        st = MemberState(spec=spec)
        self._members[spec.device_id] = st
        return st

    def member(self, device_id: str) -> MemberState:
        return self._members[device_id]

    @property
    def members(self) -> Dict[str, MemberState]:
        return self._members

    def update_member(self, device_id: str, *,
                      ctx: Optional[ResourceContext] = None,
                      calibration: Optional[Calibration] = None,
                      own_load: Optional[float] = None) -> None:
        st = self._members[device_id]
        if ctx is not None:
            st.ctx = ctx
        if calibration is not None:
            st.calibration = calibration
        if own_load is not None:
            st.own_load = max(0.0, min(0.95, own_load))

    def remove_member(self, device_id: str) -> List[str]:
        """A member left the fleet (battery died, walked out of range).
        Returns the requesters whose current placement used it — they
        must fall back / re-place."""
        st = self._members.pop(device_id, None)
        affected = [rid for rid, dec in self._current.items()
                    if device_id in dec.hosts and rid != device_id]
        self._current.pop(device_id, None)
        if st is not None:
            st.alive = False
        # anything the departed device was *requesting* stops consuming
        # its helpers — a dead tenant must not keep inflating their load
        for other in self._members.values():
            other.hosted.pop(device_id, None)
        for rid in affected:
            self._current[rid] = self._fallback(rid, FALLBACK)
        return affected

    # -------------------------------------------------------- chain build --
    def chain_profiles(self, ids: Sequence[str],
                       for_requester: Optional[str] = None
                       ) -> List[DeviceProfile]:
        """Live profiles for a device chain, with per-hop link bandwidth
        from the topology (RTT folded in at the nominal boundary size);
        the terminal device gets :data:`NO_NEXT_LINK`."""
        req = for_requester or (ids[0] if ids else None)
        profs = []
        for i, did in enumerate(ids):
            st = self._members[did]
            if i + 1 < len(ids):
                nxt = self._members[ids[i + 1]]
                link = self.topology.link_between(st.spec, nxt.spec)
                bw = link.effective_bw(self._nominal_boundary)
            else:
                bw = NO_NEXT_LINK
            profs.append(synthesize_profile(st, for_requester=req,
                                            link_bw=bw))
        return profs

    def candidate_helpers(self, requester: str,
                          now_s: Optional[float] = None) -> List[str]:
        """Helpers worth considering, best first: same-site before
        cross-site, then the least busy, then the most capable.
        Quarantined members (flapping devices on post-recovery
        probation, see ``MemberState.quarantined_until_s``) are
        excluded: the placer never ping-pongs onto a helper that just
        proved unreliable.  ``now_s`` defaults to the clock of the
        enclosing :meth:`place` call."""
        me = self._members[requester]
        if now_s is None:
            now_s = self._place_now_s

        def rank(item):
            did, st = item
            same = self.topology.same_site(me.spec, st.spec)
            cap = st.spec.hw.peak_flops * st.spec.chips
            return (0 if same else 1, st.busy_frac(excluding=requester),
                    -cap)

        cands = [(did, st) for did, st in self._members.items()
                 if did != requester and st.alive
                 and st.quarantined_until_s <= now_s]
        cands.sort(key=rank)
        return [did for did, _ in cands[:self.considered]]

    # ---------------------------------------------------------- latency ----
    def _chain_latency(self, ids: Sequence[str],
                       profs: Sequence[DeviceProfile],
                       placement: Placement) -> float:
        """Re-predict a FIXED placement's latency under current live
        profiles (used to hold the incumbent to the same standard as
        challengers).  Infinite if any host is gone."""
        if any(did not in self._members for did in ids):
            return float("inf")
        units = self.pp.units(placement.level)
        lat = 0.0
        for i, u in enumerate(units):
            d = placement.assignment[i]
            lat += profs[d].compute_seconds(u)
        for c in placement.cuts:
            d = placement.assignment[c]
            lat += units[c].boundary_bytes / max(profs[d].link_bw, 1.0)
        return lat

    def _migration_s(self, requester: str, hosts: Sequence[str],
                     placement: Placement) -> float:
        """Cost of moving parameters onto newly assigned hosts: bytes of
        every unit that lands on a helper which did not already hold it,
        shipped from the requester over the actual link."""
        prev = self._current.get(requester)
        prev_owner: Dict[str, str] = {}
        if prev is not None and prev.placement is not None:
            punits = self.pp.units(prev.placement.level)
            for i, u in enumerate(punits):
                prev_owner[u.name] = prev.hosts[prev.placement.assignment[i]]
        units = self.pp.units(placement.level)
        me = self._members[requester].spec
        cost = 0.0
        for i, u in enumerate(units):
            host = hosts[placement.assignment[i]]
            if host == requester or prev_owner.get(u.name) == host:
                continue
            if host not in self._members:
                return float("inf")
            link = self.topology.link_between(
                me, self._members[host].spec)
            cost += link.transfer_s(u.param_bytes)
        return cost

    def _fallback(self, requester: str, reason: str) -> PlacementDecision:
        """Local-only decision (or infeasible marker when even the
        requester alone cannot hold the model)."""
        profs = self.chain_profiles([requester])
        pl = local_only(self.pp, profs, level=self.level)
        if pl.per_device_mem[0] > profs[0].mem_bytes:
            return PlacementDecision(requester, (requester,), None,
                                     float("inf"), 0.0, INFEASIBLE)
        return PlacementDecision(requester, (requester,), None,
                                 pl.latency_s, 0.0, reason)

    # -------------------------------------------------------------- place --
    def place(self, requester: str, now_s: float = 0.0
              ) -> PlacementDecision:
        """(Re-)place one requester's partitions over the live fleet.

        Enumerates candidate chains — the requester alone, plus each
        single helper and each ordered helper pair from the ranked
        candidate set — runs the exact DP on every feasible chain, and
        applies hysteresis + migration amortization against the
        incumbent before committing.  Never raises on infeasibility:
        the worst case is an explicit local/infeasible fallback."""
        self._place_now_s = now_s
        local = self._fallback(requester, LOCAL)
        helpers = self.candidate_helpers(requester, now_s=now_s)
        chains: List[Tuple[str, ...]] = [(requester,)]
        chains += [(requester, h) for h in helpers]
        if self.max_helpers >= 2:
            for h1, h2 in itertools.permutations(helpers, 2):
                chains.append((requester, h1, h2))

        considered: List[Tuple[str, ...]] = []
        latencies: List[float] = []
        infeasible = 0
        best: Optional[PlacementDecision] = None
        for ids in chains:
            profs = self.chain_profiles(ids)
            considered.append(tuple(ids))
            if len(ids) == 1:
                cand = local
            else:
                try:
                    pl = place_dp(self.pp, profs, level=self.level)
                except ValueError:
                    infeasible += 1
                    latencies.append(float("inf"))
                    continue
                used = sorted(set(pl.assignment))
                if used == [0]:
                    cand = local          # DP kept everything at home
                else:
                    mig = self._migration_s(requester, ids, pl)
                    cand = PlacementDecision(
                        requester, tuple(ids), pl, pl.latency_s, mig,
                        PLACED, now_s)
            latencies.append(cand.latency_s)
            if best is None or cand.latency_s < best.latency_s:
                best = cand
        if best is None:
            best = local
        best = PlacementDecision(
            best.requester, best.hosts, best.placement, best.latency_s,
            best.migration_s, best.reason, now_s)

        cur = self._current.get(requester)
        if cur is None or cur.reason == INFEASIBLE:
            # fresh placement: no churn to damp, but migration must
            # still pay for itself against simply staying local
            if best.offloaded and \
                    (local.latency_s - best.latency_s) \
                    * self.amortize_steps < best.migration_s:
                best = PlacementDecision(
                    requester, local.hosts, local.placement,
                    local.latency_s, 0.0, local.reason, now_s)
        elif best.hosts != cur.hosts:
            cur_live = self._relive(cur)
            gain = cur_live.latency_s - best.latency_s
            if gain < self.hysteresis * cur_live.latency_s or \
                    gain * self.amortize_steps < best.migration_s:
                held = PlacementDecision(
                    requester, cur_live.hosts, cur_live.placement,
                    cur_live.latency_s, 0.0, HOLD, now_s)
                self._commit(held)
                self._audit(held, considered, latencies, infeasible,
                            held_by_hysteresis=True,
                            incumbent_latency_s=cur_live.latency_s)
                return held
        self._commit(best)
        self._audit(best, considered, latencies, infeasible)
        return best

    def _audit(self, dec: PlacementDecision,
               considered: List[Tuple[str, ...]], latencies: List[float],
               infeasible: int, *, held_by_hysteresis: bool = False,
               incumbent_latency_s: Optional[float] = None) -> None:
        """Log why this decision won (see :class:`PlacementAudit`)."""
        audit = PlacementAudit(
            requester=dec.requester, timestamp_s=dec.timestamp_s,
            considered=tuple(considered), latencies=tuple(latencies),
            infeasible=infeasible, chosen=dec.hosts,
            chosen_latency_s=dec.latency_s, reason=dec.reason,
            held_by_hysteresis=held_by_hysteresis,
            incumbent_latency_s=incumbent_latency_s,
            migration_s=dec.migration_s)
        self.audits.append(audit)
        if self.recorder.enabled:
            self.recorder.instant(
                "placement.decide", pid=self.obs_pid, tid="placement",
                cat="placement",
                args={"requester": dec.requester,
                      "chosen": " -> ".join(dec.hosts),
                      "latency_s": dec.latency_s,
                      "reason": dec.reason,
                      "considered": len(considered),
                      "infeasible": infeasible,
                      "held_by_hysteresis": held_by_hysteresis})

    def _relive(self, dec: PlacementDecision) -> PlacementDecision:
        """The incumbent decision with its latency re-predicted under
        the CURRENT live profiles (a helper that slowed down since the
        placement was made shows up here, triggering re-placement)."""
        if dec.placement is None or not dec.offloaded:
            fresh = self._fallback(dec.requester, dec.reason)
            return fresh
        if any(did not in self._members for did in dec.hosts):
            return PlacementDecision(dec.requester, dec.hosts,
                                     dec.placement, float("inf"), 0.0,
                                     dec.reason, dec.timestamp_s)
        profs = self.chain_profiles(dec.hosts)
        lat = self._chain_latency(dec.hosts, profs, dec.placement)
        return PlacementDecision(dec.requester, dec.hosts, dec.placement,
                                 lat, 0.0, dec.reason, dec.timestamp_s)

    def _commit(self, dec: PlacementDecision) -> None:
        """Record the decision and refresh the tenancy ledger: each
        helper's hosted fraction is its share of the pipeline's compute
        time, which discounts its profile for every other requester."""
        rid = dec.requester
        for st in self._members.values():
            st.hosted.pop(rid, None)
        if dec.offloaded and dec.placement is not None \
                and dec.latency_s < float("inf"):
            profs = self.chain_profiles(dec.hosts)
            units = self.pp.units(dec.placement.level)
            per_host: Dict[str, float] = {}
            for i, u in enumerate(units):
                host = dec.hosts[dec.placement.assignment[i]]
                per_host[host] = per_host.get(host, 0.0) \
                    + profs[dec.placement.assignment[i]].compute_seconds(u)
            for host, t in per_host.items():
                if host == rid or host not in self._members:
                    continue
                frac = min(0.9, t / max(dec.latency_s, 1e-12))
                self._members[host].hosted[rid] = frac
        self._current[rid] = dec

    # ------------------------------------------------------------ queries --
    def local_decision(self, requester: str) -> PlacementDecision:
        """Predicted local-only execution for a requester under its live
        profile — the baseline every placement is judged against."""
        return self._fallback(requester, LOCAL)

    def current(self, requester: str) -> Optional[PlacementDecision]:
        return self._current.get(requester)

    @property
    def decisions(self) -> Dict[str, PlacementDecision]:
        return dict(self._current)

    def resolve_profiles(self, peers: Sequence[str]
                         ) -> List[DeviceProfile]:
        """Profiles for an :class:`OffloadChoice.peers` chain as the
        evaluator sees it.  Dead members are dropped from the chain
        (the requester — ``peers[0]`` — is always kept), so an action
        referencing a vanished helper degrades to a shorter chain
        instead of crashing the optimizer."""
        alive = [p for i, p in enumerate(peers)
                 if i == 0 or (p in self._members
                               and self._members[p].alive)]
        if not alive or alive[0] not in self._members:
            return []
        return self.chain_profiles(alive)
