"""Critical-path latency attribution over the trace timeline.

"Which level made this request slow?"  The recorder already carries
every lifecycle edge a request crosses — ``req.queued``,
``engine.prefill`` begins, ``req.first_token``/``req.decode`` instants,
``req.freeze``/``req.thaw``, ``engine.oom`` backoffs, the terminal
``req.slot`` end — so end-to-end latency decomposes *on the timeline
itself* into named components, one per cross-level cost:

===============  ==========  =================================================
component        layer       interval it covers
===============  ==========  =================================================
``queue_wait``   request     ``req.queued`` → admission (prefill begin /
                             prefix hit), minus any OOM-backoff suffix
``retry_backoff`` engine     the part of a queue wait after an ``engine.oom``
                             on the same engine (admission hold-off)
``prefill``      engine      prefill begin → ``req.first_token``
``decode``       engine      token-to-token gaps while resident in a slot
``migration``    fleet       ``req.freeze`` → same-engine ``req.thaw`` (or
                             fallback re-prefill begin): swap/preempt/requeue
``offload_link`` placement   ``req.freeze`` → *cross-engine* ``req.thaw`` —
                             the frozen blob crossing a link to a peer
===============  ==========  =================================================

**Arithmetic contract.**  Components sum *bit-equal* to the span-derived
end-to-end latency.  Float addition is not associative, so summing float
segment durations cannot reproduce ``t_end - t_begin`` exactly; instead
every timestamp is quantized once to integer nanoseconds and all
interval arithmetic is done in ``int``.  Each inter-milestone gap is
assigned to exactly one component (a split gap contributes
``(cut-lo) + (hi-cut) == hi-lo``), so the telescoping sum is exact —
``sum(components_ns.values()) == end_to_end_ns`` always, and
:func:`attribute_fleet` rollup totals equal the per-request sums for the
same reason.  This mirrors ``faults/report.py``: derived purely from
``TraceRecorder.events``, no side channel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .recorder import BEGIN, END, INSTANT

NS_PER_S = 1_000_000_000

COMPONENTS = ("queue_wait", "retry_backoff", "prefill", "decode",
              "migration", "offload_link")

# which of the four cross-level layers each component's cost lives on
COMPONENT_LAYER = {
    "queue_wait": "request",
    "retry_backoff": "engine",
    "prefill": "engine",
    "decode": "engine",
    "migration": "fleet",
    "offload_link": "placement",
}


def _ns(t_s: float) -> int:
    return round(t_s * NS_PER_S)


@dataclass(frozen=True)
class RequestAttribution:
    """One request's latency decomposition.  ``pid`` is the origin
    engine (where it was first queued); ``complete`` is False for
    requests still in flight when the trace ended — their components
    cover queued → last observed milestone instead."""
    rid: int
    pid: str
    complete: bool
    begin_ns: int
    end_ns: int
    components_ns: Dict[str, int]

    @property
    def end_to_end_ns(self) -> int:
        return self.end_ns - self.begin_ns

    @property
    def end_to_end_s(self) -> float:
        return self.end_to_end_ns / NS_PER_S

    def component_s(self, name: str) -> float:
        return self.components_ns[name] / NS_PER_S

    def dominant(self) -> str:
        """The component carrying the most latency (ties resolve in
        canonical ``COMPONENTS`` order)."""
        return max(COMPONENTS, key=lambda c: (self.components_ns[c],
                                              -COMPONENTS.index(c)))

    def to_dict(self) -> Dict:
        return {"rid": self.rid, "pid": self.pid, "complete": self.complete,
                "end_to_end_s": self.end_to_end_s,
                "components_s": {c: self.component_s(c)
                                 for c in COMPONENTS},
                "dominant": self.dominant()}


# ------------------------------------------------- milestone extraction ----
_TERMINAL_REASONS = ("finished", "done_at_prefill")


def _milestones(evts: Sequence) -> Tuple[Dict[int, List[Tuple[int, str, str]]],
                                         Dict[str, List[int]]]:
    """One pass over the event list: per-rid ordered milestones
    ``(t_ns, kind, pid)`` plus per-engine ``engine.oom`` instants (used
    to split queue waits into wait vs. backoff)."""
    per: Dict[int, List[Tuple[int, str, str]]] = {}
    ooms: Dict[str, List[int]] = {}
    for e in evts:
        a = e.args or {}
        name, ph = e.name, e.ph
        if name == "req.queued" and ph == INSTANT:
            per.setdefault(a["rid"], []).append(
                (_ns(e.wall_s), "queued", e.pid))
        elif name == "engine.prefill" and ph == BEGIN:
            for rid in (a.get("rids") or ()):
                if rid in per:
                    per[rid].append((_ns(e.wall_s), "prefill_begin", e.pid))
        elif name == "engine.prefix_hit" and ph == INSTANT:
            if a.get("rid") in per:
                per[a["rid"]].append((_ns(e.wall_s), "prefill_begin", e.pid))
        elif name == "req.first_token" and ph == INSTANT:
            if a.get("rid") in per:
                per[a["rid"]].append((_ns(e.wall_s), "first_token", e.pid))
        elif name == "req.decode" and ph == INSTANT:
            if a.get("rid") in per:
                per[a["rid"]].append((_ns(e.wall_s), "decode", e.pid))
        elif name == "req.freeze" and ph == INSTANT:
            if a.get("rid") in per:
                per[a["rid"]].append((_ns(e.wall_s), "freeze", e.pid))
        elif name == "req.thaw" and ph == INSTANT:
            if a.get("rid") in per:
                per[a["rid"]].append((_ns(e.wall_s), "thaw", e.pid))
        elif name == "req.slot" and ph == END \
                and a.get("reason") in _TERMINAL_REASONS:
            if a.get("rid") in per:
                per[a["rid"]].append((_ns(e.wall_s), "finished", e.pid))
        elif name == "engine.oom" and ph == INSTANT:
            ooms.setdefault(e.pid, []).append(_ns(e.wall_s))
    return per, ooms


def _attribute_one(rid: int, ms: List[Tuple[int, str, str]],
                   ooms: Dict[str, List[int]]) -> RequestAttribution:
    comp = {c: 0 for c in COMPONENTS}
    t0 = ms[0][0]
    end = t0
    for i in range(len(ms) - 1):
        t, kind, pid = ms[i]
        t_next, kind_next, pid_next = ms[i + 1]
        if kind == "finished":
            break               # nothing past the terminal edge counts
        dur = t_next - t
        if kind == "queued":
            # an engine.oom during this wait means the tail of it was
            # admission backoff, not ordinary queueing
            cut = next((o for o in ooms.get(pid, ()) if t < o <= t_next),
                       None)
            if cut is None:
                comp["queue_wait"] += dur
            else:
                comp["queue_wait"] += cut - t
                comp["retry_backoff"] += t_next - cut
        elif kind == "prefill_begin":
            comp["prefill"] += dur
        elif kind in ("first_token", "decode", "thaw"):
            comp["decode"] += dur
        elif kind == "freeze":
            # a frozen blob thawing on a *different* engine crossed a
            # link — that interval is the offload transfer; same-engine
            # thaw (or a fallback re-prefill) is plain migration wait
            if kind_next == "thaw" and pid_next != pid:
                comp["offload_link"] += dur
            else:
                comp["migration"] += dur
        end = t_next
    complete = any(k == "finished" for _, k, _ in ms)
    return RequestAttribution(rid=rid, pid=ms[0][2], complete=complete,
                              begin_ns=t0, end_ns=end, components_ns=comp)


def attribute_requests(rec_or_events) -> Dict[int, RequestAttribution]:
    """Per-request critical-path attribution over a recorder (or raw
    event sequence).  Only requests whose ``req.queued`` instant was
    recorded are attributed."""
    evts = getattr(rec_or_events, "events", rec_or_events)
    per, ooms = _milestones(evts)
    return {rid: _attribute_one(rid, ms, ooms)
            for rid, ms in per.items()}


# ------------------------------------------------------- fleet rollup ------
@dataclass(frozen=True)
class DeviceAttribution:
    """Component totals over one device's requests (origin-engine
    grouping), plus which component — and therefore which level —
    dominates overall and in the latency tail (slowest ~5%, at least
    one request)."""
    pid: str
    requests: int
    components_ns: Dict[str, int]
    end_to_end_ns: int
    tail_p95_ns: int
    dominant: str
    tail_dominant: str

    @property
    def dominant_layer(self) -> str:
        return COMPONENT_LAYER[self.dominant]

    @property
    def tail_dominant_layer(self) -> str:
        return COMPONENT_LAYER[self.tail_dominant]

    def to_dict(self) -> Dict:
        return {"pid": self.pid, "requests": self.requests,
                "end_to_end_s": self.end_to_end_ns / NS_PER_S,
                "components_s": {c: v / NS_PER_S
                                 for c, v in self.components_ns.items()},
                "tail_p95_s": self.tail_p95_ns / NS_PER_S,
                "dominant": self.dominant,
                "dominant_layer": self.dominant_layer,
                "tail_dominant": self.tail_dominant,
                "tail_dominant_layer": self.tail_dominant_layer}


@dataclass(frozen=True)
class FleetAttribution:
    per_device: Dict[str, DeviceAttribution]
    per_tier: Dict[str, DeviceAttribution]
    fleet: DeviceAttribution

    def ranking(self) -> List[Tuple[str, int]]:
        """Components ranked by fleet-wide total (descending)."""
        return sorted(self.fleet.components_ns.items(),
                      key=lambda kv: -kv[1])

    def to_dict(self) -> Dict:
        return {"per_device": {p: d.to_dict()
                               for p, d in self.per_device.items()},
                "per_tier": {t: d.to_dict()
                             for t, d in self.per_tier.items()},
                "fleet": self.fleet.to_dict(),
                "ranking": [c for c, _ in self.ranking()]}


def _rollup(pid: str, attrs: List[RequestAttribution]) -> DeviceAttribution:
    comp = {c: 0 for c in COMPONENTS}
    for a in attrs:
        for c in COMPONENTS:
            comp[c] += a.components_ns[c]
    e2e = [a.end_to_end_ns for a in attrs]
    total = sum(e2e)
    dominant = max(COMPONENTS, key=lambda c: (comp[c],
                                              -COMPONENTS.index(c)))
    if attrs:
        order = sorted(attrs, key=lambda a: a.end_to_end_ns)
        k = max(1, math.ceil(0.05 * len(attrs)))
        tail = order[-k:]
        tail_p95 = order[min(len(order) - 1,
                             math.ceil(0.95 * len(order)) - 1)].end_to_end_ns
        tcomp = {c: sum(a.components_ns[c] for a in tail)
                 for c in COMPONENTS}
        tail_dom = max(COMPONENTS, key=lambda c: (tcomp[c],
                                                  -COMPONENTS.index(c)))
    else:
        tail_p95, tail_dom = 0, COMPONENTS[0]
    return DeviceAttribution(pid=pid, requests=len(attrs),
                             components_ns=comp, end_to_end_ns=total,
                             tail_p95_ns=tail_p95, dominant=dominant,
                             tail_dominant=tail_dom)


def attribute_fleet(rec_or_events,
                    tiers: Optional[Dict[str, str]] = None
                    ) -> FleetAttribution:
    """Fleet-level rollup: group per-request attributions by origin
    device (and by tier when a ``pid → tier`` mapping is supplied) and
    rank which component — which *level* — dominates overall and tail
    latency.  All totals are integer-ns sums of the per-request values,
    so they equal the per-request components exactly."""
    attrs = list(attribute_requests(rec_or_events).values())
    by_pid: Dict[str, List[RequestAttribution]] = {}
    by_tier: Dict[str, List[RequestAttribution]] = {}
    for a in attrs:
        by_pid.setdefault(a.pid, []).append(a)
        if tiers:
            by_tier.setdefault(tiers.get(a.pid, "unknown"), []).append(a)
    return FleetAttribution(
        per_device={p: _rollup(p, v) for p, v in sorted(by_pid.items())},
        per_tier={t: _rollup(t, v) for t, v in sorted(by_tier.items())},
        fleet=_rollup("fleet", attrs))
