"""Query helpers over recorded events: span pairing + request metrics.

Benchmarks and tests should derive latency figures from spans through
these helpers instead of re-implementing hand-stamped arithmetic —
``request_ttft_s`` is the span-derived replacement for the legacy
``first_token_s - arrived_s`` subtraction (and is asserted equal to it
in ``tests/test_obs.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

from .recorder import BEGIN, END, INSTANT, Event, TraceRecorder


@dataclass(frozen=True)
class Span:
    """A paired begin/end: ``args`` merges the begin args with the end
    args (end wins on key collisions — it carries the outcome)."""
    name: str
    cat: str
    pid: str
    tid: str
    wall_begin_s: float
    wall_end_s: float
    sim_begin_s: Optional[float]
    sim_end_s: Optional[float]
    args: Dict[str, object]

    @property
    def wall_dur_s(self) -> float:
        return self.wall_end_s - self.wall_begin_s

    @property
    def sim_dur_s(self) -> Optional[float]:
        if self.sim_begin_s is None or self.sim_end_s is None:
            return None
        return self.sim_end_s - self.sim_begin_s


def events(rec: TraceRecorder, name: Optional[str] = None,
           cat: Optional[str] = None, ph: Optional[str] = None,
           pid: Optional[str] = None, tid: Optional[str] = None,
           **arg_filters) -> Iterator[Event]:
    """Filtered view over the raw event list; ``arg_filters`` match
    against ``Event.args`` entries (missing key = no match)."""
    for e in rec.events:
        if name is not None and e.name != name:
            continue
        if cat is not None and e.cat != cat:
            continue
        if ph is not None and e.ph != ph:
            continue
        if pid is not None and e.pid != pid:
            continue
        if tid is not None and e.tid != tid:
            continue
        if arg_filters:
            a = e.args or {}
            if any(k not in a or a[k] != v
                   for k, v in arg_filters.items()):
                continue
        yield e


def instants(rec: TraceRecorder, name: Optional[str] = None,
             **kw) -> List[Event]:
    return list(events(rec, name=name, ph=INSTANT, **kw))


@dataclass
class PairingReport:
    """What :func:`pair_spans` recovered from a (possibly truncated)
    trace: the well-paired spans plus counts of edges that could not
    pair — ``orphaned_ends`` (an END whose BEGIN was dropped at the
    recorder's capacity ceiling or aged out of a flight ring) and
    ``unclosed_begins`` (a BEGIN whose END was dropped / hadn't landed
    yet).  ``truncated`` records whether the source recorder reported
    dropped events — only then is lenient accounting legitimate."""
    spans: List[Span]
    orphaned_ends: int = 0
    unclosed_begins: int = 0
    truncated: bool = False


def pair_spans(evts, dropped: int = 0,
               strict: Optional[bool] = None) -> PairingReport:
    """Pair begin/end events into :class:`Span` rows, walking each
    ``(pid, tid)`` track with a stack (spans must nest per track — the
    recording discipline the property tests pin).

    On a complete trace (``dropped == 0``, the default ``strict``) a
    mismatched or dangling edge raises, because a malformed trace
    should fail the query, not silently drop rows.  When the recorder
    *reported truncation* (``dropped > 0``) the same defects are an
    expected artifact of the lost events, so pairing degrades to a
    counted report: orphaned ENDs are skipped (never popping an
    unrelated frame), dangling BEGINs are tallied, and every span that
    did survive is still returned."""
    if strict is None:
        strict = dropped == 0
    stacks: Dict[tuple, List[Event]] = {}
    out: List[Span] = []
    orphaned = 0
    for e in evts:
        if e.ph not in (BEGIN, END):
            continue
        key = (e.pid, e.tid)
        stack = stacks.setdefault(key, [])
        if e.ph == BEGIN:
            stack.append(e)
            continue
        if not stack:
            if strict:
                raise ValueError(f"end without begin: {e.name!r} on {key}")
            orphaned += 1
            continue
        if stack[-1].name != e.name:
            if strict:
                raise ValueError(f"mis-nested spans on {key}: begin "
                                 f"{stack[-1].name!r} closed by end "
                                 f"{e.name!r}")
            # the matching BEGIN was dropped; popping the (unrelated)
            # top frame would corrupt an outer span's pairing
            orphaned += 1
            continue
        b = stack.pop()
        merged = dict(b.args or {})
        merged.update(e.args or {})
        out.append(Span(name=b.name, cat=b.cat, pid=b.pid, tid=b.tid,
                        wall_begin_s=b.wall_s, wall_end_s=e.wall_s,
                        sim_begin_s=b.sim_s, sim_end_s=e.sim_s,
                        args=merged))
    unclosed = 0
    for key, stack in stacks.items():
        if stack:
            if strict:
                raise ValueError(f"unclosed span(s) on {key}: "
                                 f"{[b.name for b in stack]}")
            unclosed += len(stack)
    return PairingReport(spans=out, orphaned_ends=orphaned,
                         unclosed_begins=unclosed,
                         truncated=dropped > 0)


def spans(rec: TraceRecorder, name: Optional[str] = None,
          cat: Optional[str] = None, pid: Optional[str] = None,
          tid: Optional[str] = None,
          strict: Optional[bool] = None) -> List[Span]:
    """Paired :class:`Span` rows (see :func:`pair_spans` for the
    pairing/strictness contract — a saturated recorder degrades to
    lenient pairing instead of raising on its truncation artifacts).
    Filters apply to the *paired* spans, so an enclosing span of
    another name never hides its children."""
    report = pair_spans(rec.events, dropped=getattr(rec, "dropped", 0),
                        strict=strict)

    def keep(s: Span) -> bool:
        return ((name is None or s.name == name)
                and (cat is None or s.cat == cat)
                and (pid is None or s.pid == pid)
                and (tid is None or s.tid == tid))

    return [s for s in report.spans if keep(s)]


# ------------------------------------------------------ request metrics ----
def request_ttft_s(rec: TraceRecorder,
                   pid: Optional[str] = None) -> Dict[int, float]:
    """Span-derived time-to-first-token per rid (wall clock): first
    ``req.queued`` instant → first ``req.first_token`` instant.  Both
    instants are stamped with the exact floats the engine writes into
    ``Request.arrived_s`` / ``first_token_s``, so this equals the
    legacy subtraction bit-for-bit."""
    queued: Dict[int, float] = {}
    first: Dict[int, float] = {}
    for e in events(rec, name="req.queued", ph=INSTANT, pid=pid):
        rid = e.args["rid"]
        queued.setdefault(rid, e.wall_s)
    for e in events(rec, name="req.first_token", ph=INSTANT, pid=pid):
        rid = e.args["rid"]
        first.setdefault(rid, e.wall_s)
    return {rid: first[rid] - queued[rid]
            for rid in first if rid in queued}


def request_token_counts(rec: TraceRecorder,
                         pid: Optional[str] = None
                         ) -> Dict[int, Dict[str, int]]:
    """Per rid: how many admissions (``first_token`` instants — each
    admission's prefill emits exactly one) and how many decode-tick
    tokens (``req.decode`` instants).  Total tokens generated for a rid
    is ``admissions + decodes``."""
    out: Dict[int, Dict[str, int]] = {}
    for e in events(rec, name="req.first_token", ph=INSTANT, pid=pid):
        d = out.setdefault(e.args["rid"], {"admissions": 0, "decodes": 0})
        d["admissions"] += 1
    for e in events(rec, name="req.decode", ph=INSTANT, pid=pid):
        d = out.setdefault(e.args["rid"], {"admissions": 0, "decodes": 0})
        d["decodes"] += 1
    return out


def request_tpot_s(rec: TraceRecorder,
                   pid: Optional[str] = None) -> Dict[int, float]:
    """Span-derived mean time-per-output-token per rid: the wall span
    from the first token to the last decode instant, divided by the
    decode-token count (undefined — omitted — for rids that never
    decoded past their prefill token)."""
    first: Dict[int, float] = {}
    last: Dict[int, float] = {}
    count: Dict[int, int] = {}
    for e in events(rec, name="req.first_token", ph=INSTANT, pid=pid):
        first.setdefault(e.args["rid"], e.wall_s)
    for e in events(rec, name="req.decode", ph=INSTANT, pid=pid):
        rid = e.args["rid"]
        last[rid] = e.wall_s
        count[rid] = count.get(rid, 0) + 1
    return {rid: (last[rid] - first[rid]) / count[rid]
            for rid in count if rid in first and count[rid] > 0}
