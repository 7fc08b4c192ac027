"""Chrome-trace / Perfetto export for recorded spans.

``chrome_trace`` renders a :class:`~repro_torch.obs.recorder.TraceRecorder`'s
events as the Chrome trace-event JSON format (the ``traceEvents`` array
flavor), loadable in ``chrome://tracing`` and https://ui.perfetto.dev:

* pid = device (``process_name`` metadata carries the device id),
* tid = slot/subsystem lane (``thread_name`` metadata),
* ts  = microseconds on the chosen clock.

Clock selection (``clock=``):

* ``"auto"`` (default) — the simulated fleet clock when *every* event
  carries one (a fleet run), else the wall clock (a standalone engine).
  Mixing is never allowed: one timeline, one timebase.
* ``"sim"`` / ``"wall"`` — force a clock; ``"sim"`` raises if any event
  lacks a simulated timestamp.

Whichever clock becomes ``ts``, the other is preserved per-event in
``args`` (``wall_s`` or ``sim_s``), so the causal chain can always be
cross-referenced against the other timebase.
"""
from __future__ import annotations

import json
from typing import Dict, List

from .recorder import Event, TraceRecorder

CLOCKS = ("auto", "sim", "wall")


def _pick_clock(events: List[Event], clock: str) -> str:
    if clock not in CLOCKS:
        raise ValueError(f"unknown clock {clock!r}; expected one of {CLOCKS}")
    if clock == "auto":
        return ("sim" if events and all(e.sim_s is not None for e in events)
                else "wall")
    if clock == "sim" and any(e.sim_s is None for e in events):
        raise ValueError("clock='sim' but some events carry no simulated "
                         "timestamp (standalone-engine events?)")
    return clock


def chrome_trace(recorder: TraceRecorder, clock: str = "auto") -> Dict:
    """Render the recorder's events as a Chrome trace dict."""
    events = recorder.events
    chosen = _pick_clock(events, clock)
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    rows: List[Dict] = []
    stacks: Dict[tuple, List[Dict]] = {}    # open B rows per (pid, tid)
    last_ts: Dict[tuple, float] = {}
    orphaned_ends = 0
    for e in events:
        if e.pid not in pids:
            pids[e.pid] = len(pids) + 1
            rows.append({"name": "process_name", "ph": "M",
                         "pid": pids[e.pid], "tid": 0,
                         "args": {"name": e.pid}})
        tkey = (e.pid, e.tid)
        if tkey not in tids:
            tids[tkey] = len(tids) + 1
            rows.append({"name": "thread_name", "ph": "M",
                         "pid": pids[e.pid], "tid": tids[tkey],
                         "args": {"name": e.tid}})
        ts_s = e.sim_s if chosen == "sim" else e.wall_s
        if e.ph == "E" and not stacks.get((e.pid, e.tid)):
            # an END whose BEGIN aged out of a bounded ring / saturated
            # recorder: emitting it would fail span-discipline checks,
            # so count it instead — otherData carries the tally
            orphaned_ends += 1
            continue
        args = dict(e.args) if e.args else {}
        # preserve the other clock so either timebase can be recovered
        if chosen == "sim":
            args.setdefault("wall_s", e.wall_s)
        elif e.sim_s is not None:
            args.setdefault("sim_s", e.sim_s)
        row = {"name": e.name, "cat": e.cat, "ph": e.ph,
               "ts": ts_s * 1e6, "pid": pids[e.pid], "tid": tids[tkey]}
        if args:
            row["args"] = args
        rows.append(row)
        last_ts[tkey] = row["ts"]
        if e.ph == "B":
            stacks.setdefault(tkey, []).append(row)
        elif e.ph == "E":
            stack = stacks.get(tkey)
            if stack:
                stack.pop()
    # close spans still open at export (e.g. requests in flight when the
    # run's horizon ended): a snapshot mid-run must still be a complete,
    # validating trace.  Synthetic ends land at the track's last ts and
    # are marked so queries can tell them from real completions.
    for tkey, stack in stacks.items():
        for b in reversed(stack):
            rows.append({"name": b["name"], "cat": b["cat"], "ph": "E",
                         "ts": last_ts[tkey], "pid": b["pid"],
                         "tid": b["tid"],
                         "args": {"open_at_export": True}})
    return {"traceEvents": rows, "displayTimeUnit": "ms",
            "otherData": {"clock": chosen,
                          "dropped_events": recorder.dropped,
                          "orphaned_ends": orphaned_ends}}


def write_trace(recorder: TraceRecorder, path: str,
                clock: str = "auto") -> str:
    """Write ``chrome_trace(recorder)`` to ``path`` (returns ``path``).
    Open the file in Perfetto (https://ui.perfetto.dev → "Open trace
    file") or ``chrome://tracing``."""
    with open(path, "w") as f:
        # args may carry rich objects (VariantSpec, tuples of hosts):
        # stringify anything json doesn't know rather than failing a run
        # at export time
        json.dump(chrome_trace(recorder, clock=clock), f, default=str)
    return path
