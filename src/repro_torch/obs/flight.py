"""Flight recorder: a bounded ring of trace events with anomaly dumps.

A long-running fleet cannot keep its whole timeline in memory, but the
seconds *around* an anomaly are exactly what a post-mortem needs.
:class:`FlightRecorder` is a drop-in :class:`~repro_torch.obs.recorder
.TraceRecorder` whose event list is a fixed-size ring (oldest events
evicted, ``dropped`` counts evictions so span queries degrade to the
lenient pairing path automatically).  When a trigger instant lands —
by default ``detector.dead``, ``engine.oom``, ``slo.page``,
``fleet.evict`` — it arms a dump of the last ``window_s`` seconds of
trace; the dump finalizes once ``post_roll_s`` more trace has streamed
past (or at :meth:`flush`), so the capture brackets the anomaly rather
than ending on it.

Dumps are full Chrome-trace documents (rendered through
:func:`~repro_torch.obs.export.chrome_trace`, which closes spans left open at
the window edge and drops ENDs whose BEGIN fell outside it), so every
dump validates through ``tools/check_trace.py`` — truncation is flagged
via ``otherData.dropped_events``, never a validation failure.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .export import chrome_trace
from .recorder import Event, INSTANT, TraceRecorder

DEFAULT_TRIGGERS = ("detector.dead", "engine.oom", "slo.page",
                    "fleet.evict")


class _RingView:
    """The minimal recorder surface ``chrome_trace`` consumes: a slice
    of the ring plus an honest dropped count (ring evictions + events
    clipped off the front of the window)."""

    __slots__ = ("events", "dropped")

    def __init__(self, events: List[Event], dropped: int):
        self.events = events
        self.dropped = dropped


class FlightRecorder(TraceRecorder):
    """A :class:`TraceRecorder` over a bounded ring, with triggered
    post-mortem dumps.  Pass it anywhere a recorder goes (engine,
    controller) — recording never stops; only the oldest events age
    out."""

    def __init__(self, sim_clock=None, capacity: int = 8192,
                 window_s: float = 5.0, post_roll_s: float = 0.5,
                 triggers: Tuple[str, ...] = DEFAULT_TRIGGERS,
                 max_dumps: int = 16):
        super().__init__(sim_clock=sim_clock, capacity=capacity)
        self.events = deque(maxlen=capacity)      # ring, not a stop-list
        self.window_s = float(window_s)
        self.post_roll_s = float(post_roll_s)
        self.triggers = tuple(triggers)
        self.max_dumps = int(max_dumps)
        self.dumps: List[Dict] = []
        self._pending: List[Tuple[Event, float]] = []

    # ------------------------------------------------------------- emit --
    def _clock_of(self, e: Event) -> float:
        # one timebase per dump, same rule as the exporter's "auto":
        # the sim clock only when every ringed event carries one
        use_sim = all(ev.sim_s is not None for ev in self.events)
        return e.sim_s if (use_sim and e.sim_s is not None) else e.wall_s

    def _emit(self, name, cat, ph, pid, tid, wall_s, args) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1           # the ring evicts its oldest
        e = Event(name=name, cat=cat, ph=ph,
                  wall_s=time.perf_counter() if wall_s is None else wall_s,
                  sim_s=self.sim_clock() if self.sim_clock is not None
                  else None,
                  pid=pid, tid=tid, args=args)
        self.events.append(e)
        ts = self._clock_of(e)
        if self._pending:
            self._finalize_due(ts)
        if ph == INSTANT and name in self.triggers \
                and len(self.dumps) + len(self._pending) < self.max_dumps:
            self._pending.append((e, ts + self.post_roll_s))

    # ------------------------------------------------------------ dumps --
    def _finalize_due(self, now_ts: float) -> None:
        due = [p for p in self._pending if now_ts >= p[1]]
        if due:
            self._pending = [p for p in self._pending if now_ts < p[1]]
            for trig, deadline in due:
                self.dumps.append(self._dump(trig, deadline))

    def _dump(self, trigger: Event, until_ts: float) -> Dict:
        trig_ts = self._clock_of(trigger)
        lo = trig_ts - self.window_s
        use_sim = all(ev.sim_s is not None for ev in self.events)
        clock = "sim" if use_sim else "wall"

        def ts_of(ev: Event) -> float:
            return ev.sim_s if use_sim else ev.wall_s

        window = [ev for ev in self.events if lo <= ts_of(ev) <= until_ts]
        clipped = sum(1 for ev in self.events if ts_of(ev) < lo)
        trace = chrome_trace(_RingView(window, self.dropped + clipped),
                             clock=clock)
        return {"anomaly": trigger.name, "pid": trigger.pid,
                "args": dict(trigger.args or {}), "ts_s": trig_ts,
                "clock": clock, "events": len(window), "trace": trace}

    def snapshot(self, anomaly: str = "manual") -> Dict:
        """Dump the current window unconditionally (post-mortems of
        conditions the trigger list doesn't name)."""
        if not self.events:
            raise ValueError("flight ring is empty — nothing to snapshot")
        marker = self.events[-1]
        dump = self._dump(
            Event(name=anomaly, cat="fleet", ph=INSTANT,
                  wall_s=marker.wall_s, sim_s=marker.sim_s,
                  pid=marker.pid, tid=marker.tid, args=None),
            self._clock_of(marker))
        self.dumps.append(dump)
        return dump

    def flush(self) -> List[Dict]:
        """Finalize every armed dump regardless of post-roll (end of
        run) and return all dumps."""
        self._finalize_due(float("inf"))
        return self.dumps

    def write_dumps(self, directory: str) -> List[str]:
        """Write each dump's trace as ``flight_<n>_<anomaly>.json``
        under ``directory`` (validated post-mortem artifacts — run
        ``tools/check_trace.py`` over them)."""
        self.flush()
        os.makedirs(directory, exist_ok=True)
        paths = []
        for i, d in enumerate(self.dumps):
            safe = d["anomaly"].replace(".", "_").replace("/", "_")
            path = os.path.join(directory, f"flight_{i}_{safe}.json")
            with open(path, "w") as f:
                json.dump(d["trace"], f, default=str)
            paths.append(path)
        return paths

    def clear(self) -> None:
        super().clear()
        self.dumps = []
        self._pending = []
