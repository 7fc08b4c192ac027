"""Structured span/event recording with dual timestamps.

Every event carries **two clocks**:

* ``wall_s`` — host ``time.perf_counter()`` at emission (always set);
* ``sim_s`` — the fleet's simulated clock, when a ``sim_clock``
  callable is installed (the :class:`FleetController` installs
  ``lambda: self._now``), else ``None``.

That pairing is what lets a heterogeneous fleet run render as ONE
timeline: engine decode ticks measured in wall microseconds and fleet
clock events measured in simulated seconds land on a shared timebase
(the exporter picks the simulated clock when every event has it).

Two recorders implement the same four-method surface:

* :class:`NullRecorder` — the default everywhere.  ``enabled`` is
  ``False`` and every method is a no-op ``pass``; hot paths guard arg
  construction behind ``if recorder.enabled`` so a disabled engine pays
  one attribute load per tick.
* :class:`TraceRecorder` — appends :class:`Event` rows to an in-memory
  list (bounded by ``capacity``).

Span discipline: ``begin``/``end`` pairs must nest per ``(pid, tid)``
track — pid is the device (or ``"fleet"`` for fleet-global events), tid
the slot/subsystem lane.  ``instant`` events never affect nesting.

Layer categories (``cat``) — the four layers of the cross-level loop:

* ``"request"``   — request lifecycle (queued → admit → decode → finish)
* ``"engine"``    — engine steps, prefill calls, compiles, swaps
* ``"fleet"``     — device wakes, telemetry merges, recalibration,
                    loop decisions, drop/inject events
* ``"placement"`` — placement sweeps and per-requester decisions
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

# the four span layers; tools/check_trace.py can require all of them
LAYERS = ("request", "engine", "fleet", "placement")

# event phases (a subset of the Chrome trace-event phases)
BEGIN, END, INSTANT, COUNTER = "B", "E", "i", "C"


@dataclass(frozen=True)
class Event:
    """One recorded event.  ``ph`` is the Chrome-trace phase (``B``/``E``
    span edges, ``i`` instant, ``C`` counter); ``pid``/``tid`` name the
    process (device) and thread (slot/subsystem) tracks; ``args`` is a
    small JSON-serializable payload."""
    name: str
    cat: str
    ph: str
    wall_s: float
    sim_s: Optional[float]
    pid: str
    tid: str
    args: Optional[Dict[str, object]] = None


class NullRecorder:
    """The disabled recorder: every call is a no-op.  Hot paths check
    ``enabled`` before building args, so the per-tick cost of disabled
    observability is one attribute load and a branch."""

    enabled = False
    __slots__ = ()

    def begin(self, name: str, *, pid: str, tid: str, cat: str = "engine",
              wall_s: Optional[float] = None,
              args: Optional[Dict[str, object]] = None) -> None:
        pass

    def end(self, name: str, *, pid: str, tid: str, cat: str = "engine",
            wall_s: Optional[float] = None,
            args: Optional[Dict[str, object]] = None) -> None:
        pass

    def instant(self, name: str, *, pid: str, tid: str,
                cat: str = "engine", wall_s: Optional[float] = None,
                args: Optional[Dict[str, object]] = None) -> None:
        pass

    def counter(self, name: str, *, pid: str, tid: str = "counters",
                cat: str = "engine", value: float = 0.0,
                wall_s: Optional[float] = None) -> None:
        pass


# the shared default: safe to hand to any number of components because
# it is stateless
NULL_RECORDER = NullRecorder()


class TraceRecorder:
    """In-memory event recorder.

    ``sim_clock`` supplies the simulated-clock reading per event (the
    fleet controller installs its own ``_now``); without one, events
    carry ``sim_s=None`` and the exporter falls back to the wall clock.
    ``capacity`` bounds the event list — when full, recording *stops*
    (dropping the newest, never corrupting span nesting mid-trace) and
    ``dropped`` counts what was lost."""

    enabled = True

    def __init__(self, sim_clock: Optional[Callable[[], float]] = None,
                 capacity: int = 1_000_000):
        self.events: List[Event] = []
        self.sim_clock = sim_clock
        self.capacity = capacity
        self.dropped = 0

    # ------------------------------------------------------------- emit --
    def _emit(self, name: str, cat: str, ph: str, pid: str, tid: str,
              wall_s: Optional[float],
              args: Optional[Dict[str, object]]) -> None:
        if len(self.events) >= self.capacity:
            self.dropped += 1
            return
        self.events.append(Event(
            name=name, cat=cat, ph=ph,
            wall_s=time.perf_counter() if wall_s is None else wall_s,
            sim_s=self.sim_clock() if self.sim_clock is not None else None,
            pid=pid, tid=tid, args=args))

    def begin(self, name: str, *, pid: str, tid: str, cat: str = "engine",
              wall_s: Optional[float] = None,
              args: Optional[Dict[str, object]] = None) -> None:
        self._emit(name, cat, BEGIN, pid, tid, wall_s, args)

    def end(self, name: str, *, pid: str, tid: str, cat: str = "engine",
            wall_s: Optional[float] = None,
            args: Optional[Dict[str, object]] = None) -> None:
        self._emit(name, cat, END, pid, tid, wall_s, args)

    def instant(self, name: str, *, pid: str, tid: str,
                cat: str = "engine", wall_s: Optional[float] = None,
                args: Optional[Dict[str, object]] = None) -> None:
        self._emit(name, cat, INSTANT, pid, tid, wall_s, args)

    def counter(self, name: str, *, pid: str, tid: str = "counters",
                cat: str = "engine", value: float = 0.0,
                wall_s: Optional[float] = None) -> None:
        self._emit(name, cat, COUNTER, pid, tid, wall_s, {"value": value})

    # ------------------------------------------------------------ query --
    def __len__(self) -> int:
        return len(self.events)

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0
