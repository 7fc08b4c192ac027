"""SLO classes and burn-rate tracking — the observability layer's
feedback signal into the adaptation loop.

An :class:`SLOClass` names latency targets (TTFT / TPOT at p95 / p99);
an :class:`SLOTracker` folds the engine's per-request observations into
rolling windows and scores each as an SRE-style **burn rate**: for an
objective "pX ≤ target", the allowed violation fraction is ``1 - X``,
and

    burn = (observed violation fraction) / (1 - X)

so ``burn == 1`` means the error budget is being spent exactly as fast
as it accrues, and ``burn > 1`` means the SLO will be missed if the
window's behavior persists.  Each window also keeps a P² histogram of
the raw observations (:class:`~repro_torch.obs.metrics.Histogram`, with its
serializable ``snapshot()`` marker state), so the same representation
flows into flight-recorder dumps and ``BENCH_*.json`` artifacts.

Events (``pid=obs_pid, tid="slo", cat="fleet"``):

* ``slo.burn``    — a window closed with burn above the page threshold;
* ``slo.page``    — pressure *engaged* (the pager fired): the
  :class:`~repro_torch.fleet.controller.FleetController` reacts by pulling
  placement forward and biasing every loop toward cheaper variants;
* ``slo.release`` — pressure released after ``release_windows``
  consecutive healthy windows (hysteresis — one good window never
  un-pages).

While healthy, :meth:`update` is pure bookkeeping: it touches no RNG,
reorders nothing, and returns 0.0, so SLO-tracked fault-free runs stay
bit-identical to untracked ones (pinned in ``tests/test_obs.py``).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

from .metrics import Histogram, MetricsRegistry
from .recorder import NULL_RECORDER

METRICS = ("ttft", "tpot")


@dataclass(frozen=True)
class SLOClass:
    """Latency targets for one service class.  ``None`` targets are
    untracked; at least one must be set."""
    name: str = "default"
    ttft_p95_s: Optional[float] = None
    ttft_p99_s: Optional[float] = None
    tpot_p95_s: Optional[float] = None
    tpot_p99_s: Optional[float] = None

    def objectives(self) -> List[Tuple[str, float, float]]:
        """``(metric, quantile, target_s)`` rows for the set targets."""
        out = []
        for metric, q, target in (("ttft", 0.95, self.ttft_p95_s),
                                  ("ttft", 0.99, self.ttft_p99_s),
                                  ("tpot", 0.95, self.tpot_p95_s),
                                  ("tpot", 0.99, self.tpot_p99_s)):
            if target is not None:
                out.append((metric, q, float(target)))
        if not out:
            raise ValueError(f"SLOClass {self.name!r} sets no targets")
        return out


class _Window:
    """One burn-rate window: per-metric P² histogram + exact violation
    counts per objective (counts, not quantile estimates, score the
    burn — the estimator summarizes, the counters decide)."""

    __slots__ = ("start_s", "hists", "counts", "bad")

    def __init__(self, start_s: float, objectives):
        self.start_s = start_s
        self.hists: Dict[str, Histogram] = {
            m: Histogram(f"slo.{m}_s") for m in METRICS}
        self.counts: Dict[str, int] = {m: 0 for m in METRICS}
        self.bad: Dict[Tuple[str, float], int] = {
            (m, q): 0 for m, q, _ in objectives}

    def observe(self, objectives, metric: str, value_s: float,
                n: int = 1) -> None:
        self.counts[metric] += n
        for _ in range(n):
            self.hists[metric].observe(value_s)
        for m, q, target in objectives:
            if m == metric and value_s > target:
                self.bad[(m, q)] += n

    def burn(self, objectives, min_count: int) -> float:
        worst = 0.0
        for m, q, _ in objectives:
            n = self.counts[m]
            if n < min_count:
                continue
            worst = max(worst, (self.bad[(m, q)] / n) / (1.0 - q))
        return worst

    def snapshot(self, objectives, min_count: int) -> Dict:
        return {"start_s": self.start_s,
                "burn": self.burn(objectives, min_count),
                "counts": dict(self.counts),
                "bad": {f"{m}_p{q * 100:g}": v
                        for (m, q), v in self.bad.items()},
                "hists": {m: h.snapshot() for m, h in self.hists.items()
                          if h.count}}


class SLOTracker:
    """Rolling burn-rate evaluation with hysteretic pressure.

    ``observe()`` is the engine-side feed (the engine calls it with
    TTFT at first token and per-token step time); ``update(now)`` is
    the controller-side consumption: it rotates windows on the fleet
    clock and returns the current **pressure** — 0.0 while healthy,
    ``max(burn, 1)`` while paging.  Pressure engages the moment burn
    crosses ``page_burn`` (live window included, so a load spike pages
    within one wake) and releases only after ``release_windows``
    consecutive *closed* windows at or below ``release_burn``."""

    def __init__(self, slo: SLOClass, *, window_s: float = 1.0,
                 min_count: int = 4, page_burn: float = 1.0,
                 release_burn: float = 0.5, release_windows: int = 2,
                 history: int = 32,
                 clock: Optional[Callable[[], float]] = None,
                 recorder=NULL_RECORDER,
                 metrics: Optional[MetricsRegistry] = None,
                 obs_pid: str = "fleet"):
        self.slo = slo
        self._objectives = slo.objectives()
        self.window_s = float(window_s)
        self.min_count = int(min_count)
        self.page_burn = float(page_burn)
        self.release_burn = float(release_burn)
        self.release_windows = int(release_windows)
        self.clock = clock if clock is not None else time.perf_counter
        self.recorder = recorder
        self.obs_pid = obs_pid
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._burn_gauge = self.metrics.gauge("slo.burn_rate")
        self._pressure_gauge = self.metrics.gauge("slo.pressure")
        self._page_counter = self.metrics.counter("slo.pages")
        self._burn_counter = self.metrics.counter("slo.burn_windows")
        self._live: Optional[_Window] = None
        self._last_closed_burn = 0.0
        self._healthy_streak = 0
        self.pressure = 0.0
        self.history: Deque[Dict] = deque(maxlen=history)

    # ------------------------------------------------------------ wiring --
    def bind(self, *, clock=None, recorder=None) -> None:
        """Adopt the fleet's clock/recorder (the controller calls this;
        an explicitly-configured recorder is kept)."""
        if clock is not None:
            self.clock = clock
        if recorder is not None and recorder.enabled \
                and not self.recorder.enabled:
            self.recorder = recorder

    # ------------------------------------------------------------- feed --
    def observe(self, metric: str, value_s: float, n: int = 1) -> None:
        """Record ``n`` observations of ``value_s`` for ``metric``
        (``"ttft"`` or ``"tpot"``) into the live window."""
        if metric not in METRICS:
            raise ValueError(f"unknown SLO metric {metric!r}; "
                             f"expected one of {METRICS}")
        if self._live is None:
            self._live = _Window(self.clock(), self._objectives)
        self._live.observe(self._objectives, metric, value_s, n)

    # ------------------------------------------------------- evaluation --
    def _close_window(self, w: _Window) -> None:
        burn = w.burn(self._objectives, self.min_count)
        self._last_closed_burn = burn
        self.history.append(w.snapshot(self._objectives, self.min_count))
        if burn > self.page_burn:
            self._burn_counter.inc()
            if self.recorder.enabled:
                self.recorder.instant(
                    "slo.burn", pid=self.obs_pid, tid="slo", cat="fleet",
                    args={"burn": burn, "slo": self.slo.name,
                          "window_start_s": w.start_s})
        if self.pressure > 0.0:
            if burn <= self.release_burn:
                self._healthy_streak += 1
            else:
                self._healthy_streak = 0

    def update(self, now_s: Optional[float] = None) -> float:
        """Rotate windows up to ``now``, re-evaluate burn, and return
        the current pressure.  Pure bookkeeping — safe to call on every
        fleet wake."""
        now = self.clock() if now_s is None else now_s
        while self._live is not None \
                and now - self._live.start_s >= self.window_s:
            w = self._live
            # an idle gap longer than one window closes as a single
            # (healthy) window instead of iterating through empty ones
            nxt = (w.start_s + self.window_s
                   if now - w.start_s < 2 * self.window_s else now)
            self._live = _Window(nxt, self._objectives)
            self._close_window(w)
        live_burn = (self._live.burn(self._objectives, self.min_count)
                     if self._live is not None else 0.0)
        burn = max(live_burn, self._last_closed_burn)
        self._burn_gauge.set(burn)
        if self.pressure == 0.0:
            if burn > self.page_burn:
                self.pressure = max(burn, 1.0)
                self._healthy_streak = 0
                self._page_counter.inc()
                if self.recorder.enabled:
                    self.recorder.instant(
                        "slo.page", pid=self.obs_pid, tid="slo",
                        cat="fleet",
                        args={"burn": burn, "slo": self.slo.name})
        else:
            if self._healthy_streak >= self.release_windows \
                    and burn <= self.release_burn:
                self.pressure = 0.0
                self._healthy_streak = 0
                if self.recorder.enabled:
                    self.recorder.instant(
                        "slo.release", pid=self.obs_pid, tid="slo",
                        cat="fleet",
                        args={"burn": burn, "slo": self.slo.name})
            else:
                self.pressure = max(burn, 1.0)
        self._pressure_gauge.set(self.pressure)
        return self.pressure

    def state(self) -> Dict:
        """Serializable tracker state (window history with full
        histogram snapshots) — what flight dumps and bench artifacts
        embed."""
        return {"slo": self.slo.name,
                "objectives": [{"metric": m, "q": q, "target_s": t}
                               for m, q, t in self._objectives],
                "window_s": self.window_s,
                "pressure": self.pressure,
                "burn": self._last_closed_burn,
                "windows": list(self.history)}
