"""Metrics registry: counters, gauges, EWMA gauges, streaming quantiles.

One :class:`MetricsRegistry` per subsystem (each :class:`ServingEngine`
and :class:`FleetController` owns one) replaces the scattered ad-hoc
stat fields that used to live on them — ``ServeStats`` counters,
``step_time_ewma_s``, the fleet's wake/violation/energy tallies — so
every runtime signal has one canonical home and the legacy public
attributes become *views* over it.

Design constraints, in order:

* **Bit-identical legacy behavior.**  :class:`EwmaGauge` computes
  ``(1-α)·prev + α·x`` with exactly the float operations the old inline
  EWMA used, so the fleet's tick-envelope arithmetic (which consumes
  ``step_time_ewma_s``) cannot drift by an ulp.
* **Hot-path cheap.**  Counters are a bare attribute add; histograms
  use the P² streaming-quantile estimator (five markers per tracked
  quantile, O(1) per observation, no sample buffer growth) so decode
  ticks never pay for sorting or unbounded memory.
* **No global state.**  Registries are plain objects; nothing here
  touches module-level singletons, so two engines never share a
  counter by accident.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union


class Counter:
    """A monotonically *intended* counter (plain assignable ``value`` so
    legacy ``stats.steps += 1`` view-properties can write through)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Union[int, float] = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value (``None`` until first set)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = v


class EwmaGauge:
    """Exponentially weighted moving average of a stream.

    ``update`` computes ``(1-α)·prev + α·x`` — the literal expression
    the serving engine's inline ``_step_ewma`` used — so replacing that
    private field with this gauge is bit-identical, which the fleet's
    next-wake arithmetic depends on."""

    __slots__ = ("name", "alpha", "value")

    def __init__(self, name: str, alpha: float = 0.2):
        self.name = name
        self.alpha = alpha
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        self.value = (x if self.value is None
                      else (1.0 - self.alpha) * self.value + self.alpha * x)
        return self.value


class _P2:
    """P² streaming estimator for one quantile (Jain & Chlamtac 1985):
    five markers whose heights approximate the quantile without storing
    observations.  Exact below five samples."""

    __slots__ = ("q", "n", "heights", "positions", "desired", "incr")

    def __init__(self, q: float):
        self.q = q
        self.n: List[float] = []          # first five samples, sorted lazily
        self.heights: List[float] = []
        self.positions = [1.0, 2.0, 3.0, 4.0, 5.0]
        self.desired = [1.0, 1.0 + 2 * q, 1.0 + 4 * q, 3.0 + 2 * q, 5.0]
        self.incr = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def observe(self, x: float) -> None:
        if len(self.heights) < 5:
            self.n.append(x)
            if len(self.n) == 5:
                self.n.sort()
                self.heights = list(self.n)
            return
        h = self.heights
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self.positions[i] += 1.0
        for i in range(5):
            self.desired[i] += self.incr[i]
        for i in (1, 2, 3):
            d = self.desired[i] - self.positions[i]
            pos, prev, nxt = (self.positions[i], self.positions[i - 1],
                              self.positions[i + 1])
            if (d >= 1.0 and nxt - pos > 1.0) or \
                    (d <= -1.0 and prev - pos < -1.0):
                d = 1.0 if d > 0 else -1.0
                # parabolic interpolation, falling back to linear
                hp = h[i] + d / (nxt - prev) * (
                    (pos - prev + d) * (h[i + 1] - h[i]) / (nxt - pos)
                    + (nxt - pos - d) * (h[i] - h[i - 1]) / (pos - prev))
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:
                    j = i + (1 if d > 0 else -1)
                    h[i] += d * (h[j] - h[i]) / (self.positions[j] - pos)
                self.positions[i] += d

    def estimate(self) -> Optional[float]:
        if self.heights:
            return self.heights[2]
        if not self.n:
            return None
        s = sorted(self.n)
        idx = min(len(s) - 1, max(0, round(self.q * (len(s) - 1))))
        return s[int(idx)]

    # ------------------------------------------------- (de)serialization --
    def state(self) -> Dict[str, object]:
        """The full marker state — restoring it resumes the estimator
        exactly (continued observations are bit-identical)."""
        return {"q": self.q, "n": list(self.n),
                "heights": list(self.heights),
                "positions": list(self.positions),
                "desired": list(self.desired), "incr": list(self.incr)}

    @classmethod
    def from_state(cls, d: Dict[str, object]) -> "_P2":
        est = cls(float(d["q"]))
        est.n = list(d["n"])
        est.heights = list(d["heights"])
        est.positions = list(d["positions"])
        est.desired = list(d["desired"])
        est.incr = list(d["incr"])
        return est


class Histogram:
    """Streaming distribution summary: count/sum/min/max plus a P²
    estimator per tracked quantile.  O(#quantiles) per observation,
    O(1) memory — safe on the decode hot path."""

    __slots__ = ("name", "count", "sum", "min", "max", "_est")

    DEFAULT_QUANTILES = (0.5, 0.95, 0.99, 0.999)

    def __init__(self, name: str,
                 quantiles: Iterable[float] = DEFAULT_QUANTILES):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._est: Dict[float, _P2] = {q: _P2(q) for q in quantiles}

    def observe(self, x: float) -> None:
        self.count += 1
        self.sum += x
        if self.min is None or x < self.min:
            self.min = x
        if self.max is None or x > self.max:
            self.max = x
        for est in self._est.values():
            est.observe(x)

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def quantile(self, q: float) -> Optional[float]:
        est = self._est.get(q)
        if est is None:
            raise KeyError(f"quantile {q} not tracked by {self.name!r}; "
                           f"tracked: {sorted(self._est)}")
        return est.estimate()

    def snapshot(self, state: bool = True) -> Dict[str, object]:
        """Serializable summary.  With ``state=True`` (default) the dict
        also carries the raw P² marker state under ``"p2"``, so
        :meth:`from_snapshot` reconstructs an estimator that continues
        bit-identically — the one representation SLO burn windows,
        flight dumps, ``BENCH_*.json`` artifacts and ``check_perf.py``
        baselines share.  ``state=False`` gives the lean summary the
        registry embeds in bench artifacts."""
        out: Dict[str, object] = {
            "count": self.count, "sum": self.sum,
            "mean": self.mean, "min": self.min, "max": self.max}
        for q, est in sorted(self._est.items()):
            out[f"p{q * 100:g}"] = est.estimate()
        if state:
            out["name"] = self.name
            out["p2"] = [est.state() for _, est in sorted(self._est.items())]
        return out

    @classmethod
    def from_snapshot(cls, snap: Dict[str, object]) -> "Histogram":
        """Rebuild a histogram from a stateful :meth:`snapshot` dict.
        The restored estimator's quantile reads — and all subsequent
        ``observe`` arithmetic — are bit-identical to the original's."""
        p2 = snap.get("p2")
        if p2 is None:
            raise ValueError("snapshot carries no P² state "
                             "(was it taken with state=False?)")
        h = cls(str(snap.get("name", "restored")),
                quantiles=tuple(float(d["q"]) for d in p2))
        h.count = int(snap["count"])
        h.sum = float(snap["sum"])
        h.min = snap["min"]
        h.max = snap["max"]
        h._est = {float(d["q"]): _P2.from_state(d) for d in p2}
        return h


_Metric = Union[Counter, Gauge, EwmaGauge, Histogram]


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Names are dotted strings (``engine.steps``,
    ``engine.step_time_s.ewma``); re-requesting a name returns the same
    object, and requesting it as a *different* kind raises — a metric
    name means one thing."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, name: str, kind, factory) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            m = factory()
            self._metrics[name] = m
        elif not isinstance(m, kind):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name))

    def ewma(self, name: str, alpha: float = 0.2) -> EwmaGauge:
        return self._get(name, EwmaGauge, lambda: EwmaGauge(name, alpha))

    def histogram(self, name: str,
                  quantiles: Tuple[float, ...] = Histogram.DEFAULT_QUANTILES
                  ) -> Histogram:
        return self._get(name, Histogram, lambda: Histogram(name, quantiles))

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        """Flat name → value view (histograms expand to their summary
        dict, sans marker state) — what benchmarks serialize next to
        their own numbers."""
        out: Dict[str, object] = {}
        for name, m in sorted(self._metrics.items()):
            out[name] = (m.snapshot(state=False) if isinstance(m, Histogram)
                         else m.value)
        return out
