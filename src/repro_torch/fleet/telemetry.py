"""Crowd telemetry: measurement records + prediction calibration.

This is the feedback path the paper names as the key open challenge —
"feeding back runtime performance from the back-end level to the
front-end level optimization decision".  Devices report (predicted,
observed) latency/energy pairs per adaptation tick; the store fits an
affine correction per hardware tier (EWMA ratio while samples are
scarce, windowed least squares once enough accumulate) and hands back
:class:`repro_torch.core.profiler.Calibration` objects the optimizer's
``ActionEvaluator`` applies to every subsequent estimate.

Tier-level pooling is the crowd-knowledge transfer: a freshly joined
pixel_6 benefits immediately from measurements contributed by every
other light-tier phone, before it has produced a single sample itself.

Pooling is split by **measurement channel**: engine-backed devices
report real decode-step wall-times, simulated devices report analytic
latencies scaled by latent silicon bias — two scales that share no
affine relationship.  Calibrator populations are keyed on
``(tier, channel)`` (and ``(device, channel)``), so a fleet mixing both
kinds never cross-contaminates its fits.

A third channel carries **crowd-labeled task accuracy**: devices report
:class:`AccuracyRecord`\\ s per elastic variant, the store pools a
drift-corrected per-``(tier, variant)`` estimate
(:meth:`TelemetryStore.measured_accuracy_for_tier`), and the fleet
controller feeds it back into every same-tier
``ActionEvaluator.measured`` — closing the accuracy loop the same way
the latency/energy loop closes.

Arrival-order independence: under the event-driven fleet scheduler,
devices tick at independent rates and their reports reach the store out
of order (reporting latency jitters per device).  Every record carries a
``timestamp_s``; calibrators keep their samples in a container sorted by
``(timestamp, device, tick)`` and compute every fit from that sorted
view, so any permutation of the same record set yields bit-identical
:class:`Calibration` objects.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np

from repro_torch.core.optimizer import DRIFT_ACCURACY_COST
from repro_torch.core.profiler import Calibration
from repro_torch.obs import NULL_RECORDER

# measurement channels: what produced the observation
SIMULATED = "simulated"     # latent-bias silicon simulation (analytic scale)
ENGINE = "engine"           # real ServingEngine step wall-times
ACCURACY = "accuracy"       # crowd-labeled task accuracy per variant
CHANNELS = (SIMULATED, ENGINE, ACCURACY)


@dataclass(frozen=True)
class MeasurementRecord:
    """One back-end observation of one adaptation-loop decision.

    ``predicted_*`` fields are the *raw* (uncalibrated) analytic
    estimates the profiler produced for the decision; ``observed_*`` are
    what execution actually cost on the ``channel`` that measured it
    (``"simulated"`` latent-bias silicon or ``"engine"`` wall-clock).
    ``tick`` counts the reporting device's own adaptation wakes;
    ``timestamp_s`` is the simulated fleet-clock instant the observation
    was taken — the sort key that makes calibrator fits independent of
    the order records reach the store."""
    device_id: str
    tier: str
    tick: int
    predicted_latency_s: float       # raw analytic estimate (uncalibrated)
    observed_latency_s: float
    predicted_energy_j: float
    observed_energy_j: float
    tokens: int = 0
    channel: str = SIMULATED
    timestamp_s: float = 0.0


@dataclass(frozen=True)
class AccuracyRecord:
    """One crowd-labeled task-accuracy observation.

    ``variant`` identifies the elastic variant the accuracy was measured
    for (any hashable key — in practice a ``VariantSpec``);
    ``predicted_accuracy`` is what the optimizer believed when it chose
    the action, ``observed_accuracy`` what crowd labeling actually
    measured under ``drift`` units of distribution shift.  Records merge
    by ``timestamp_s`` exactly like latency records, so the accuracy
    channel is arrival-order independent too."""
    device_id: str
    tier: str
    tick: int
    variant: Hashable
    predicted_accuracy: float
    observed_accuracy: float
    drift: float = 0.0
    timestamp_s: float = 0.0


# one calibrator sample: (sort_key, pred_lat, obs_lat, pred_en, obs_en)
_Entry = Tuple[tuple, float, float, float, float]


class EwmaLsqCalibrator:
    """Affine latency correction + ratio energy correction.

    Cold start: an EWMA of the observed/predicted ratio (bias-only, robust
    from the very first sample).  Warm: least-squares fit of
    ``observed ≈ a·predicted + b`` over a sliding window, which also
    captures fixed per-step overheads (dispatch, cache swaps) that a pure
    ratio cannot.

    Samples are merged in **timestamp order**, not arrival order: each
    ``observe`` carries a sort key (timestamp plus a deterministic
    tie-break) and is inserted into a sorted container; ``calibration()``
    walks that container, so shuffling the arrival order of one record
    set cannot change the fit.  Direct ``observe`` calls without an
    explicit timestamp fall back to an arrival counter (the legacy
    in-order behavior); records fed through :class:`TelemetryStore`
    always carry their ``timestamp_s`` — unstamped legacy records share
    a 0.0 timestamp and are ordered by the ``(device_id, tick)``
    tie-break rather than by arrival."""

    def __init__(self, window: int = 64, alpha: float = 0.3,
                 min_lsq_samples: int = 8):
        self.window = window
        self.alpha = alpha
        self.min_lsq_samples = min_lsq_samples
        # sorted by sort_key; pruned to the newest _keep entries by time
        self._entries: List[_Entry] = []
        self._keep = 4 * window
        self._arrivals = 0
        self._n = 0
        self._cached: Optional[Calibration] = None

    def observe(self, pred_lat: float, obs_lat: float,
                pred_en: float, obs_en: float, *,
                timestamp_s: Optional[float] = None,
                key: tuple = ()) -> None:
        """Merge one (predicted, observed) pair.  ``timestamp_s`` orders
        the sample on the fleet clock (``None`` → arrival order);
        ``key`` deterministically breaks timestamp ties (the store passes
        ``(device_id, tick)``)."""
        self._arrivals += 1
        if pred_lat <= 0 or obs_lat <= 0:
            return
        sort_key = ((timestamp_s,) + key if timestamp_s is not None
                    else (float(self._arrivals),))
        bisect.insort(self._entries,
                      (sort_key, pred_lat, obs_lat, pred_en, obs_en))
        if len(self._entries) > self._keep:
            # drop the oldest-by-timestamp — the kept set is always "the
            # newest _keep samples", whatever order they arrived in
            del self._entries[0]
        self._n += 1
        self._cached = None

    @property
    def samples(self) -> int:
        return self._n

    def calibration(self) -> Calibration:
        """The current fit, computed from the time-sorted sample view
        (cached until the next ``observe``)."""
        if self._cached is not None:
            return self._cached
        ratio_lat: Optional[float] = None
        ratio_en: Optional[float] = None
        a = self.alpha
        for _, pl, ol, pe, oe in self._entries:
            r = ol / pl
            ratio_lat = r if ratio_lat is None \
                else (1 - a) * ratio_lat + a * r
            if pe > 0 and oe > 0:
                re_ = oe / pe
                ratio_en = re_ if ratio_en is None \
                    else (1 - a) * ratio_en + a * re_
        scale = ratio_lat if ratio_lat is not None else 1.0
        bias = 0.0
        win = self._entries[-self.window:]
        if len(win) >= self.min_lsq_samples:
            p = np.array([e[1] for e in win])
            o = np.array([e[2] for e in win])
            # degenerate spread (all predictions identical) → ratio only
            if float(p.std()) > 1e-9 * max(float(p.mean()), 1e-30):
                A = np.stack([p, np.ones_like(p)], axis=1)
                (sl, b), *_ = np.linalg.lstsq(A, o, rcond=None)
                # accept the affine fit only if it actually beats the
                # ratio on the window — outliers (compile spikes, load
                # bursts) can drive LSQ to wild slopes/negative intercepts
                if sl > 0:
                    lsq_err = np.mean(np.abs(np.maximum(sl * p + b, 1e-12)
                                             - o) / o)
                    ratio_err = np.mean(np.abs(scale * p - o) / o)
                    if lsq_err < ratio_err:
                        scale, bias = float(sl), float(b)
        self._cached = Calibration(
            latency_scale=scale, latency_bias_s=bias,
            energy_scale=ratio_en if ratio_en is not None else 1.0,
            samples=self._n)
        return self._cached


class TelemetryStore:
    """Fleet-wide record store with per-(tier, channel) crowd-shared and
    per-(device, channel) calibrators.

    ``record`` routes each :class:`MeasurementRecord` into both its
    tier's pooled calibrator and its device's private one, keyed on the
    record's measurement channel; lookups return fitted
    :class:`Calibration` objects (identity until a key has samples).
    Because calibrators merge by record timestamp, the store accepts
    out-of-order arrival — late reports from slow fleet members slot
    into their proper place in every fit."""

    def __init__(self, window: int = 64, alpha: float = 0.3,
                 min_lsq_samples: int = 8):
        self._kw = dict(window=window, alpha=alpha,
                        min_lsq_samples=min_lsq_samples)
        self._alpha = alpha
        # observability: the fleet controller points this at its
        # TraceRecorder so every merge lands as a telemetry.merge
        # instant (flagging reports that arrived out of timestamp order)
        self.recorder = NULL_RECORDER
        self.obs_pid = "fleet"
        self._max_ts_seen = float("-inf")
        self.records: List[MeasurementRecord] = []
        self.accuracy_records: List[AccuracyRecord] = []
        self._by_tier: Dict[Tuple[str, str], EwmaLsqCalibrator] = {}
        self._by_device: Dict[Tuple[str, str], EwmaLsqCalibrator] = {}
        # (tier, variant) -> timestamp-sorted (sort_key, drift-free obs),
        # trimmed to the newest _acc_keep like the latency calibrators,
        # with the EWMA memoized until the next insert
        self._acc: Dict[Tuple[str, Hashable], List[Tuple[tuple, float]]] = {}
        self._acc_keep = 4 * window
        self._acc_cached: Dict[Tuple[str, Hashable], Optional[float]] = {}

    # ------------------------------------------------------------ intake --
    def record(self, rec: MeasurementRecord) -> None:
        """Ingest one observation (any arrival order): append to the
        audit log and merge into the ``(tier, channel)`` and
        ``(device, channel)`` calibrators at its timestamp."""
        if self.recorder.enabled:
            self.recorder.instant(
                "telemetry.merge", pid=self.obs_pid, tid="telemetry",
                cat="fleet",
                args={"device": rec.device_id, "tier": rec.tier,
                      "tick": rec.tick, "channel": rec.channel,
                      "observed_ts_s": rec.timestamp_s,
                      "out_of_order": rec.timestamp_s < self._max_ts_seen})
        if rec.timestamp_s > self._max_ts_seen:
            self._max_ts_seen = rec.timestamp_s
        self.records.append(rec)
        for key, table in (((rec.tier, rec.channel), self._by_tier),
                           ((rec.device_id, rec.channel), self._by_device)):
            if key not in table:
                table[key] = EwmaLsqCalibrator(**self._kw)
            table[key].observe(rec.predicted_latency_s,
                               rec.observed_latency_s,
                               rec.predicted_energy_j,
                               rec.observed_energy_j,
                               timestamp_s=rec.timestamp_s,
                               key=(rec.device_id, rec.tick))

    def record_accuracy(self, rec: AccuracyRecord) -> None:
        """Ingest one crowd-labeled accuracy observation.  The modeled
        drift penalty (``DRIFT_ACCURACY_COST × drift``) is backed OUT of
        the observation before pooling, so what accumulates per
        ``(tier, variant)`` is the drift-free measured accuracy — the
        quantity ``ActionEvaluator.measured`` expects (the evaluator
        re-applies the drift term for whatever context it scores)."""
        self.accuracy_records.append(rec)
        driftfree = rec.observed_accuracy \
            + DRIFT_ACCURACY_COST * rec.drift
        key = (rec.tier, rec.variant)
        sort_key = (rec.timestamp_s, rec.device_id, rec.tick)
        entries = self._acc.setdefault(key, [])
        bisect.insort(entries, (sort_key, driftfree))
        if len(entries) > self._acc_keep:
            del entries[0]          # drop the oldest-by-timestamp
        self._acc_cached[key] = None

    def measured_accuracy_for_tier(self, tier: str) -> Dict[Hashable,
                                                            float]:
        """Crowd-measured drift-free accuracy per variant for one tier —
        an EWMA over the timestamp-sorted samples (arrival-order
        independent, like the latency calibrators).  Feed the result
        into ``ActionEvaluator.measured``."""
        out: Dict[Hashable, float] = {}
        for key, entries in self._acc.items():
            t, variant = key
            if t != tier or not entries:
                continue
            est = self._acc_cached.get(key)
            if est is None:
                for _, v in entries:
                    est = v if est is None \
                        else (1 - self._alpha) * est + self._alpha * v
                self._acc_cached[key] = est
            out[variant] = est
        return out

    def accuracy_mae(self, tier: Optional[str] = None,
                     measured: Optional[Dict[Hashable, float]] = None
                     ) -> float:
        """Mean absolute error of accuracy predictions vs crowd labels.
        With ``measured``, each record's prediction is replaced by the
        crowd estimate for its variant (minus the modeled drift term at
        the record's own drift) — before/after under one record set
        isolates what the accuracy feedback loop bought."""
        errs = []
        for r in self.accuracy_records:
            if tier is not None and r.tier != tier:
                continue
            pred = r.predicted_accuracy
            if measured is not None and r.variant in measured:
                pred = max(0.0, measured[r.variant]
                           - DRIFT_ACCURACY_COST * r.drift)
            errs.append(abs(pred - r.observed_accuracy))
        return float(np.mean(errs)) if errs else float("nan")

    # ----------------------------------------------------------- lookup ---
    def calibration_for_tier(self, tier: str,
                             channel: str = SIMULATED) -> Calibration:
        """The crowd-shared fit for one ``(tier, channel)`` pool — what a
        fresh same-tier device should correct its estimates with."""
        c = self._by_tier.get((tier, channel))
        return c.calibration() if c else Calibration()

    def calibration_for_device(self, device_id: str,
                               channel: str = SIMULATED) -> Calibration:
        """One device's private fit on one channel (the non-crowd-shared
        regime, capturing its individual silicon)."""
        c = self._by_device.get((device_id, channel))
        return c.calibration() if c else Calibration()

    def device_channel(self, device_id: str) -> str:
        """The channel a device most recently reported on (a device is
        either engine-backed or simulated for its whole life, but the
        store shouldn't have to be told which)."""
        for r in reversed(self.records):
            if r.device_id == device_id:
                return r.channel
        return SIMULATED

    # ------------------------------------------------------------ errors --
    def mape(self, tier: Optional[str] = None,
             calibration: Optional[Calibration] = None,
             per_device_calibration: bool = False,
             per_tier_calibration: bool = False,
             since_tick: int = 0,
             channel: Optional[str] = None) -> float:
        """Mean absolute percentage error of latency predictions vs
        observations.  With ``calibration`` the stored *raw* predictions
        are corrected first — so before/after MAPE under the same record
        set isolates exactly what the feedback loop bought.  With
        ``per_tier_calibration`` each record uses its tier's pooled fit on
        its own channel (the crowd-shared regime); with
        ``per_device_calibration`` each record instead uses its own
        device's fitted correction on its own channel (the
        non-crowd-shared regime).  ``channel`` restricts the record set to
        one measurement channel."""
        errs = []
        for r in self.records:
            if tier is not None and r.tier != tier:
                continue
            if channel is not None and r.channel != channel:
                continue
            if r.tick < since_tick or r.observed_latency_s <= 0:
                continue
            pred = r.predicted_latency_s
            if per_device_calibration:
                pred = self.calibration_for_device(
                    r.device_id, r.channel).latency(pred)
            elif per_tier_calibration:
                pred = self.calibration_for_tier(
                    r.tier, r.channel).latency(pred)
            elif calibration is not None:
                pred = calibration.latency(pred)
            errs.append(abs(pred - r.observed_latency_s)
                        / r.observed_latency_s)
        return float(np.mean(errs)) if errs else float("nan")
