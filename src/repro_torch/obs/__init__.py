"""Fleet-wide observability: tracing spans + metrics, one timeline.

The paper's adaptation loop is only auditable if every layer leaves a
record on a shared timebase.  This package provides:

* :mod:`~repro_torch.obs.recorder` — structured begin/end/instant events with
  **dual timestamps** (wall ``perf_counter`` + the fleet's simulated
  clock), a :class:`TraceRecorder` that collects them, and the no-op
  :data:`NULL_RECORDER` default that keeps disabled hot paths at one
  attribute load per tick;
* :mod:`~repro_torch.obs.metrics` — a :class:`MetricsRegistry` of counters,
  gauges, EWMA gauges and P² streaming-quantile histograms that backs
  the legacy public stat surfaces (``ServeStats``,
  ``step_time_ewma_s``, the fleet's wake/violation tallies) as views;
* :mod:`~repro_torch.obs.export` — Chrome-trace/Perfetto ``trace.json``
  export (pid=device, tid=slot/subsystem, ts on one chosen clock);
* :mod:`~repro_torch.obs.query` — span pairing and request-metric helpers
  (span-derived TTFT/TPOT, per-rid token accounting), with lenient
  pairing (:func:`pair_spans`) for truncated traces;
* :mod:`~repro_torch.obs.analysis` — per-request critical-path latency
  attribution (components sum bit-equal to end-to-end latency) and the
  :func:`attribute_fleet` tail-latency rollup;
* :mod:`~repro_torch.obs.slo` — :class:`SLOClass` targets scored as rolling
  burn-rate windows; the :class:`SLOTracker` pressure signal is what
  the fleet controller feeds back into the adaptation loop;
* :mod:`~repro_torch.obs.flight` — :class:`FlightRecorder`, a bounded ring
  that dumps the seconds around anomalies as validated trace files.

Span taxonomy and metric names are documented in
``docs/OBSERVABILITY.md``; ``tools/check_trace.py`` validates exported
traces in CI, and ``tools/check_perf.py`` gates committed
``BENCH_*.json`` artifacts against tolerance baselines.
"""
from .analysis import (COMPONENT_LAYER, COMPONENTS, DeviceAttribution,
                       FleetAttribution, RequestAttribution,
                       attribute_fleet, attribute_requests)
from .export import chrome_trace, write_trace
from .flight import DEFAULT_TRIGGERS, FlightRecorder
from .metrics import (Counter, EwmaGauge, Gauge, Histogram,
                      MetricsRegistry)
from .query import (PairingReport, Span, events, instants, pair_spans,
                    request_token_counts, request_tpot_s, request_ttft_s,
                    spans)
from .recorder import (BEGIN, COUNTER, END, INSTANT, LAYERS,
                       NULL_RECORDER, Event, NullRecorder, TraceRecorder)
from .slo import SLOClass, SLOTracker

__all__ = ["chrome_trace", "write_trace",
           "Counter", "EwmaGauge", "Gauge", "Histogram", "MetricsRegistry",
           "PairingReport", "Span", "events", "instants", "pair_spans",
           "request_token_counts", "request_tpot_s", "request_ttft_s",
           "spans",
           "COMPONENT_LAYER", "COMPONENTS", "DeviceAttribution",
           "FleetAttribution", "RequestAttribution", "attribute_fleet",
           "attribute_requests",
           "SLOClass", "SLOTracker",
           "DEFAULT_TRIGGERS", "FlightRecorder",
           "BEGIN", "COUNTER", "END", "INSTANT", "LAYERS",
           "NULL_RECORDER", "Event", "NullRecorder", "TraceRecorder"]
