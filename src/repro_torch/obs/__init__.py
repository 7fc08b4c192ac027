"""Observability for the port: metrics registry and trace recorder."""
from .metrics import Counter, EwmaGauge, Gauge, Histogram, MetricsRegistry
from .recorder import (BEGIN, COUNTER, END, INSTANT, LAYERS, NULL_RECORDER,
                       Event, NullRecorder, TraceRecorder)

__all__ = ["Counter", "EwmaGauge", "Gauge", "Histogram", "MetricsRegistry",
           "BEGIN", "COUNTER", "END", "INSTANT", "LAYERS", "NULL_RECORDER",
           "Event", "NullRecorder", "TraceRecorder"]
