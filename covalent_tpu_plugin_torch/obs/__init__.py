"""Observability of the port: metrics registry, lifecycle spans, event stream.

Own copy of the part of ``covalent_tpu_plugin/obs`` that the executor's
stage timings and the workflow runner rest on:

* :mod:`.metrics`: process-wide counters, gauges and histograms with a JSON
  snapshot and Prometheus text exposition (``REGISTRY``);
* :mod:`.trace`: ``Span`` context managers with trace/span/parent ids that
  instrument the executor's lifecycle stages and the workflow's nodes;
* :mod:`.events`: a structured JSONL event stream
  (``COVALENT_TPU_EVENTS_PATH``, size-bounded by
  ``COVALENT_TPU_EVENTS_MAX_BYTES`` / ``COVALENT_TPU_EVENTS_BACKUPS``).

The ops endpoint, heartbeats, the flight recorder, metrics history, SLOs
and the trace store come with slice 5.
"""

from .events import EventSink, configure as configure_events, emit as emit_event
from .events import get_sink
from .metrics import (
    DEFAULT_LATENCY_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
)
from .trace import SPAN_HISTOGRAM, Span, current_span, record_span, span

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS",
    "Span",
    "span",
    "current_span",
    "record_span",
    "SPAN_HISTOGRAM",
    "EventSink",
    "get_sink",
    "configure_events",
    "emit_event",
]
