"""Process-wide metrics registry: counters, gauges, histograms.

Own copy of ``covalent_tpu_plugin/obs/metrics.py``: every instrumented
component (executor lifecycle, workflow runner) records into one
process-wide registry that reads back as a JSON snapshot
(``Registry.snapshot``) or Prometheus text exposition
(``Registry.prometheus_text``) at any point; no third-party dependency,
safe under threads and asyncio tasks alike.  The metric names are the
reference's (``covalent_tpu_*``), so one dashboard reads either package.

Naming follows Prometheus conventions (``*_total`` counters, ``*_seconds``
histograms); labels use the usual ``metric.labels(k=v)`` child pattern, so
per-stage/per-outcome series stay cheap to record on the hot path (one dict
lookup and one float add under a lock).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS",
]

#: Fixed histogram buckets for control-plane latencies (seconds): from
#: sub-millisecond local round trips up to the minutes a cold worker start
#: can take.  Fixed (not configurable per call site) so every stage
#: histogram is directly comparable.
DEFAULT_LATENCY_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


def _fmt_label_value(value: Any) -> str:
    text = str(value)
    return text.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_float(value: float) -> str:
    """Prometheus-style float: integers render bare, +Inf stays +Inf."""
    if value == float("inf"):
        return "+Inf"
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


class _Metric:
    """Shared parent/child plumbing for labelled metrics.

    A metric with ``label_names`` is a *family*: callers obtain per-series
    children via :meth:`labels` and record on those.  A metric without
    labels records directly on itself (its sole child is keyed by ``()``).
    """

    kind = "untyped"

    def __init__(
        self,
        name: str,
        help: str = "",
        label_names: Iterable[str] = (),
        registry: "Registry | None" = None,
    ) -> None:
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._children: dict[tuple[str, ...], Any] = {}
        self._lock = threading.Lock()
        if registry is not None:
            registry.register(self)

    def labels(self, **labels: Any):
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        key = tuple(_fmt_label_value(labels[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
            return child

    def _default_child(self):
        if self.label_names:
            raise ValueError(
                f"{self.name} has labels {self.label_names}; use .labels(...)"
            )
        with self._lock:
            child = self._children.get(())
            if child is None:
                child = self._new_child()
                self._children[()] = child
            return child

    def _new_child(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def remove(self, **labels: Any) -> None:
        """Drop one labeled series (no-op when absent).

        Series whose label values are user-derived and unbounded — e.g.
        the per-tenant queue depth gauge — must be removed when their
        owner retires, or the registry (and every /metrics scrape) grows
        monotonically for the process lifetime.
        """
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        key = tuple(_fmt_label_value(labels[n]) for n in self.label_names)
        with self._lock:
            self._children.pop(key, None)

    def _series(self) -> list[tuple[dict[str, str], Any]]:
        with self._lock:
            return [
                (dict(zip(self.label_names, key)), child)
                for key, child in sorted(self._children.items())
            ]


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Counter(_Metric):
    """Monotonically increasing count (``*_total``)."""

    kind = "counter"

    def _new_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _GaugeChild:
    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Metric):
    """Point-in-time value that can go up and down."""

    kind = "gauge"

    def _new_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _HistogramChild:
    __slots__ = ("buckets", "counts", "sum", "count", "exemplars", "_lock")

    def __init__(self, buckets: tuple[float, ...]) -> None:
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1 for the +Inf bucket
        self.sum = 0.0
        self.count = 0
        #: bucket index -> (value, trace_id, unix ts) of the most recent
        #: exemplar-carrying observation that landed in that bucket.  One
        #: slot per bucket keeps the memory bound independent of traffic.
        self.exemplars: dict[int, tuple[float, str, float]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, trace_id: str | None = None) -> None:
        value = float(value)
        with self._lock:
            self.sum += value
            self.count += 1
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self.counts[i] += 1
                    break
            else:
                i = len(self.buckets)
                self.counts[-1] += 1
            if trace_id:
                self.exemplars[i] = (value, str(trace_id), time.time())

    def exemplar_snapshot(self) -> dict[int, tuple[float, str, float]]:
        with self._lock:
            return dict(self.exemplars)

    def cumulative(self) -> list[int]:
        """Per-bucket cumulative counts, Prometheus ``le`` semantics."""
        out, running = [], 0
        with self._lock:
            for c in self.counts:
                running += c
                out.append(running)
        return out

    def quantile(self, q: float) -> float | None:
        """Approximate quantile from bucket bounds (upper-bound estimate)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        with self._lock:
            total = self.count
            if total == 0:
                return None
            target = q * total
            running = 0
            for i, c in enumerate(self.counts[:-1]):
                running += c
                if running >= target:
                    return self.buckets[i]
            return self.buckets[-1] if self.buckets else None


class Histogram(_Metric):
    """Fixed-bucket distribution (``*_seconds`` latencies by default)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        label_names: Iterable[str] = (),
        buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
        registry: "Registry | None" = None,
    ) -> None:
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        super().__init__(name, help, label_names, registry)

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, value: float, trace_id: str | None = None) -> None:
        self._default_child().observe(value, trace_id=trace_id)

    def quantile(self, q: float) -> float | None:
        return self._default_child().quantile(q)

    @property
    def count(self) -> int:
        return self._default_child().count

    @property
    def sum(self) -> float:
        return self._default_child().sum


class Registry:
    """Keyed set of metrics with snapshot + Prometheus text exposition.

    ``counter``/``gauge``/``histogram`` are get-or-create: the same
    (name, labels) call from any component returns the same metric, so
    instrumentation sites never coordinate registration order.
    """

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _check_compatible(existing: _Metric, name, cls, label_names, kwargs) -> None:
        if type(existing) is not cls or tuple(label_names) != existing.label_names:
            raise ValueError(
                f"metric {name!r} already registered with a different "
                f"type or label set"
            )
        buckets = kwargs.get("buckets")
        if buckets is not None and tuple(
            sorted(float(b) for b in buckets)
        ) != getattr(existing, "buckets", None):
            # Silently returning the existing histogram would put this
            # caller's observations into bounds it never asked for.
            raise ValueError(
                f"histogram {name!r} already registered with different buckets"
            )

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                self._check_compatible(
                    existing, metric.name, type(metric), metric.label_names,
                    {"buckets": getattr(metric, "buckets", None)},
                )
                return existing
            self._metrics[metric.name] = metric
            return metric

    def _get_or_create(self, cls, name, help, label_names, **kwargs) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
        if existing is not None:
            self._check_compatible(existing, name, cls, label_names, kwargs)
            return existing
        return self.register(cls(name, help, label_names, **kwargs))

    def counter(self, name: str, help: str = "", label_names=()) -> Counter:
        return self._get_or_create(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "", label_names=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, label_names)

    def histogram(
        self, name: str, help: str = "", label_names=(),
        buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, label_names, buckets=buckets
        )

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self) -> None:
        """Drop every metric (tests; a fresh process state)."""
        with self._lock:
            self._metrics.clear()

    # -- exposition --------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """JSON-friendly dump of every series' current state."""
        out: dict[str, Any] = {"ts": time.time(), "metrics": {}}
        with self._lock:
            metrics = list(self._metrics.values())
        for metric in sorted(metrics, key=lambda m: m.name):
            series = []
            for labels, child in metric._series():
                entry: dict[str, Any] = {"labels": labels}
                if metric.kind == "histogram":
                    bounds = (*metric.buckets, float("inf"))
                    entry.update(
                        count=child.count,
                        sum=round(child.sum, 9),
                        buckets={
                            _fmt_float(b): c
                            for b, c in zip(bounds, child.cumulative())
                        },
                        p50=child.quantile(0.5),
                        p95=child.quantile(0.95),
                        p99=child.quantile(0.99),
                    )
                    exemplars = child.exemplar_snapshot()
                    if exemplars:
                        entry["exemplars"] = {
                            _fmt_float(bounds[i]): {
                                "value": round(value, 9),
                                "trace_id": trace_id,
                                "ts": round(ts, 6),
                            }
                            for i, (value, trace_id, ts)
                            in sorted(exemplars.items())
                        }
                else:
                    entry["value"] = child.value
                series.append(entry)
            out["metrics"][metric.name] = {
                "kind": metric.kind,
                "help": metric.help,
                "series": series,
            }
        return out

    def snapshot_json(self, indent: int | None = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def prometheus_text(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition format (version 0.0.4).

        With ``openmetrics=True`` the output follows the OpenMetrics text
        format instead: bucket lines carry ``# {trace_id="..."} value ts``
        exemplar suffixes (when an observation recorded one) and the body
        ends with the mandatory ``# EOF`` terminator, so a p99 bucket
        links straight to a reconstructable ``/traces/<id>`` waterfall.
        Exemplars are invalid in the classic 0.0.4 format, hence the
        explicit opt-in.
        """
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for metric in sorted(metrics, key=lambda m: m.name):
            if metric.help:
                lines.append(f"# HELP {metric.name} {metric.help}")
            lines.append(f"# TYPE {metric.name} {metric.kind}")
            for labels, child in metric._series():
                base = ",".join(f'{k}="{v}"' for k, v in labels.items())
                if metric.kind == "histogram":
                    bounds = (*metric.buckets, float("inf"))
                    exemplars = (
                        child.exemplar_snapshot() if openmetrics else {}
                    )
                    for i, (bound, cum) in enumerate(
                        zip(bounds, child.cumulative())
                    ):
                        le = f'le="{_fmt_float(bound)}"'
                        labelset = f"{base},{le}" if base else le
                        line = f"{metric.name}_bucket{{{labelset}}} {cum}"
                        ex = exemplars.get(i)
                        if ex is not None:
                            value, trace_id, ts = ex
                            line += (
                                f' # {{trace_id="{_fmt_label_value(trace_id)}"}}'
                                f" {_fmt_float(value)} {round(ts, 3)}"
                            )
                        lines.append(line)
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(
                        f"{metric.name}_sum{suffix} {_fmt_float(child.sum)}"
                    )
                    lines.append(f"{metric.name}_count{suffix} {child.count}")
                else:
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(
                        f"{metric.name}{suffix} {_fmt_float(child.value)}"
                    )
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + ("\n" if lines else "")


#: The process-wide default registry every instrumentation site records to.
REGISTRY = Registry()
