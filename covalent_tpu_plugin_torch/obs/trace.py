"""Span-based tracing for the dispatch control plane.

Own copy of ``covalent_tpu_plugin/obs/trace.py``.  A :class:`Span` carries trace/span/parent ids,
status and attributes, propagates through ``contextvars`` (so asyncio tasks
nest correctly without threading a handle through every call), and on close
fans out to both sinks:

* the structured event stream (``obs.events``) as a ``span`` event; the
  JSONL file doubles as a flat trace export with consistent ids;
* the metrics registry, as one observation in the
  ``covalent_tpu_span_duration_seconds{span="<name>"}`` histogram: the
  per-stage dispatch-overhead distribution.

Usage::

    with span("executor.task", operation_id=op) as root:
        with span("executor.upload"):
            ...
    root.stage_durations   # {"upload": 0.012}

Across a process boundary a span travels as :func:`context_of`'s carrier
(``trace_id``, ``span_id``): a serving request's carrier rides its
``serve_request`` command, and the worker's spans come back on the session's
side-band with those ids, re-emitted by :func:`record_span`.

Parent spans accumulate each direct child's duration under the child's
*leaf* name (the part after the last dot); the executor's timings summary
(total and overhead accounting) falls out of that.
"""

from __future__ import annotations

import contextvars
import os
import time
from typing import Any

from . import events as _events
from .metrics import REGISTRY

__all__ = ["Span", "span", "current_span", "SPAN_HISTOGRAM", "context_of", "record_span"]

#: Name of the histogram every finished span observes into.
SPAN_HISTOGRAM = "covalent_tpu_span_duration_seconds"

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "covalent_tpu_current_span", default=None
)


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def current_span() -> "Span | None":
    """The innermost open span in this task/thread context, if any."""
    return _current.get()


def context_of(span: "Span", **extra: Any) -> dict[str, Any]:
    """The wire form of a span's trace context: ``trace_id`` (the trace to
    join) and ``span_id`` (the parent of whatever the remote side records);
    ``extra`` rides along verbatim."""
    return {"trace_id": span.trace_id, "span_id": span.span_id, **extra}


class Span:
    """One timed operation with ids, status, and attributes.

    Use as a context manager (sync ``with`` works inside async code — no
    await happens at enter/exit).  Exceptions mark the span ``ERROR`` with
    the exception repr attached, then propagate.
    """

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "attributes",
        "status", "start_ts", "duration_s", "stage_durations",
        "_t0", "_token", "_parent", "_emit", "_activate",
    )

    def __init__(
        self,
        name: str,
        attributes: dict[str, Any] | None = None,
        emit: bool = True,
        parent: "Span | None" = None,
        activate: bool = True,
    ) -> None:
        """``parent`` overrides contextvar lookup; ``activate=False`` keeps
        the span out of the ambient context (a long-lived root that is never
        exited must not capture it)."""
        self.name = name
        self.attributes: dict[str, Any] = dict(attributes or {})
        self.status = "OK"
        self.parent_id: str | None = None
        self.trace_id: str | None = None
        self.span_id = _new_id(8)
        self.start_ts: float | None = None
        self.duration_s: float | None = None
        #: leaf-name -> accumulated seconds of *direct* child spans.
        self.stage_durations: dict[str, float] = {}
        self._t0: float | None = None
        self._token = None
        self._parent: Span | None = parent
        self._emit = emit
        self._activate = activate

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "Span":
        if self._parent is None:
            self._parent = _current.get()
        parent = self._parent
        if parent is not None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            self.trace_id = _new_id(16)
        self.start_ts = time.time()
        self._t0 = time.perf_counter()
        if self._activate:
            self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.record_error(exc)
        self.end()
        return False

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def record_error(self, error: BaseException | str) -> None:
        self.status = "ERROR"
        self.attributes["error"] = (
            error if isinstance(error, str) else repr(error)
        )

    @property
    def leaf_name(self) -> str:
        return self.name.rsplit(".", 1)[-1]

    def end(self) -> None:
        if self._t0 is None or self.duration_s is not None:
            return  # never entered, or already ended
        self.duration_s = time.perf_counter() - self._t0
        if self._token is not None:
            try:
                _current.reset(self._token)
            except ValueError:
                # Ended from a different context than it was entered in
                # (e.g. a callback); the var will fall out of scope anyway.
                pass
            self._token = None
        parent = self._parent
        if parent is not None:
            parent.stage_durations[self.leaf_name] = (
                parent.stage_durations.get(self.leaf_name, 0.0)
                + self.duration_s
            )
        REGISTRY.histogram(
            SPAN_HISTOGRAM,
            "Duration of instrumented control-plane spans",
            label_names=("span",),
        ).labels(span=self.name).observe(
            self.duration_s, trace_id=self.trace_id
        )
        if self._emit:
            _events.emit(
                "span",
                name=self.name,
                trace_id=self.trace_id,
                span_id=self.span_id,
                parent_id=self.parent_id,
                start_ts=round(self.start_ts, 6),
                duration_s=round(self.duration_s, 6),
                status=self.status,
                **({"attributes": self.attributes} if self.attributes else {}),
            )

    # -- stage accounting --------------------------------------------------

    def total(self) -> float:
        if self.duration_s is not None:
            return self.duration_s
        if self._t0 is None:
            return 0.0
        return time.perf_counter() - self._t0

    def overhead(self, exclude: tuple[str, ...] = ("execute",)) -> float:
        """Dispatch overhead = child stages minus the task's own runtime."""
        return sum(
            v for k, v in self.stage_durations.items() if k not in exclude
        )

    def summary(self) -> dict[str, float]:
        out = dict(self.stage_durations)
        out["total"] = self.total()
        out["overhead"] = self.overhead()
        return out


def record_span(
    name: str,
    *,
    trace_id: str | None = None,
    parent_id: str | None = None,
    span_id: str | None = None,
    start_ts: float | None = None,
    duration_s: float,
    status: str = "OK",
    attributes: dict[str, Any] | None = None,
) -> str:
    """Emit one span retrospectively from explicit timings.

    For work timed elsewhere: the executor's ``execute`` span comes back
    from the worker as the harness's own start and end times.  Fans out
    exactly like :meth:`Span.end` (one histogram observation, exemplar-linked
    to the trace, plus one ``span`` event) and returns the span id so callers
    can parent further segments under it.
    """
    if span_id is None:
        span_id = _new_id(8)
    if trace_id is None:
        trace_id = _new_id(16)
    duration_s = max(0.0, float(duration_s))
    REGISTRY.histogram(
        SPAN_HISTOGRAM,
        "Duration of instrumented control-plane spans",
        label_names=("span",),
    ).labels(span=name).observe(duration_s, trace_id=trace_id)
    _events.emit(
        "span",
        name=name,
        trace_id=trace_id,
        span_id=span_id,
        parent_id=parent_id,
        start_ts=round(start_ts if start_ts is not None else time.time(), 6),
        duration_s=round(duration_s, 6),
        status=status,
        **({"attributes": dict(attributes)} if attributes else {}),
    )
    return span_id


def span(name: str, **attributes: Any) -> Span:
    """Open a new span as a context manager: ``with span("x", k=v): ...``."""
    return Span(name, attributes)
