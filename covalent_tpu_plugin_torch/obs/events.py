"""Structured event stream: one JSON object per line, append-only.

Own copy of ``covalent_tpu_plugin/obs/events.py``.  Every lifecycle edge
gets a durable line: task-state transitions, workflow node states and
completed spans all land in one JSONL file that operators can grep or feed
to any log pipeline.

Configuration is one environment variable::

    COVALENT_TPU_EVENTS_PATH=/path/to/events.jsonl

Unset (the default) the stream is disabled and ``emit`` is a cheap no-op
(one attribute check), so instrumented hot paths cost nothing in runs that
ask for no events.  ``configure(path)`` overrides the environment for the
current process (tests, embedding apps); in-process listeners see every
event either way.

The stream is size-bounded: once the file exceeds
``COVALENT_TPU_EVENTS_MAX_BYTES`` (default 64 MiB) it rotates shift-style
(``events.jsonl`` -> ``events.jsonl.1`` -> ``.2`` ...), keeping
``COVALENT_TPU_EVENTS_BACKUPS`` rotated files (default 2).  Setting the
byte bound to 0 disables rotation.

Every event carries ``ts`` (unix seconds), ``pid`` and ``type``; span
events also carry trace/span/parent ids, so the JSONL doubles as a flat
trace export.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable

__all__ = ["EventSink", "get_sink", "configure", "reset", "emit", "add_listener",
           "remove_listener"]

_ENV_VAR = "COVALENT_TPU_EVENTS_PATH"
_MAX_BYTES_ENV = "COVALENT_TPU_EVENTS_MAX_BYTES"
_BACKUPS_ENV = "COVALENT_TPU_EVENTS_BACKUPS"
_DEFAULT_MAX_BYTES = 64 * 1024 * 1024
_DEFAULT_BACKUPS = 2


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


#: ``task.state`` values that are progress edges, not terminal outcomes.
#: Any other state (completed/failed/cancelled/...) is a terminal record an
#: operator must find on disk after any crash: flushed to the OS *and*
#: fsynced inline.  Everything else stays flush-only (a killed process loses
#: nothing, the page cache survives it), since a per-event fsync on the hot
#: path would throttle dispatch.
_PROGRESS_STATES = frozenset(("starting", "submitted", "running", "polling"))


def _durable_event(type: str, fields: dict) -> bool:
    return type == "task.state" and (
        str(fields.get("state") or "") not in _PROGRESS_STATES
    )


class EventSink:
    """Thread-safe JSONL appender bound to one path (or disabled)."""

    def __init__(
        self,
        path: str | None,
        max_bytes: int | None = None,
        backups: int | None = None,
    ) -> None:
        self.path = path or None
        #: rotate once the file exceeds this many bytes (0 = never).
        self.max_bytes = (
            _env_int(_MAX_BYTES_ENV, _DEFAULT_MAX_BYTES)
            if max_bytes is None
            else int(max_bytes)
        )
        #: rotated generations kept (``path.1`` .. ``path.N``).
        self.backups = max(
            0,
            _env_int(_BACKUPS_ENV, _DEFAULT_BACKUPS)
            if backups is None
            else int(backups),
        )
        self._lock = threading.Lock()
        self._fh = None
        self._failed = False

    @property
    def enabled(self) -> bool:
        return self.path is not None and not self._failed

    def emit(self, type: str, **fields: Any) -> dict | None:
        """Append one event; returns the event dict, or None when disabled.

        Never raises: an unwritable path disables the sink after one
        warning rather than failing the dispatch it was observing.
        """
        if not self.enabled and not _listeners:
            return None  # disabled and unobserved: build nothing
        event = {"ts": round(time.time(), 6), "pid": os.getpid(),
                 "type": type, **fields}
        for listener in list(_listeners):
            try:
                listener(event)
            except Exception:  # noqa: BLE001 - observers must not break flow
                pass
        if not self.enabled:
            return event if _listeners else None
        try:
            line = json.dumps(event, default=repr) + "\n"
        except (TypeError, ValueError):
            line = json.dumps({"ts": event["ts"], "pid": event["pid"],
                               "type": type, "repr": repr(fields)}) + "\n"
        with self._lock:
            try:
                if self._fh is None:
                    parent = os.path.dirname(self.path)
                    if parent:
                        os.makedirs(parent, exist_ok=True)
                    self._fh = open(self.path, "a", encoding="utf-8")
                self._fh.write(line)
                self._fh.flush()
                if _durable_event(type, fields):
                    os.fsync(self._fh.fileno())
                if self.max_bytes > 0 and self._fh.tell() >= self.max_bytes:
                    self._rotate_locked()
            except OSError as err:
                self._failed = True
                from ..utils.log import app_log

                app_log.warning(
                    "event sink %s unwritable (%s); events disabled", self.path, err
                )
                return None
        return event

    def _rotate_locked(self) -> None:
        """Shift-rotate ``path`` -> ``path.1`` -> ... (caller holds _lock).

        With ``backups == 0`` the file is simply truncated: bounded either
        way.  A rotation failure is swallowed — the stream keeps appending
        to the (oversized) live file rather than dying mid-dispatch.
        """
        self._fh.close()
        self._fh = None
        try:
            for i in range(self.backups - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            if self.backups > 0:
                os.replace(self.path, f"{self.path}.1")
            else:
                os.truncate(self.path, 0)
        except OSError:
            pass
        self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


_sink_lock = threading.Lock()
_sink: EventSink | None = None
#: In-process observers (tests, bench live tailers): called with every
#: event dict even when no JSONL path is configured.
_listeners: list[Callable[[dict], None]] = []


def get_sink() -> EventSink:
    """The process-wide sink, built lazily from the environment."""
    global _sink
    sink = _sink
    if sink is not None:
        return sink
    with _sink_lock:
        if _sink is None:
            _sink = EventSink(os.environ.get(_ENV_VAR) or None)
        return _sink


def configure(path: str | None) -> EventSink:
    """Re-point the process-wide sink (None disables).  Returns the sink."""
    global _sink
    with _sink_lock:
        if _sink is not None:
            _sink.close()
        _sink = EventSink(path)
        return _sink


def reset() -> EventSink:
    """Rebuild the sink from the environment, undoing any configure().

    Callers that temporarily re-point the stream (tests, embedders) use
    this on teardown so a process-wide ``COVALENT_TPU_EVENTS_PATH`` —
    e.g. CI's telemetry artifact — resumes collecting afterwards.
    """
    global _sink
    with _sink_lock:
        if _sink is not None:
            _sink.close()
        _sink = None
    return get_sink()


def emit(type: str, **fields: Any) -> dict | None:
    """Module-level shorthand: ``events.emit("task.state", op=..., to=...)``.

    The disabled-and-unobserved case is the production default, so it
    short-circuits on one cached-global read — no lock, no dict build.
    """
    sink = _sink
    if sink is None:
        sink = get_sink()
    if not sink.enabled and not _listeners:
        return None
    return sink.emit(type, **fields)


def add_listener(listener: Callable[[dict], None]) -> None:
    _listeners.append(listener)


def remove_listener(listener: Callable[[dict], None]) -> None:
    try:
        _listeners.remove(listener)
    except ValueError:
        pass
