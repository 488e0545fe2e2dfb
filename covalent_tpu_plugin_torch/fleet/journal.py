"""Control-plane write-ahead journal: crash-safe intent log + replayable state.

The port's own copy of ``covalent_tpu_plugin/fleet/journal.py``, byte for
byte in what it writes: the same records give the same segment bytes, and
each package replays the other's log.  It is the durable backbone of the
*control* plane.  The dispatcher appends one
record per control-plane intent — electron placement and terminal
outcome, session open/close, per-stream token high-water marks, pool
registry and autoscaler targets, the dispatcher epoch itself — and a
restarted dispatcher replays the log into a :class:`JournalState` it can
re-adopt the still-warm fleet from (``fleet/recovery.py``).

Design points, in the order a crash meets them:

* **Framing** — each record is ``>I`` payload length + raw 32-byte
  sha256 of the payload + compact-JSON payload.  The digest makes a
  bit-flip detectable (the record is *skipped*, replay continues on the
  intact length prefix); the length prefix makes a torn tail detectable
  (replay *truncates* at the last whole record and the next append
  resumes there).  Replay NEVER raises on corrupt input — counters
  record what was dropped.
* **Fsync batching** — appends land in the OS page cache immediately
  (``flush``) and a background flusher fsyncs every
  ``COVALENT_TPU_JOURNAL_FSYNC_MS`` (default 20ms), so the hot path
  pays a buffered write, not a disk round-trip.  Records that gate
  correctness (epoch bumps, terminal outcomes) pass ``sync=True`` and
  take the fsync inline.
* **Rotation + compaction** — segments roll at
  ``COVALENT_TPU_JOURNAL_SEGMENT_BYTES``; rotation writes a
  ``snapshot.<seq>.json`` of the *replayed state so far* (its own
  sha256 embedded), and only after that snapshot is fsynced are the
  segments it covers deleted.  Replay = newest valid snapshot + the
  tail segments after it; a corrupt snapshot falls back to the previous
  one (or a full-log replay) rather than failing.
* **Epoch fencing** — :meth:`Journal.open` replays, bumps the
  dispatcher epoch, and appends the new epoch synchronously before
  returning.  Workers record the highest epoch they have seen and
  refuse mutating commands from lower ones — the split-brain guard of a
  restarted dispatcher.

The module-level singleton (:func:`configure` / :func:`record`) keeps
call sites one-liners that compile to a no-op when
``COVALENT_TPU_JOURNAL_DIR`` is unset — journaling is strictly opt-in.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import struct
import threading
import time
from typing import Any

from ..obs.metrics import REGISTRY
from ..utils.log import app_log

__all__ = [
    "Journal",
    "JournalState",
    "configure",
    "get_journal",
    "record",
    "reset",
]

_LEN = struct.Struct(">I")
_DIGEST_BYTES = 32
_HEADER_BYTES = _LEN.size + _DIGEST_BYTES
#: Hard per-record payload ceiling.  A torn/bit-flipped length prefix can
#: decode to anything up to 4GiB; bounding it keeps replay from trying to
#: slurp garbage lengths and misclassifying the whole tail as one record.
_MAX_RECORD_BYTES = 8 * 1024 * 1024

_SEGMENT_RE = re.compile(r"^journal\.(\d{8})\.wal$")
_SNAPSHOT_RE = re.compile(r"^snapshot\.(\d{8})\.json$")

JOURNAL_RECORDS_TOTAL = REGISTRY.counter(
    "covalent_tpu_journal_records_total",
    "Control-plane journal records appended, by record type",
    ("type",),
)

JOURNAL_BYTES_TOTAL = REGISTRY.counter(
    "covalent_tpu_journal_bytes_total",
    "Bytes appended to the control-plane journal (frames included)",
)

JOURNAL_FSYNCS_TOTAL = REGISTRY.counter(
    "covalent_tpu_journal_fsyncs_total",
    "fsync calls issued by the journal (batched flusher + sync appends)",
)

JOURNAL_REPLAY_TOTAL = REGISTRY.counter(
    "covalent_tpu_journal_replay_total",
    "Replay outcomes per record: applied, skipped_corrupt, truncated_tail",
    ("outcome",),
)

JOURNAL_SEGMENTS = REGISTRY.gauge(
    "covalent_tpu_journal_segments",
    "Live (uncompacted) journal segment files on disk",
)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or not str(raw).strip():
        return default
    try:
        return int(float(str(raw).strip()))
    except (TypeError, ValueError):
        return default


def _frame(payload: bytes) -> bytes:
    return _LEN.pack(len(payload)) + hashlib.sha256(payload).digest() + payload


class JournalState:
    """The replayed control-plane picture: what the dispatcher *intended*.

    A pure reducer over record dicts — no I/O — so the same class serves
    replay, snapshot compaction (a snapshot is just a serialized state),
    and the fuzz tests' equivalence checks.  Every map keys on the
    stable caller-facing id (pool name, handle ``sid``, operation id),
    never per-generation remote ids.
    """

    def __init__(self) -> None:
        self.epoch = 0
        #: pool name -> spec dict (registration intent)
        self.pools: dict[str, dict] = {}
        #: pool name -> autoscaler capacity target
        self.pool_targets: dict[str, int] = {}
        #: replica-set name -> {"replicas": target, "sids": {...}}
        self.replica_sets: dict[str, dict] = {}
        #: handle sid -> session record (address, sid_g, digest, options…)
        self.sessions: dict[str, dict] = {}
        #: (sid, rid) -> stream record with ``hwm`` token high-water mark
        self.streams: dict[tuple[str, str], dict] = {}
        #: operation id -> dispatch/placement record (lineage, spec path)
        self.tasks: dict[str, dict] = {}
        self.applied = 0

    # -- reducer ------------------------------------------------------------

    def apply(self, rec: dict) -> None:
        kind = rec.get("t")
        if kind == "epoch":
            self.epoch = max(self.epoch, int(rec.get("epoch") or 0))
        elif kind == "pool":
            name = str(rec.get("name") or "")
            if name:
                self.pools[name] = dict(rec.get("spec") or {})
        elif kind == "pool_target":
            name = str(rec.get("name") or "")
            if name:
                self.pool_targets[name] = int(rec.get("capacity") or 0)
        elif kind == "replica_set":
            name = str(rec.get("name") or "")
            if name:
                entry = self.replica_sets.setdefault(
                    name, {"replicas": 0, "sids": {}}
                )
                if "replicas" in rec:
                    entry["replicas"] = int(rec.get("replicas") or 0)
        elif kind == "replica":
            name = str(rec.get("set") or "")
            sid = str(rec.get("sid") or "")
            if name and sid:
                entry = self.replica_sets.setdefault(
                    name, {"replicas": 0, "sids": {}}
                )
                if rec.get("state") == "closed":
                    entry["sids"].pop(sid, None)
                else:
                    entry["sids"][sid] = int(rec.get("replica") or 0)
        elif kind == "session":
            sid = str(rec.get("sid") or "")
            if sid:
                entry = self.sessions.setdefault(sid, {})
                entry.update(
                    {k: v for k, v in rec.items() if k not in ("t",)}
                )
        elif kind == "session_adapter":
            sid = str(rec.get("sid") or "")
            name = str(rec.get("adapter") or "")
            if sid and name:
                entry = self.sessions.setdefault(sid, {})
                book = entry.setdefault("adapters", {})
                if rec.get("detached"):
                    book.pop(name, None)
                else:
                    book[name] = {
                        "digest": str(rec.get("digest") or ""),
                        "path": str(rec.get("path") or ""),
                        "content": str(rec.get("content") or ""),
                    }
        elif kind == "session_closed":
            sid = str(rec.get("sid") or "")
            self.sessions.pop(sid, None)
            for key in [k for k in self.streams if k[0] == sid]:
                self.streams.pop(key, None)
        elif kind == "stream":
            sid = str(rec.get("sid") or "")
            rid = str(rec.get("rid") or "")
            if sid and rid:
                entry = self.streams.setdefault((sid, rid), {"hwm": 0})
                entry.update(
                    {k: v for k, v in rec.items() if k not in ("t", "hwm")}
                )
        elif kind == "stream_hwm":
            key = (str(rec.get("sid") or ""), str(rec.get("rid") or ""))
            entry = self.streams.get(key)
            if entry is not None:
                entry["hwm"] = max(
                    int(entry.get("hwm") or 0), int(rec.get("hwm") or 0)
                )
        elif kind == "stream_done":
            self.streams.pop(
                (str(rec.get("sid") or ""), str(rec.get("rid") or "")), None
            )
        elif kind == "task":
            op = str(rec.get("op") or "")
            if op:
                entry = self.tasks.setdefault(op, {})
                entry.update(
                    {k: v for k, v in rec.items() if k not in ("t",)}
                )
        elif kind == "task_terminal":
            self.tasks.pop(str(rec.get("op") or ""), None)
        # Unknown kinds are forward-compat: applied counts them, state
        # ignores them, so an old dispatcher can replay a newer log.
        self.applied += 1

    # -- snapshot (de)serialization -----------------------------------------

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "pools": self.pools,
            "pool_targets": self.pool_targets,
            "replica_sets": self.replica_sets,
            "sessions": self.sessions,
            "streams": {
                f"{sid}\x00{rid}": entry
                for (sid, rid), entry in self.streams.items()
            },
            "tasks": self.tasks,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "JournalState":
        state = cls()
        state.epoch = int(data.get("epoch") or 0)
        state.pools = {str(k): dict(v) for k, v in (data.get("pools") or {}).items()}
        state.pool_targets = {
            str(k): int(v) for k, v in (data.get("pool_targets") or {}).items()
        }
        state.replica_sets = {
            str(k): dict(v) for k, v in (data.get("replica_sets") or {}).items()
        }
        state.sessions = {
            str(k): dict(v) for k, v in (data.get("sessions") or {}).items()
        }
        for key, entry in (data.get("streams") or {}).items():
            sid, _, rid = str(key).partition("\x00")
            state.streams[(sid, rid)] = dict(entry)
        state.tasks = {str(k): dict(v) for k, v in (data.get("tasks") or {}).items()}
        return state


class Journal:
    """One dispatcher's write-ahead journal over a directory of segments."""

    def __init__(
        self,
        directory: str,
        *,
        fsync_ms: int | None = None,
        max_segment_bytes: int | None = None,
    ) -> None:
        self.directory = directory
        self.fsync_ms = (
            fsync_ms
            if fsync_ms is not None
            else _env_int("COVALENT_TPU_JOURNAL_FSYNC_MS", 20)
        )
        self.max_segment_bytes = (
            max_segment_bytes
            if max_segment_bytes is not None
            else _env_int(
                "COVALENT_TPU_JOURNAL_SEGMENT_BYTES", 4 * 1024 * 1024
            )
        )
        self.state = JournalState()
        #: replayed prior-incarnation state snapshot (set by :meth:`open`).
        self.recovered: dict = {}
        self.replay_applied = 0
        self.replay_skipped = 0
        self.replay_truncated = 0
        self._lock = threading.Lock()
        self._fh = None
        self._seq = 0
        self._written = 0
        self._dirty = False
        self._closed = False
        self._flusher: threading.Thread | None = None
        self._flush_wake = threading.Event()

    # -- lifecycle ----------------------------------------------------------

    @classmethod
    def open(cls, directory: str, **kwargs: Any) -> "Journal":
        """Replay whatever the directory holds, bump the dispatcher
        epoch durably, and start appending.  The epoch record is the
        first write of the new incarnation and is fsynced before open
        returns — from this instant any surviving worker that hears the
        new epoch must refuse the old dispatcher."""
        journal = cls(directory, **kwargs)
        os.makedirs(directory, exist_ok=True)
        journal._replay()
        # The recovery path reads THIS — the prior incarnation's state as
        # replayed — not the live ``state``, which immediately starts
        # accumulating the new incarnation's records.
        journal.recovered = journal.state.to_dict()
        journal._open_segment(journal._seq + 1)
        journal.state.epoch += 1
        journal.append({"t": "epoch", "epoch": journal.state.epoch}, sync=True)
        journal._start_flusher()
        return journal

    @property
    def epoch(self) -> int:
        return self.state.epoch

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._sync_locked()
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
        self._flush_wake.set()
        if self._flusher is not None:
            self._flusher.join(timeout=1.0)

    # -- append path --------------------------------------------------------

    def append(self, rec: dict, *, sync: bool = False) -> None:
        """Write one record: framed, applied to the live state, and
        either batch-fsynced (default) or fsynced inline (``sync``)."""
        payload = json.dumps(
            rec, separators=(",", ":"), sort_keys=True, default=str
        ).encode("utf-8")
        frame = _frame(payload)
        with self._lock:
            if self._closed or self._fh is None:
                return
            if self._written and self._written + len(frame) > self.max_segment_bytes:
                self._rotate_locked()
            self._fh.write(frame)
            self._fh.flush()
            self._written += len(frame)
            self._dirty = True
            self.state.apply(rec)
            if sync:
                self._sync_locked()
        JOURNAL_RECORDS_TOTAL.labels(type=str(rec.get("t") or "?")).inc()
        JOURNAL_BYTES_TOTAL.inc(len(frame))

    def record(self, kind: str, *, sync: bool = False, **fields: Any) -> None:
        fields["t"] = kind
        self.append(fields, sync=sync)

    def sync(self) -> None:
        with self._lock:
            self._sync_locked()

    def _sync_locked(self) -> None:
        if self._fh is None or not self._dirty:
            return
        try:
            os.fsync(self._fh.fileno())
        except OSError:
            return
        self._dirty = False
        JOURNAL_FSYNCS_TOTAL.inc()

    def _start_flusher(self) -> None:
        if self.fsync_ms <= 0:
            # Every append becomes durable only at sync points/close;
            # callers opted out of the batched flusher explicitly.
            return

        def _run() -> None:
            interval = max(self.fsync_ms, 1) / 1000.0
            while not self._closed:
                self._flush_wake.wait(interval)
                self._flush_wake.clear()
                if self._closed:
                    return
                with self._lock:
                    self._sync_locked()

        self._flusher = threading.Thread(
            target=_run, name="tpu-journal-fsync", daemon=True
        )
        self._flusher.start()

    # -- rotation + compaction ----------------------------------------------

    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.directory, f"journal.{seq:08d}.wal")

    def _snapshot_path(self, seq: int) -> str:
        return os.path.join(self.directory, f"snapshot.{seq:08d}.json")

    def _open_segment(self, seq: int) -> None:
        self._seq = seq
        path = self._segment_path(seq)
        self._fh = open(path, "ab")
        self._written = self._fh.tell()
        JOURNAL_SEGMENTS.set(float(len(self._scan()[0])))

    def _rotate_locked(self) -> None:
        """Roll to a fresh segment, snapshot the state so far, and
        delete the segments that snapshot covers.  Ordering is the
        crash-safety contract: snapshot is fully fsynced (tmp + rename)
        BEFORE any segment is unlinked, so every instant in time has a
        complete replay path on disk."""
        closing_seq = self._seq
        self._sync_locked()
        try:
            self._fh.close()
        except OSError:
            pass
        self._open_segment(closing_seq + 1)
        try:
            self._write_snapshot_locked(closing_seq)
        except OSError as err:
            # Snapshot failure is not fatal: replay just walks more
            # segments.  Compaction is skipped so nothing is lost.
            app_log.warning("journal snapshot at seq %d failed: %s",
                            closing_seq, err)
            return
        for seg_seq, seg_path in self._scan()[0]:
            if seg_seq <= closing_seq:
                try:
                    os.unlink(seg_path)
                except OSError:
                    pass
        for snap_seq, snap_path in self._scan()[1]:
            if snap_seq < closing_seq:
                try:
                    os.unlink(snap_path)
                except OSError:
                    pass
        JOURNAL_SEGMENTS.set(float(len(self._scan()[0])))

    def _write_snapshot_locked(self, seq: int) -> None:
        body = json.dumps(
            self.state.to_dict(), separators=(",", ":"), sort_keys=True
        )
        doc = json.dumps(
            {"seq": seq, "sha256": hashlib.sha256(body.encode()).hexdigest(),
             "state": json.loads(body)},
            separators=(",", ":"),
        )
        path = self._snapshot_path(seq)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(doc)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)

    # -- replay -------------------------------------------------------------

    def _scan(self) -> tuple[list[tuple[int, str]], list[tuple[int, str]]]:
        segments: list[tuple[int, str]] = []
        snapshots: list[tuple[int, str]] = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return [], []
        for name in names:
            m = _SEGMENT_RE.match(name)
            if m:
                segments.append(
                    (int(m.group(1)), os.path.join(self.directory, name))
                )
                continue
            m = _SNAPSHOT_RE.match(name)
            if m:
                snapshots.append(
                    (int(m.group(1)), os.path.join(self.directory, name))
                )
        segments.sort()
        snapshots.sort()
        return segments, snapshots

    def _load_snapshot(self, path: str) -> JournalState | None:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
            body = json.dumps(
                doc["state"], separators=(",", ":"), sort_keys=True
            )
            if hashlib.sha256(body.encode()).hexdigest() != doc.get("sha256"):
                raise ValueError("snapshot digest mismatch")
            return JournalState.from_dict(doc["state"])
        except Exception as err:  # noqa: BLE001 - corrupt snapshot: fall back
            app_log.warning("journal snapshot %s unusable (%s); falling back",
                            path, err)
            return None

    def _replay(self) -> None:
        segments, snapshots = self._scan()
        state: JournalState | None = None
        base_seq = 0
        # Newest intact snapshot wins; corrupt ones fall back toward a
        # full-log replay rather than failing recovery outright.
        for snap_seq, snap_path in reversed(snapshots):
            loaded = self._load_snapshot(snap_path)
            if loaded is not None:
                state, base_seq = loaded, snap_seq
                break
        self.state = state if state is not None else JournalState()
        for seq, path in segments:
            if seq <= base_seq:
                continue
            self._replay_segment(path)
            self._seq = max(self._seq, seq)
        if snapshots:
            self._seq = max(self._seq, snapshots[-1][0])
        JOURNAL_SEGMENTS.set(float(len(segments)))

    def _replay_segment(self, path: str) -> None:
        """Replay one segment; truncate at the first torn frame, skip
        (but step past) digest-mismatched records.  Never raises."""
        try:
            fh = open(path, "r+b")
        except OSError:
            return
        with fh:
            data = fh.read()
            offset = 0
            good_end = 0
            while offset < len(data):
                header = data[offset:offset + _HEADER_BYTES]
                if len(header) < _HEADER_BYTES:
                    break  # torn header → truncate here
                (length,) = _LEN.unpack(header[:_LEN.size])
                if length > _MAX_RECORD_BYTES:
                    break  # garbage length → treat as torn tail
                payload = data[
                    offset + _HEADER_BYTES:offset + _HEADER_BYTES + length
                ]
                if len(payload) < length:
                    break  # torn payload → truncate here
                digest = header[_LEN.size:]
                if hashlib.sha256(payload).digest() != digest:
                    # Bit-flip inside an intact frame: the length prefix
                    # still walks us past it, so skip just this record.
                    self.replay_skipped += 1
                    JOURNAL_REPLAY_TOTAL.labels(outcome="skipped_corrupt").inc()
                    offset += _HEADER_BYTES + length
                    good_end = offset
                    continue
                try:
                    rec = json.loads(payload.decode("utf-8"))
                except ValueError:
                    self.replay_skipped += 1
                    JOURNAL_REPLAY_TOTAL.labels(outcome="skipped_corrupt").inc()
                    offset += _HEADER_BYTES + length
                    good_end = offset
                    continue
                self.state.apply(rec)
                self.replay_applied += 1
                JOURNAL_REPLAY_TOTAL.labels(outcome="applied").inc()
                offset += _HEADER_BYTES + length
                good_end = offset
            if good_end < len(data):
                self.replay_truncated += 1
                JOURNAL_REPLAY_TOTAL.labels(outcome="truncated_tail").inc()
                try:
                    fh.truncate(good_end)
                except OSError:
                    pass

    # -- views --------------------------------------------------------------

    def status(self) -> dict[str, Any]:
        segments, snapshots = self._scan()
        return {
            "dir": self.directory,
            "epoch": self.state.epoch,
            "segments": len(segments),
            "snapshots": len(snapshots),
            "replay": {
                "applied": self.replay_applied,
                "skipped_corrupt": self.replay_skipped,
                "truncated_tail": self.replay_truncated,
            },
            "sessions": len(self.state.sessions),
            "streams": len(self.state.streams),
            "tasks": len(self.state.tasks),
            "pools": len(self.state.pools),
        }


# -- module singleton --------------------------------------------------------
#
# Mirrors obs/events.py: one process-wide journal, configured once from the
# environment (or explicitly by the recovery path), with a record() helper
# that is a cheap no-op while unconfigured so the ~15 dispatcher call sites
# stay unconditional one-liners.

_journal: Journal | None = None
_journal_lock = threading.Lock()


def configure(directory: str | None = None, **kwargs: Any) -> Journal | None:
    """Open (or re-open) the process journal.  With no argument, honors
    ``COVALENT_TPU_JOURNAL_DIR``; returns None (journaling off) when
    neither names a directory."""
    global _journal
    directory = directory or os.environ.get("COVALENT_TPU_JOURNAL_DIR") or ""
    with _journal_lock:
        if _journal is not None:
            if _journal.directory == directory:
                return _journal
            _journal.close()
            _journal = None
        if not directory:
            return None
        _journal = Journal.open(directory, **kwargs)
        return _journal


def get_journal(auto_configure: bool = True) -> Journal | None:
    """The process journal, lazily opened from the environment."""
    if _journal is None and auto_configure:
        if os.environ.get("COVALENT_TPU_JOURNAL_DIR"):
            return configure()
        return None
    return _journal


def record(kind: str, *, sync: bool = False, **fields: Any) -> None:
    """Append one control-plane intent; no-op when journaling is off."""
    journal = get_journal()
    if journal is None:
        return
    try:
        journal.record(kind, sync=sync, **fields)
    except Exception:  # noqa: BLE001 - journaling must never break dispatch
        app_log.exception("journal append (%s) failed", kind)


def epoch() -> int:
    """Current dispatcher epoch (0 when journaling is off)."""
    journal = get_journal()
    return journal.epoch if journal is not None else 0


def reset() -> None:
    """Close and forget the process journal (tests)."""
    global _journal
    with _journal_lock:
        if _journal is not None:
            _journal.close()
            _journal = None


def now() -> float:
    """Wall-clock stamp for journal records (monkeypatchable in tests)."""
    return time.time()
