"""Dispatcher crash recovery: replayed journal state → re-adopted fleet.

The port's own copy of ``covalent_tpu_plugin/fleet/recovery.py``.  The journal (:mod:`.journal`) records what the dead dispatcher *meant*
to be true; the workers themselves know what *survived* (orphan-mode
pool servers hold their sessions through the dispatcher's death).  This
module reconciles the two on restart:

1. ``lease_gang()`` re-dials every worker.  The agent warm-up path
   tries orphan adoption first (``_try_adopt_orphan`` reads the
   rendezvous file, fence-checks the epoch, and splices the successor's
   channel onto the surviving process) and declares the new epoch on
   every channel — so by the time the lease returns, stale-dispatcher
   fencing is up and surviving pool servers are back on live pipes.
2. ``serve_inventory`` / ``task_inventory`` ask each worker what it
   still holds: sessions by generation sid, running rids with
   emitted-token counts, forked task children.
3. Each journaled session found in an inventory is re-adopted into a
   fresh :class:`~..serving.supervisor.SessionSupervisor`
   (:meth:`~..serving.supervisor.SessionSupervisor.adopt`), and each
   journaled in-flight stream is re-attached with
   :meth:`~..serving.supervisor.SessionSupervisor.resume_stream` from
   its journaled token high-water mark — the worker re-emits history
   from that offset and the supervisor's idx-splice keeps delivery
   exactly-once.  Journaled sessions NO worker still holds are reaped:
   counted, journaled closed, reported.
4. Journaled in-flight electrons are *reported*, not re-run: Covalent's
   own retry re-dispatches them.  The reference's checkpoint-resume
   discovery (``_discover_resume``) comes with ``utils/checkpoint.py`` in
   slice 5b.

Journaled LoRA adapters (``session_adapter`` records) are restored to each
re-adopted session before its streams resume: an adapter the worker's
engine still holds (its inventory names the same content digest) is
book-kept without shipping a byte (``resident``), any other is re-attached
from the dispatcher's CAS bundle the journal points at (``attached``), and a
failed restore is reported ``error``; ``RECOVERY_ADAPTERS`` counts each by
state.

The whole pass is fenced by the epoch bump :meth:`Journal.open` already
performed — a zombie predecessor that wakes up mid-recovery finds every
worker refusing its commands.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any

from . import journal as journal_mod
from ..obs import events as obs_events
from ..obs.metrics import REGISTRY
from ..utils.log import app_log

__all__ = ["recover", "RecoveryReport", "last_report"]

RECOVERY_DURATION = REGISTRY.histogram(
    "covalent_tpu_recovery_duration_seconds",
    "Wall time of one dispatcher crash-recovery pass",
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0),
)
RECOVERY_ADOPTED = REGISTRY.counter(
    "covalent_tpu_recovery_adopted_total",
    "Surviving sessions re-adopted from orphaned workers after a "
    "dispatcher restart",
)
RECOVERY_ORPHANED = REGISTRY.counter(
    "covalent_tpu_recovery_orphaned_total",
    "Journaled sessions no surviving worker still held (reaped)",
)
RECOVERY_STREAMS = REGISTRY.counter(
    "covalent_tpu_recovery_streams_total",
    "In-flight streams re-attached from journaled high-water marks",
    ("state",),
)
RECOVERY_ADAPTERS = REGISTRY.counter(
    "covalent_tpu_recovery_adapters_total",
    "Journaled LoRA adapters restored to re-adopted sessions "
    "(resident: the worker still held it; attached: re-shipped from "
    "the local CAS; error: restore failed)",
    ("state",),
)

#: The last completed recovery pass (the ops endpoint's ``/status``
#: section reads it in the reference; that endpoint comes with slice 5b).  One dispatcher process
#: recovers at most once per incarnation, so a module global is enough.
_LAST_REPORT: dict | None = None


def last_report() -> dict | None:
    """The most recent recovery report (``None`` before any recovery)."""
    return _LAST_REPORT


class RecoveryReport(dict):
    """The recovery pass's outcome — a dict, plus the live handles.

    The dict half is JSON-safe (it feeds ``/status`` and the bench
    drill's artifact); ``supervisors`` and ``requests`` carry the
    re-adopted runtime objects so the caller can await the resumed
    streams' results directly.
    """

    def __init__(self) -> None:
        super().__init__()
        #: sid -> the re-adopted SessionSupervisor
        self.supervisors: dict[str, Any] = {}
        #: (sid, rid) -> the resumed ServeRequest
        self.requests: dict[tuple[str, str], Any] = {}


async def recover(executor: Any, timeout_s: float = 120.0) -> RecoveryReport:
    """Run one crash-recovery pass for ``executor``.

    Reads the journal's *replayed* state (``journal.recovered`` — the
    dead incarnation's world, captured before the epoch bump), re-dials
    the fleet, and re-adopts everything that survived.  Safe to call
    when journaling is off or the journal was empty: returns a report
    with ``recovered=False`` and touches nothing.
    """
    global _LAST_REPORT
    report = RecoveryReport()
    journal = journal_mod.get_journal()
    prior = dict(journal.recovered) if journal is not None else {}
    sessions: dict[str, dict] = dict(prior.get("sessions") or {})
    streams: dict[str, dict] = dict(prior.get("streams") or {})
    tasks: dict[str, dict] = dict(prior.get("tasks") or {})
    report.update({
        "recovered": False,
        "epoch": journal.epoch if journal is not None else 0,
        "journaled_sessions": len(sessions),
        "journaled_streams": len(streams),
        "journaled_tasks": len(tasks),
        "adopted_sessions": [],
        "orphaned_sessions": [],
        "resumed_streams": [],
        "reattached_adapters": [],
        "pending_tasks": sorted(tasks),
        "pools": dict(prior.get("pools") or {}),
        "pool_targets": dict(prior.get("pool_targets") or {}),
        "replica_sets": dict(prior.get("replica_sets") or {}),
        "workers": [],
        "duration_s": 0.0,
    })
    if journal is None or not (sessions or streams or tasks):
        _LAST_REPORT = dict(report)
        return report

    t0 = time.monotonic()
    app_log.info(
        "recovery: epoch %d, replayed %d session(s) / %d stream(s) / "
        "%d task(s) from journal",
        journal.epoch, len(sessions), len(streams), len(tasks),
    )

    # -- 1. re-dial.  lease_gang's warm-up adopts orphaned pool servers
    # (rendezvous + fence-checked attach) and declares the new epoch on
    # every channel before this returns.
    lease = await asyncio.wait_for(executor.lease_gang(), timeout_s)
    # Re-dialed workers start with NEUTRAL health: pre-crash scores and
    # quarantines describe the dead incarnation's observations, and a
    # stale quarantine would drain a worker that just proved itself by
    # answering the re-dial.  Real traffic re-earns the grade.
    from .health import HEALTH

    for address in lease.addresses:
        HEALTH.neutral(str(address))

    # -- 2. inventory every live channel.
    by_sidg: dict[str, tuple[Any, Any, str, dict]] = {}
    running_tasks: list[dict] = []
    for conn, address in zip(lease.conns, lease.addresses):
        client = executor._agents.get(conn.address)
        if client is None:
            continue
        worker: dict = {"address": address, "sessions": [], "tasks": 0}
        try:
            inv = await client.serve_inventory()
            tinv = await client.task_inventory()
        except Exception as err:  # noqa: BLE001 - a dead worker is data
            worker["error"] = repr(err)
            report["workers"].append(worker)
            continue
        for entry in inv.get("sessions") or []:
            sid_g = str(entry.get("sid") or "")
            if sid_g:
                by_sidg[sid_g] = (client, conn, address, dict(entry))
                worker["sessions"].append(sid_g)
        children = list(tinv.get("tasks") or [])
        worker["tasks"] = len(children)
        running_tasks.extend(children)
        report["workers"].append(worker)

    # -- 3. re-adopt each journaled session a worker still holds; resume
    # its journaled streams from their high-water marks.
    from ..serving.supervisor import ServeRequest, SessionSupervisor

    for sid, meta in sessions.items():
        sid_g = str(meta.get("sid_g") or "")
        found = by_sidg.pop(sid_g, None)
        if found is None:
            report["orphaned_sessions"].append(sid)
            RECOVERY_ORPHANED.inc()
            # Journal the reap so the NEXT replay doesn't resurrect it.
            journal_mod.record("session_closed", sid=sid, sync=True)
            continue
        client, conn, address, entry = found
        supervisor = SessionSupervisor(
            executor,
            sid=sid,
            queue_max=meta.get("queue_max"),
            default_deadline_s=meta.get("default_deadline_s"),
            stats_interval_s=meta.get("stats_interval_s"),
        )
        try:
            await supervisor.adopt(
                client=client,
                conns=[conn],
                address=address,
                sid_g=sid_g,
                slots=int(entry.get("slots") or meta.get("slots") or 1),
                digest=str(meta.get("digest") or entry.get("digest") or ""),
                payload_path=str(meta.get("payload") or ""),
            )
        except Exception as err:  # noqa: BLE001 - keep recovering others
            app_log.warning("recovery: adopt of %s failed: %r", sid, err)
            report["orphaned_sessions"].append(sid)
            RECOVERY_ORPHANED.inc()
            continue
        report["adopted_sessions"].append(sid)
        report.supervisors[sid] = supervisor
        RECOVERY_ADOPTED.inc()
        # Restore journaled adapters before resuming streams (reference
        # recovery.py:232-271): a resumed request naming an adapter the
        # engine lacks would be refused.  What the worker's engine still
        # holds (by content digest) is book-kept, the rest re-attached.
        resident = entry.get("adapters") if isinstance(entry.get("adapters"), dict) else {}
        for aname, arec in dict(meta.get("adapters") or {}).items():
            arec = arec if isinstance(arec, dict) else {}
            content = str(arec.get("content") or "")
            try:
                if content and str(resident.get(aname) or "") == content:
                    supervisor.note_adapter(aname, digest=str(arec.get("digest") or ""),
                                            path=str(arec.get("path") or ""), content=content)
                    state = "resident"
                else:
                    await supervisor.attach_adapter(aname, path=str(arec.get("path") or ""),
                                                    digest=str(arec.get("digest") or ""))
                    state = "attached"
            except Exception as err:  # noqa: BLE001 - keep recovering
                app_log.warning("recovery: adapter %r re-attach on %s failed: %r",
                                aname, sid, err)
                state = "error"
            RECOVERY_ADAPTERS.labels(state=state).inc()
            report["reattached_adapters"].append({"sid": sid, "adapter": aname,
                                                  "state": state})
        for key, srec in streams.items():
            ssid, _, rid = key.partition("\x00")
            if ssid != sid or not rid:
                continue
            request = ServeRequest(
                rid,
                list(srec.get("prompt") or []),
                dict(srec.get("params") or {}),
                float(srec.get("deadline_s") or 0.0),
                str(srec.get("tenant") or ""),
            )
            request.resumed_from = int(srec.get("hwm") or 0)
            try:
                state = await supervisor.resume_stream(request)
            except Exception as err:  # noqa: BLE001
                app_log.warning(
                    "recovery: resume of %s/%s failed: %r", sid, rid, err
                )
                RECOVERY_STREAMS.labels(state="error").inc()
                report["resumed_streams"].append({
                    "sid": sid, "rid": rid, "state": "error",
                    "from": request.resumed_from,
                })
                continue
            RECOVERY_STREAMS.labels(state=state or "unknown").inc()
            report.requests[(sid, rid)] = request
            report["resumed_streams"].append({
                "sid": sid, "rid": rid, "state": state,
                "from": request.resumed_from, "sent": request.resumed_sent,
            })

    # Surviving sessions the journal never heard of (journaling enabled
    # mid-flight, or a torn tail ate the open record): count them so the
    # operator sees the mismatch, but leave them alone — their worker
    # keeps serving whoever still holds the other end.
    report["unjournaled_sessions"] = sorted(by_sidg)
    report["running_task_children"] = len(running_tasks)
    report["recovered"] = True
    report["duration_s"] = round(time.monotonic() - t0, 3)
    RECOVERY_DURATION.observe(report["duration_s"])
    _LAST_REPORT = dict(report)
    obs_events.emit(
        "recovery.complete",
        epoch=report["epoch"],
        adopted=len(report["adopted_sessions"]),
        orphaned=len(report["orphaned_sessions"]),
        streams=len(report["resumed_streams"]),
        adapters=len(report["reattached_adapters"]),
        duration_s=report["duration_s"],
    )
    app_log.info(
        "recovery: adopted %d session(s), reaped %d, resumed %d "
        "stream(s) in %.3fs",
        len(report["adopted_sessions"]), len(report["orphaned_sessions"]),
        len(report["resumed_streams"]), report["duration_s"],
    )
    return report
