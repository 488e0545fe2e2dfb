"""Client of the resident pool server (own copy of the pool-client part of
``covalent_tpu_plugin/agent.py``).

:func:`start_pool_server` stages this package's ``harness.py`` on a worker
and starts it as ``harness.py --serve``; :class:`AgentClient` holds the
channel: a background reader files pushed events by id, so any number of
callers await their own answers, and a serving session's side-band records
go to the sink it registered (:meth:`AgentClient.watch_serve`).

The channel speaks JSON lines.  The reference's native C++ agent, binary
frames and the recovery verbs (epoch fence, adopt, inventories, resume)
come with ROADMAP item 2c; the ``run``/RPC verbs with slice 5.
"""

from __future__ import annotations

import asyncio
import json
import shlex
from typing import Any

from .transport.base import Transport, TransportError
from .utils.log import app_log

#: Remote filename of the staged harness the pool server runs.
HARNESS_BASENAME = "covalent_gpu_harness.py"

#: Modules the pool server imports once, before any session opens: its cold
#: start (the torch import) is paid at start-up, inside the open's budget.
POOL_PRELOAD = "cloudpickle,torch"


class AgentError(TransportError):
    """The resident runtime is unavailable, refused a command, or its
    channel failed."""


def _refusal(address: str, what: str, event: dict) -> AgentError:
    """A ``serve_error`` event as an exception, tagged PERMANENT (for
    :func:`~.resilience.classify_error`) when the worker says so."""
    failure = AgentError(
        f"agent@{address}: {what} failed ({event.get('code')}): {event.get('message')}"
    )
    if event.get("permanent"):
        failure.fault_label = str(  # type: ignore[attr-defined]
            event.get("label") or f"serve_{event.get('code') or 'error'}"
        )
        failure.fault_transient = False  # type: ignore[attr-defined]
    return failure


async def start_pool_server(
    conn: Transport,
    remote_cache: str,
    python_path: str,
    env: dict[str, str] | None = None,
    timeout: float = 90.0,
) -> "AgentClient":
    """Start ``harness.py --serve`` on a worker and prove it with a ping.

    ``env`` goes into the server's environment before the interpreter
    starts (the executor's ``task_env``: ``CUDA_VISIBLE_DEVICES`` cannot
    change once CUDA is up, and ``PYTHONPATH`` then reaches imports too).
    The timeout covers the cold start (``POOL_PRELOAD``).  The server's
    stderr goes to ``{remote_cache}/pool_server.log``.
    """
    from . import harness as harness_module

    remote_harness = f"{remote_cache}/{HARNESS_BASENAME}"
    try:
        await conn.run(f"mkdir -p {shlex.quote(remote_cache)}")
        await conn.put(harness_module.__file__, remote_harness)
    except TransportError as err:
        raise AgentError(f"cannot stage pool server on {conn.address}: {err}") from err
    assignments = " ".join(
        shlex.quote(f"{k}={v}")
        for k, v in {**(env or {}), "COVALENT_TPU_POOL_PRELOAD": POOL_PRELOAD}.items()
    )
    command = (
        f"env {assignments} {python_path} {shlex.quote(remote_harness)} --serve "
        f"2>> {shlex.quote(remote_cache + '/pool_server.log')}"
    )
    try:
        process = await conn.start_process(command, describe=f"pool@{conn.address}")
    except TransportError as err:
        raise AgentError(f"cannot start pool server on {conn.address}: {err}") from err
    client = AgentClient(process, conn.address)
    try:
        await client.ping(timeout)
    except AgentError:
        await client.close()
        raise
    return client


class AgentClient:
    """One pool-server channel, demultiplexing pushed events."""

    def __init__(self, process, address: str):
        self._process = process
        self.address = address
        self._pongs = 0
        self._dead: BaseException | None = None
        self._cond = asyncio.Condition()
        #: id -> highest worker-record ``seq`` seen; a record at or below
        #: it is a duplicate and is dropped.
        self._telemetry_seq: dict[str, int] = {}
        #: serving sessions: sid -> pushed serve_opened / serve_error /
        #: serve_closed event, and sid -> the sink of its side-band records.
        self._serve_opened: dict[str, dict] = {}
        self._serve_errors: dict[str, dict] = {}
        self._serve_closed: dict[str, dict] = {}
        self._serve_sinks: dict[str, Any] = {}
        self._reader = asyncio.ensure_future(self._read_loop())

    @property
    def alive(self) -> bool:
        return self._dead is None and not self._reader.done()

    async def close(self) -> None:
        """Ask the server to shut down, then reap it."""
        try:
            if self._dead is None:
                await self._process.write_line('{"cmd":"shutdown"}')
        except TransportError:
            pass
        self._reader.cancel()
        try:
            await self._reader
        except (asyncio.CancelledError, Exception):
            pass
        await self._process.close()

    # -- event plumbing ------------------------------------------------------

    async def _read_loop(self) -> None:
        try:
            while True:
                line = await self._process.read_line()
                try:
                    event = json.loads(line)
                except ValueError:
                    continue  # stray non-protocol output; ignore
                if not isinstance(event, dict):
                    continue
                async with self._cond:
                    kind = event.get("event")
                    task_id = str(event.get("id") or "")
                    if kind == "telemetry":
                        self._handle_telemetry(task_id, event.get("data"))
                        continue  # side-band: no waiter to notify
                    if kind == "serve_opened":
                        self._serve_opened[task_id] = event
                    elif kind == "serve_error":
                        self._serve_errors[task_id] = event
                    elif kind == "serve_closed":
                        self._serve_closed[task_id] = event
                    elif kind == "pong":
                        self._pongs += 1
                    elif kind == "error":
                        app_log.warning("agent@%s error: %s", self.address,
                                        event.get("message"))
                    self._cond.notify_all()
        except asyncio.CancelledError:
            raise
        except BaseException as err:  # noqa: BLE001 - ANY reader death must wake waiters
            async with self._cond:
                self._dead = err
                self._cond.notify_all()

    def _handle_telemetry(self, task_id: str, data) -> None:
        """Dedup one side-band record by ``seq`` and hand it to the sid's sink."""
        if not isinstance(data, dict):
            return
        seq = data.get("seq")
        if isinstance(seq, int):
            if seq <= self._telemetry_seq.get(task_id, 0):
                return
            self._telemetry_seq[task_id] = seq
        sink = self._serve_sinks.get(task_id)
        if sink is None:
            return
        try:
            sink(task_id, data)
        except Exception as err:  # noqa: BLE001 - observers must not break the reader
            app_log.debug("serve sink failed: %s", err)

    async def _wait(self, predicate, timeout: float | None):
        """Await ``predicate(self)`` truthy, raising AgentError on channel death."""

        async def waiter():
            async with self._cond:
                while True:
                    if self._dead is not None:
                        raise AgentError(f"agent@{self.address} channel died: {self._dead}")
                    value = predicate(self)
                    if value:
                        return value
                    await self._cond.wait()

        try:
            return await asyncio.wait_for(waiter(), timeout)
        except asyncio.TimeoutError:
            raise AgentError(f"agent@{self.address}: no event within {timeout}s") from None

    async def _send(self, command: dict) -> None:
        if self._dead is not None:
            raise AgentError(f"agent@{self.address} channel died: {self._dead}")
        try:
            await self._process.write_line(json.dumps(command))
        except TransportError as err:
            raise AgentError(f"agent@{self.address}: send failed: {err}") from err

    # -- commands ------------------------------------------------------------

    async def ping(self, timeout: float = 15.0) -> None:
        before = self._pongs
        await self._send({"cmd": "ping"})
        await self._wait(lambda c: c._pongs > before, timeout)

    async def serve_open(self, sid: str, digest: str, path: str,
                         options: dict | None = None, spec: dict | None = None,
                         timeout: float = 120.0) -> dict:
        """Open a resident serving session; returns the ``serve_opened``
        event (``slots``, worker ``pid``).

        The worker verifies ``path``'s sha256 against ``digest`` before
        unpickling the factory, calls it once (the model build on the card:
        hence the generous timeout) and serves requests for the session's
        lifetime.  A refused open raises :class:`AgentError`, tagged
        PERMANENT when the refusal is deterministic (a digest mismatch, a
        factory refusing its model).
        """
        command: dict = {"cmd": "serve_open", "id": sid, "digest": digest, "path": path}
        if options:
            command["options"] = dict(options)
        if spec:
            command["spec"] = dict(spec)
        await self._send(command)

        def settled(c: "AgentClient"):
            if sid in c._serve_errors:
                raise _refusal(c.address, f"serve_open {sid}", c._serve_errors.pop(sid))
            return c._serve_opened.pop(sid, None)

        return await self._wait(settled, timeout)

    async def serve_request(self, sid: str, rid: str, prompt, params: dict | None = None,
                            deadline_s: float = 0.0) -> None:
        """Submit one request to an open session (fire-and-stream): its
        ``serve.token`` records, or a ``serve.reject``, arrive at the
        session's :meth:`watch_serve` sink."""
        command: dict = {"cmd": "serve_request", "id": sid, "rid": rid, "prompt": prompt}
        if params:
            command["params"] = dict(params)
        if deadline_s:
            command["deadline_s"] = float(deadline_s)
        await self._send(command)

    async def serve_close(self, sid: str, timeout: float = 30.0) -> dict:
        """Close a session; returns the ``serve_closed`` event (``served``)
        once the worker has drained its admitted and queued requests."""
        await self._send({"cmd": "serve_close", "id": sid})

        def settled(c: "AgentClient"):
            if sid in c._serve_errors:
                raise _refusal(c.address, f"serve_close {sid}", c._serve_errors.pop(sid))
            return c._serve_closed.pop(sid, None)

        return await self._wait(settled, timeout)

    async def serve_cancel(self, sid: str, rid: str) -> None:
        """Cancel one in-flight request (fire-and-forget): the worker frees
        the lane and ends the stream with ``error="cancelled"``."""
        await self._send({"cmd": "serve_cancel", "id": sid, "rid": rid})

    def watch_serve(self, sid: str, sink) -> None:
        """Route session ``sid``'s side-band records to ``sink(sid, data)``.
        Register before the first request so no token slips past."""
        self._serve_sinks[sid] = sink

    def unwatch_serve(self, sid: str) -> None:
        """Drop a closed session's sink and retained per-sid state."""
        self._serve_sinks.pop(sid, None)
        self._telemetry_seq.pop(sid, None)
        self._serve_opened.pop(sid, None)
        self._serve_errors.pop(sid, None)
        self._serve_closed.pop(sid, None)

    async def wait_dead(self) -> None:
        """Block until this channel dies, then raise :class:`AgentError`:
        the session supervisor's cue to reconnect."""
        await self._wait(lambda c: None, None)
