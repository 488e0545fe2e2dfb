"""Client of the resident pool server (own copy of the pool-client part of
``covalent_tpu_plugin/agent.py``).

:func:`start_pool_server` stages this package's ``harness.py`` on a worker
and starts it as ``harness.py --serve``; :class:`AgentClient` holds the
channel: a background reader files pushed events by id, so any number of
callers await their own answers, and a serving session's side-band records
go to the sink it registered (:meth:`AgentClient.watch_serve`).

The verbs: ``run`` (a launch-mode spec forked from the server's zygote)
with ``wait_exit``, ``kill``, ``watch``/``unwatch`` and ``task_inventory``;
RPC execute-by-digest (``register_fn``, ``invoke``, ``wait_result``); the
serving session's ``serve_*``.

The channel speaks JSON lines.  The reference's native C++ agent, binary
frames (and with them invoke micro-batching) and the recovery verbs (epoch
fence, adopt, serving inventories, resume) come with ROADMAP item 2c.
"""

from __future__ import annotations

import asyncio
import base64
import json
import shlex
from typing import Any

from .resilience import tag_fault
from .transport.base import Transport, TransportError
from .utils.log import app_log

#: Remote filename of the staged harness the pool server runs.
HARNESS_BASENAME = "covalent_gpu_harness.py"

#: Modules the pool server and its zygote import once, at start-up: the cold
#: start is paid there, not by each electron or session.  ``torch._dynamo``
#: is what a torch optimizer imports at its first construction.
POOL_PRELOAD = "cloudpickle,torch,torch._dynamo,covalent_tpu_plugin_torch"


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
        tag_fault(failure, str(event.get("label") or f"serve_{event.get('code') or 'error'}"),
                  transient=False)
    return failure


async def start_pool_server(
    conn: Transport,
    remote_cache: str,
    python_path: str,
    env: dict[str, str] | None = None,
    timeout: float = 90.0,
    preload: str = POOL_PRELOAD,
) -> "AgentClient":
    """Start ``harness.py --serve`` on a worker and prove it with a ping.

    ``env`` goes into the server's environment before the interpreter
    starts (the executor's ``task_env``: ``CUDA_VISIBLE_DEVICES`` cannot
    change once CUDA is up, and ``PYTHONPATH`` then reaches imports too).
    ``preload`` becomes ``COVALENT_TPU_POOL_PRELOAD``: the modules the
    server and its zygote import at start-up.  The timeout covers that
    cold start.  The server's stderr (and the zygote's) goes to
    ``{remote_cache}/pool_server.log``.
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
        for k, v in {**(env or {}), "COVALENT_TPU_POOL_PRELOAD": preload}.items()
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
        #: per task / invocation: pid from ``started``, (code, signal) from
        #: ``exit``, the ``result`` event, and an ``error`` event's message
        #: and code.  Dropped by the waiter that consumes them, or
        #: :meth:`forget`.
        self._started: dict[str, int] = {}
        self._exits: dict[str, tuple[int, int]] = {}
        self._results: dict[str, dict] = {}
        self._errors: dict[str, str] = {}
        self._error_codes: dict[str, str] = {}
        #: function digests the runtime acknowledged, and refusals by digest
        self._registered: set[str] = set()
        self._register_errors: dict[str, tuple[str, str]] = {}
        self._task_inventory: dict | None = None
        #: ``callback(task_id, record)`` for side-band records of ids with
        #: no serving sink (an RPC invocation's worker records, a watched
        #: file's lines)
        self.on_telemetry = None
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
                    if kind == "started":
                        self._started[task_id] = int(event["pid"])
                    elif kind == "exit":
                        self._exits[task_id] = (int(event.get("code", -1)),
                                                int(event.get("signal", 0)))
                    elif kind == "result":
                        self._results[task_id] = event
                    elif kind == "registered":
                        self._registered.add(str(event.get("digest") or ""))
                    elif kind == "register_error":
                        self._register_errors[str(event.get("digest") or "")] = (
                            str(event.get("code") or "error"),
                            str(event.get("message") or "?"),
                        )
                    elif kind == "task_inventory":
                        self._task_inventory = event
                    elif kind == "serve_opened":
                        self._serve_opened[task_id] = event
                    elif kind == "serve_error":
                        self._serve_errors[task_id] = event
                    elif kind == "serve_closed":
                        self._serve_closed[task_id] = event
                    elif kind == "pong":
                        self._pongs += 1
                    elif kind == "error":
                        # An error with an id answers that task's run,
                        # invoke, kill or watch; an id-less one is logged only.
                        if task_id:
                            self._errors[task_id] = str(event.get("message", "?"))
                            if event.get("code"):
                                self._error_codes[task_id] = str(event["code"])
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
        sink = self._serve_sinks.get(task_id) or self.on_telemetry
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

    def _pop_rejection(self, task_id: str, what: str) -> AgentError | None:
        """A stored ``error`` event for ``task_id`` as an exception (or None).

        A rejection means the task never started, so running it another
        way is safe (``rejected``).  ``cuda_initialized`` (the zygote found
        CUDA initialised in itself) is tagged PERMANENT: it is a fault of
        the pool, and another road would hide it.
        """
        if task_id not in self._errors:
            return None
        message = self._errors.pop(task_id)
        code = self._error_codes.pop(task_id, "")
        rejection = AgentError(f"agent@{self.address} rejected {what} {task_id}: {message}")
        rejection.rejected = True  # type: ignore[attr-defined]
        if code == "cuda_initialized":
            tag_fault(rejection, "zygote_cuda", transient=False)
        return rejection

    # -- the run verb ---------------------------------------------------------

    async def run_task(self, task_id: str, spec: str, log: str = "",
                       timeout: float = 30.0) -> int:
        """Run a staged launch-mode spec as a fork of the server's zygote;
        returns the child's pid from the ``started`` event.

        The task's files (spec, log, pid, result) are those a launch-mode
        harness uses, so the pid and result-file probes still work if the
        channel dies.  A raised :class:`AgentError` carries
        ``maybe_started``: whether the command left for the worker without
        a rejection, so the task may be running there and must not be
        launched again.
        """
        command: dict = {"cmd": "run", "id": task_id, "spec": spec}
        if log:
            command["log"] = log
        sent = False
        try:
            await self._send(command)
            sent = True

            def ready(c: "AgentClient"):
                rejection = c._pop_rejection(task_id, "run")
                if rejection is not None:
                    raise rejection
                return c._started.get(task_id)

            pid = await self._wait(ready, timeout)
            self._started.pop(task_id, None)
            return pid
        except AgentError as err:
            err.maybe_started = sent and not getattr(  # type: ignore[attr-defined]
                err, "rejected", False)
            raise

    async def wait_exit(self, task_id: str, timeout: float | None = None) -> tuple[int, int]:
        """Block until the pushed ``exit`` event: ``(exit_code, signal)``."""
        event = await self._wait(lambda c: c._exits.get(task_id), timeout)
        self._exits.pop(task_id, None)
        return event

    async def kill(self, task_id: str, sig: int = 15) -> None:
        """Signal a running task's process group (fire-and-forget)."""
        await self._send({"cmd": "kill", "id": task_id, "sig": sig})

    async def watch(self, task_id: str, path: str) -> None:
        """Tail a task's worker-local JSONL file from offset 0: each line
        arrives as a side-band record for :attr:`on_telemetry`."""
        await self._send({"cmd": "watch", "id": task_id, "path": path})

    async def unwatch(self, task_id: str) -> None:
        await self._send({"cmd": "unwatch", "id": task_id})

    async def task_inventory(self, timeout: float = 30.0) -> dict:
        """The forked tasks still running on the worker (``tasks``: id, pid)."""
        self._task_inventory = None
        await self._send({"cmd": "task_inventory"})
        inventory = await self._wait(lambda c: c._task_inventory, timeout)
        self._task_inventory = None
        return inventory

    def forget(self, task_id: str) -> None:
        """Drop whatever this channel retained for a finished or abandoned
        task: an exit nobody waited for, an unclaimed result, a stored
        rejection, the side-band seq mark.  The executor calls it on every
        exit path of an electron."""
        self._started.pop(task_id, None)
        self._exits.pop(task_id, None)
        self._errors.pop(task_id, None)
        self._error_codes.pop(task_id, None)
        self._results.pop(task_id, None)
        if task_id not in self._serve_sinks:
            # a live session's seq mark is its token dedup: keep it
            self._telemetry_seq.pop(task_id, None)

    # -- RPC execute-by-digest --------------------------------------------

    @property
    def registered_digests(self) -> frozenset:
        """Function digests this channel's resident runtime holds."""
        return frozenset(self._registered)

    async def register_fn(self, digest: str, path: str, timeout: float = 60.0) -> None:
        """Register a CAS-staged cloudpickled function by its digest.

        The runtime verifies ``path``'s sha256 against ``digest`` before
        unpickling and keeps the function for invoke-by-digest.  A digest
        this channel already registered is a no-op.  A digest mismatch (a
        torn or stale artifact) raises :class:`AgentError` tagged PERMANENT
        (``rpc_digest_mismatch``): sending the same bytes again cannot help.
        """
        if digest in self._registered:
            return
        await self._send({"cmd": "register_fn", "digest": digest, "path": path})

        def settled(c: "AgentClient"):
            if digest in c._register_errors:
                code, message = c._register_errors.pop(digest)
                failure = AgentError(
                    f"agent@{c.address}: register {digest[:12]} failed ({code}): {message}")
                if code == "digest_mismatch":
                    tag_fault(failure, "rpc_digest_mismatch", transient=False)
                raise failure
            return digest in c._registered

        await self._wait(settled, timeout)

    async def invoke(
        self,
        task_id: str,
        digest: str,
        spec: dict | None = None,
        args_b64: str | None = None,
        args_bytes: bytes | None = None,
        args_path: str = "",
        args_digest: str = "",
        path: str = "",
        result_path: str = "",
        result_max_inline: int | None = None,
        timeout: float = 30.0,
    ) -> int:
        """Invoke a registered function by digest; returns the worker's pid
        from the ``started`` acknowledgement.

        The args travel inline, base64 in the JSON line (``args_b64``, or
        ``args_bytes`` encoded here), or by CAS path and digest when
        oversized.  ``path`` (the function's CAS artifact) lets a restarted
        runtime heal a lost registration.  Given ``result_path`` and
        ``result_max_inline``, a result pickle over the threshold is staged
        to that remote path instead of inlined.  The result arrives
        separately (:meth:`wait_result`).
        """
        command: dict = {"cmd": "invoke", "id": task_id, "digest": digest}
        if path:
            command["path"] = path
        if spec:
            command["spec"] = dict(spec)
        if args_b64 is None and args_bytes is not None:
            args_b64 = base64.b64encode(args_bytes).decode("ascii")
        if args_b64 is not None:
            command["args"] = args_b64
        elif args_path:
            command["args_path"] = args_path
            if args_digest:
                command["args_digest"] = args_digest
        if result_path and result_max_inline is not None:
            command["result_path"] = result_path
            command["result_max_inline"] = int(result_max_inline)
        await self._send(command)

        def ready(c: "AgentClient"):
            rejection = c._pop_rejection(task_id, "invoke")
            if rejection is not None:
                raise rejection
            return c._started.get(task_id)

        pid = await self._wait(ready, timeout)
        self._started.pop(task_id, None)
        return pid

    async def wait_result(self, task_id: str, timeout: float | None = None) -> dict:
        """Block until the invocation's pushed ``result`` event."""
        event = await self._wait(lambda c: c._results.get(task_id), timeout)
        self._results.pop(task_id, None)
        return event

    # -- serving sessions -------------------------------------------------------

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
