"""One supervised serving session: open, stream, reconnect, replay.

Own copy of ``covalent_tpu_plugin/serving/supervisor.py``'s one-session
path.  A :class:`SessionSupervisor` owns ONE remote session at a time (a
*generation*): it leases the executor's worker, ships the factory payload
by digest, opens the session on the resident pool server, routes the
side-band records of its streams, and, when the channel dies, re-opens the
session on a fresh server and replays every in-flight request.  A replayed
stream restarts at token 0 and is spliced on the request's own high-water
mark (the cumulative ``idx`` of each chunk), so each caller sees every
token exactly once.

Left out until ROADMAP item 2c, and not stubbed: the journal and recovery
(``adopt``/``resume_stream``), the warm handoff and the preemption notice,
hedging, health scores, serving metrics and tracing, replica-set hooks and
fleet-pool pinning.
"""

from __future__ import annotations

import asyncio
import os
import time
import uuid
from typing import Any, AsyncIterator

from ..agent import AgentClient, AgentError
from ..cache import bytes_digest, cas_path
from ..resilience import FaultClass, RetryPolicy, classify_error
from ..transport.base import TransportError
from ..utils.log import app_log

__all__ = ["ServeError", "ServeRequest", "ServeRequestRejected", "SessionSupervisor"]

#: Fields of every worker record that are not its content.
_ENVELOPE = frozenset(("ts", "pid", "seq", "type", "operation_id", "rpc"))


def _env_number(name: str, default: float, cast=float):
    value = os.environ.get(name)
    if value is None:
        return default
    try:
        return cast(value)
    except (TypeError, ValueError):
        app_log.warning("ignoring non-numeric %s=%r", name, value)
        return default


class ServeError(RuntimeError):
    """Session-level failure (open refused, stream torn, handle closed)."""


class ServeRequestRejected(ServeError):
    """One request refused by the worker (shed, unknown session, engine).

    Tagged for :func:`~..resilience.classify_error`: an admission shed is
    PERMANENT under ``serve_admission_shed`` (the bounded queue refused the
    work because the session is overloaded; a retry would amplify that); a
    lost session stays transient (the reconnect re-opens it).
    """

    def __init__(self, rid: str, code: str, message: str) -> None:
        super().__init__(f"request {rid} rejected ({code}): {message}")
        self.rid = rid
        self.code = code
        if code == "serve_admission_shed":
            self.fault_label = "serve_admission_shed"
            self.fault_transient = False
        elif code == "unknown_session":
            self.fault_label = "serve_session_lost"
            self.fault_transient = True
        else:
            self.fault_label = f"serve_{code or 'rejected'}"
            self.fault_transient = False


class ServeRequest:
    """One in-flight request's stream state.

    ``stream()`` yields token chunks as they arrive; ``result()`` awaits the
    whole token list.  A request that hit its deadline completes normally
    with its partial stream and ``error == "deadline_exceeded"``; a rejected
    request raises :class:`ServeRequestRejected` from both.  The request
    carries its own splice state (``tokens``), which is what makes a replay
    exactly-once.
    """

    def __init__(self, rid: str, prompt: list[int], params: dict | None,
                 deadline_s: float) -> None:
        self.rid = rid
        self.prompt = prompt
        self.params = dict(params or {})
        self.deadline_s = float(deadline_s)
        self.tokens: list[int] = []
        self.error = ""
        self.t_submit = time.monotonic()
        self.t_first: float | None = None
        self.t_done: float | None = None
        self._chunks: asyncio.Queue = asyncio.Queue()
        self._done: asyncio.Future = asyncio.get_running_loop().create_future()
        # Unawaited failures must not warn at GC: a caller may only ever
        # consume stream().
        self._done.add_done_callback(lambda f: None if f.cancelled() else f.exception())

    @property
    def done(self) -> bool:
        return self._done.done()

    @property
    def ttft_s(self) -> float | None:
        """Submit -> first streamed token (None until one arrived)."""
        return None if self.t_first is None else self.t_first - self.t_submit

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit

    async def result(self, timeout: float | None = None) -> list[int]:
        """The full token stream (prompt excluded); raises on rejection."""
        return await asyncio.wait_for(asyncio.shield(self._done), timeout)

    async def stream(self) -> AsyncIterator[list[int]]:
        """Yield token chunks in arrival order until the stream closes."""
        while True:
            item = await self._chunks.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def _feed(self, tokens: list[int], done: bool, error: str = "") -> None:
        if self._done.done():
            return
        if tokens:
            if self.t_first is None:
                self.t_first = time.monotonic()
            self.tokens.extend(tokens)
            self._chunks.put_nowait(list(tokens))
        if done:
            self.t_done = time.monotonic()
            self.error = error
            self._chunks.put_nowait(None)
            self._done.set_result(list(self.tokens))

    def _fail(self, err: BaseException) -> None:
        if self._done.done():
            return
        self.t_done = time.monotonic()
        self._chunks.put_nowait(err)
        self._done.set_exception(err)


class SessionSupervisor:
    """One resident serving session, supervised for its whole life.

    Registers itself in the executor's ``_serve_handles`` (so
    ``executor.serve_sessions()`` sees it) while open.  All methods must run
    on the executor's event loop.  Knob defaults come from
    ``COVALENT_TPU_SERVE_{QUEUE_MAX, DEADLINE_S, STATS_INTERVAL_S,
    OPEN_TIMEOUT_S, RETRIES}``.
    """

    def __init__(self, executor: Any, *, sid: str = "", queue_max: int | None = None,
                 default_deadline_s: float | None = None,
                 stats_interval_s: float | None = None,
                 open_timeout_s: float | None = None, retries: int | None = None) -> None:
        def knob(value, name, default, cast=float):
            return cast(value if value is not None
                        else _env_number(f"COVALENT_TPU_SERVE_{name}", default, cast))

        self.executor = executor
        self.sid = sid or f"serve-{uuid.uuid4().hex[:10]}"
        self.queue_max = knob(queue_max, "QUEUE_MAX", 64, int)
        self.default_deadline_s = knob(default_deadline_s, "DEADLINE_S", 0.0)
        self.stats_interval_s = knob(stats_interval_s, "STATS_INTERVAL_S", 1.0)
        #: one budget for a whole open: the pool server's cold start (the
        #: torch import), staging, and the factory's model build.
        self.open_timeout_s = knob(open_timeout_s, "OPEN_TIMEOUT_S", 120.0)
        self.retries = knob(retries, "RETRIES", 2, int)
        self.slots = 0
        self.generation = 0
        self.served = 0
        self.reconnects = 0
        #: replayed tokens below a stream's high-water mark that differ from
        #: the ones already delivered (dropped by the splice all the same)
        self.replay_mismatches = 0
        self.opened_at = 0.0
        self.stats: dict[str, Any] = {}
        self.address = ""
        self._digest = ""
        self._local_payload = ""
        self._client: AgentClient | None = None
        self._conns: list = []
        self._sid_g = ""
        self._gen_counter = 0
        self._requests: dict[str, ServeRequest] = {}
        self._closed = False
        self._failed: BaseException | None = None
        self._ready = asyncio.Event()
        self._supervisor: asyncio.Task | None = None
        #: fire-and-forget cancels held here so they are not collected mid-await
        self._bg_tasks: set = set()

    # -- views ----------------------------------------------------------------

    @property
    def state(self) -> str:
        if self._failed is not None:
            return "failed"
        if self._closed:
            return "closed"
        if not self._ready.is_set():
            return "reconnecting"
        return "open"

    @property
    def in_flight(self) -> int:
        return len(self._requests)

    def status(self) -> dict[str, Any]:
        """This session's view for ``executor.serve_sessions()``."""
        view: dict[str, Any] = {
            "state": self.state, "address": self.address, "slots": self.slots,
            "generation": self.generation, "served": self.served,
            "in_flight": self.in_flight, "reconnects": self.reconnects,
            "replay_mismatches": self.replay_mismatches,
            "age_s": round(time.time() - self.opened_at, 3) if self.opened_at else 0,
        }
        for field in ("busy", "queued", "tokens_per_s", "tokens_total"):
            if field in self.stats:
                view[field] = self.stats[field]
        return view

    # -- open -------------------------------------------------------------------

    async def open(self, payload: bytes, digest: str = "") -> "SessionSupervisor":
        """First open: stage the factory payload (``payload``: its
        cloudpickle; ``digest``: its sha256), open a generation, supervise."""
        self._digest = digest or bytes_digest(payload)
        self._local_payload = os.path.join(self.executor.cache_dir,
                                           f"serve_{self._digest}.pkl")
        await asyncio.to_thread(self.executor._write_payload_file, self._local_payload,
                                payload)
        await self._open_generation()
        self.opened_at = time.time()
        self.executor._serve_handles[self.sid] = self
        self._supervisor = asyncio.ensure_future(self._supervise())
        self._ready.set()
        return self

    async def _open_generation(self) -> None:
        """Open one remote session generation on a freshly leased worker.
        A failure discards whatever channels the attempt dialed, so a retry
        starts a fresh pool server instead of reusing the broken one."""
        dialed: list = []
        try:
            binding = await asyncio.wait_for(self._dial_generation(dialed),
                                             self.open_timeout_s)
        except BaseException as err:
            if dialed:
                try:
                    await self.executor._discard_workers(dialed)
                except Exception:  # noqa: BLE001 - teardown is best-effort
                    pass
            if isinstance(err, asyncio.TimeoutError):
                raise AgentError(f"session {self.sid}: open did not finish within "
                                 f"{self.open_timeout_s}s") from err
            raise
        self._client = binding["client"]
        self._conns = binding["conns"]
        self._sid_g = binding["sid_g"]
        self.address = binding["address"]
        self.slots = binding["slots"]
        self.generation += 1

    async def _dial_generation(self, dialed: list) -> dict:
        executor = self.executor
        lease = await executor.lease_gang(dialed=dialed)
        if len(lease.conns) != 1:
            raise ServeError(f"serving sessions target single-worker gangs, got "
                             f"{len(lease.conns)} workers")
        conn, address = lease.conns[0], lease.addresses[0]
        client = executor._agents.get(conn.address)
        if client is None or not client.alive:
            raise AgentError(f"no resident pool server on {address} (serving needs "
                             "the pool runtime: use_agent=True, 'auto' or use_agent='pool')")
        key = executor._pool_key(address)
        remote = cas_path(executor.remote_cache, self._digest, ".pkl")
        await executor._cas.ensure_probed(key, conn, [(self._digest, remote)])
        await executor._cas.ensure(key, conn, self._digest, self._local_payload, remote)
        sid_g = f"{self.sid}.g{self._gen_counter}"
        self._gen_counter += 1
        spec: dict[str, Any] = {"operation_id": sid_g}
        if executor.task_env:
            spec["env"] = dict(executor.task_env)
        client.watch_serve(sid_g, self._sink)
        try:
            opened = await client.serve_open(
                sid_g, self._digest, remote,
                options={"queue_max": self.queue_max,
                         "default_deadline_s": self.default_deadline_s,
                         "stats_interval_s": self.stats_interval_s},
                spec=spec, timeout=None,
            )
        except BaseException:
            client.unwatch_serve(sid_g)
            raise
        return {"client": client, "conns": list(lease.conns), "sid_g": sid_g,
                "address": address, "slots": int(opened.get("slots") or 1)}

    # -- requests ---------------------------------------------------------------

    async def submit(self, request: ServeRequest) -> ServeRequest:
        """Assign one request to this session and write its wire line
        (waiting out a reconnect in progress first).  Tokens arrive on the
        side-band; a failed write fails the request and raises."""
        try:
            await self._await_ready()
            self._requests[request.rid] = request
            try:
                await self._send_request(request)
            except BaseException:
                self._requests.pop(request.rid, None)
                raise
        except BaseException as err:
            request._fail(err if isinstance(err, ServeError)
                          else ServeError(f"request submit failed: {err!r}"))
            raise
        return request

    async def _send_request(self, request: ServeRequest) -> None:
        assert self._client is not None
        await self._client.serve_request(self._sid_g, request.rid, request.prompt,
                                         params=request.params,
                                         deadline_s=request.deadline_s)

    async def _await_ready(self) -> None:
        if self._closed:
            raise ServeError(f"session {self.sid} is closed")
        await self._ready.wait()
        if self._failed is not None:
            raise ServeError(f"session {self.sid} failed: {self._failed}") from self._failed
        if self._closed:
            raise ServeError(f"session {self.sid} is closed")

    # -- side-band routing ------------------------------------------------------

    def _sink(self, _sid: str, data: dict) -> None:
        """One telemetry record for this session (event-loop context)."""
        kind = data.get("type")
        if kind == "serve.token":
            self._on_token(data)
        elif kind == "serve.reject":
            self._on_reject(data)
        elif kind == "serve.stats":
            self._on_stats(data)

    def _on_token(self, data: dict) -> None:
        rid = str(data.get("rid") or "")
        request = self._requests.get(rid)
        if request is None:
            return
        idx = int(data.get("idx") or 0)
        tokens = list(data.get("tokens") or ())
        have = len(request.tokens)
        if idx > have:
            # A chunk went missing: exactly-once is broken for this stream;
            # fail it loudly rather than splice around a hole.
            self._finish(rid)
            request._fail(ServeError(f"token stream gap for {rid}: chunk starts at {idx}, "
                                     f"have {have}"))
            return
        # Replay splice: a re-opened session re-streams from idx 0; what is
        # at or below the high-water mark is a duplicate and drops here.
        # A replay decoded in another batch may flip a near-tie there: the
        # caller keeps what it was given, and the flip is counted.
        replayed = tokens[:have - idx]
        differ = sum(a != b for a, b in zip(replayed, request.tokens[idx:have]))
        if differ:
            self.replay_mismatches += differ
            app_log.warning("session %s: replay of %s differs from the delivered stream "
                            "at %d of %d tokens below its high-water mark", self.sid, rid,
                            differ, len(replayed))
        request._feed(tokens[have - idx:], bool(data.get("done")),
                      error=str(data.get("error") or ""))
        if request.done:
            self._finish(rid)

    def _on_reject(self, data: dict) -> None:
        rid = str(data.get("rid") or "")
        request = self._requests.get(rid)
        if request is None:
            return
        code = str(data.get("code") or "rejected")
        if code == "unknown_session" and not self._ready.is_set():
            return  # raced a dying generation: the replay re-sends it
        self._finish(rid)
        request._fail(ServeRequestRejected(rid, code, str(data.get("message") or "")))

    def _on_stats(self, data: dict) -> None:
        """The worker's latest ``serve.stats``: occupancy, totals, the
        engine's counters and the card's memory, without the envelope."""
        self.stats = {k: v for k, v in data.items() if k not in _ENVELOPE}

    def _finish(self, rid: str) -> None:
        if self._requests.pop(rid, None) is not None:
            self.served += 1

    def abandon(self, rid: str) -> None:
        """Drop one request without failing or counting it, and free its
        worker lane with a fire-and-forget ``serve_cancel``."""
        if self._requests.pop(rid, None) is None:
            return
        client, sid_g = self._client, self._sid_g
        if client is not None and client.alive and not self._closed:
            task = asyncio.ensure_future(client.serve_cancel(sid_g, rid))
            self._bg_tasks.add(task)
            task.add_done_callback(
                lambda t: (self._bg_tasks.discard(t),
                           None if t.cancelled() else t.exception())
            )

    # -- supervision / reconnect --------------------------------------------

    async def _supervise(self) -> None:
        """Re-open the session on a fresh server when its channel dies."""
        while True:
            client = self._client
            if client is None:
                return
            try:
                await client.wait_dead()
            except asyncio.CancelledError:
                raise
            except BaseException as err:  # noqa: BLE001 - AgentError et al.
                death = err
            else:  # pragma: no cover - wait_dead only returns by raising
                death = AgentError("agent channel closed")
            if self._closed:
                return
            app_log.info("serving session %s lost its channel: %r", self.sid, death)
            if not await self._reconnect(death):
                return

    async def _reconnect(self, death: BaseException) -> bool:
        """Tear down, re-lease, re-open, replay — or fail every stream."""
        self._ready.clear()
        if self._client is not None:
            self._client.unwatch_serve(self._sid_g)
        try:
            await self.executor._discard_workers(self._conns)
        except Exception:  # noqa: BLE001 - teardown is best-effort
            pass
        failure: BaseException = death
        fault, _label = classify_error(death)
        if fault is FaultClass.TRANSIENT:
            policy = RetryPolicy()
            for attempt in range(self.retries + 1):
                if self._closed:
                    return False
                try:
                    await self._open_generation()
                except asyncio.CancelledError:
                    raise
                except (AgentError, TransportError, ServeError, OSError, ValueError) as err:
                    failure = err
                    if classify_error(err)[0] is not FaultClass.TRANSIENT:
                        break
                    if attempt < self.retries:
                        await asyncio.sleep(policy.delay(attempt))
                else:
                    self.reconnects += 1
                    app_log.info("serving session %s re-opened on generation %d; "
                                 "replaying %d requests", self.sid, self.generation,
                                 len(self._requests))
                    await self._replay_in_flight()
                    self._ready.set()
                    return True
        # Permanent refusal or retry budget spent: every stream fails with
        # the cause, and new requests are refused until the caller closes.
        self._failed = failure
        for rid, request in list(self._requests.items()):
            self._finish(rid)
            request._fail(ServeError(
                f"session {self.sid} died and could not be re-opened: {failure}"))
        self._ready.set()
        return False

    async def _replay_in_flight(self) -> None:
        """Re-send unfinished requests on the fresh generation; the splice
        in :meth:`_on_token` drops the already-delivered prefix."""
        for request in list(self._requests.values()):
            try:
                await self._send_request(request)
            except BaseException as err:  # noqa: BLE001 - fail just this one
                self._finish(request.rid)
                request._fail(ServeError(f"replay of {request.rid} failed: {err!r}"))

    # -- close --------------------------------------------------------------

    async def close(self, timeout: float = 30.0) -> dict:
        """Drain and close the session; returns the ``serve_closed`` event
        (``served``).  The worker finishes every admitted and queued request
        first; their tokens keep streaming meanwhile.  Idempotent."""
        if self._closed:
            return {"served": self.served}
        self._closed = True
        if self._supervisor is not None:
            self._supervisor.cancel()
        closed_event: dict = {"served": self.served}
        client, sid_g = self._client, self._sid_g
        if client is not None and self._failed is None:
            try:
                closed_event = await client.serve_close(sid_g, timeout)
            except (AgentError, TransportError, asyncio.TimeoutError) as err:
                app_log.debug("serve_close %s failed: %s", sid_g, err)
            client.unwatch_serve(sid_g)
        for rid, request in list(self._requests.items()):
            self._finish(rid)
            request._fail(ServeError(f"session {self.sid} closed"))
        self.executor._serve_handles.pop(self.sid, None)
        return closed_event
