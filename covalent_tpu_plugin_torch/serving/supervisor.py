"""One supervised serving session: open, stream, reconnect, replay.

Own copy of ``covalent_tpu_plugin/serving/supervisor.py``.  A
:class:`SessionSupervisor` owns ONE remote session at a time (a
*generation*): it leases the executor's worker, ships the factory payload
by digest, opens the session on the resident pool server, routes the
side-band records of its streams, and, when the channel dies, re-opens the
session on a fresh server and replays every in-flight request.  A replayed
stream restarts at token 0 and is spliced on the request's own high-water
mark (the cumulative ``idx`` of each chunk), so each caller sees every
token exactly once.  The request carries the splice state, not the
session, so any supervisor can take a request over mid-stream.

It does not decide which requests it gets: a :class:`~.handle.ServeHandle`
sends it all of its own, a :class:`~.replicas.ReplicaSet` routes among
several.  For a set it keeps its identity (``sid``, ``replica_of``) across
reconnects, fires ``on_change`` on every state change and completion and
``on_failed`` when it dies past its retry budget (the set then takes its
requests with :meth:`SessionSupervisor.detach_requests` and re-routes
them), feeds the fleet's health monitor (TTFT, faults, successes, queue
depth), answers a canary probe, lets a hedge put one request on two
supervisors (the first to deliver wins, the other arm is abandoned), runs
prefill-only passes (:meth:`SessionSupervisor.prefill_kv`), and sends a
request's KV bundle as a frame body, or by CAS path on a channel without
frames.

Crash recovery and warm handoff: with journaling on
(``COVALENT_TPU_JOURNAL_DIR``) it journals its remote binding
(``session``), each stream's intent (``stream``), token high-water mark
(``stream_hwm``) and end (``stream_done``), and its close
(``session_closed``), so a successor dispatcher re-binds a surviving
session (:meth:`SessionSupervisor.adopt`) and re-attaches its streams from
their marks (:meth:`SessionSupervisor.resume_stream`).
:meth:`SessionSupervisor.handoff` opens a replacement generation while the
old one still serves, then replays every in-flight request onto it; a
``serve.preempt`` record from the worker (its SIGTERM notice) starts one
(``COVALENT_TPU_SERVE_HANDOFF=0`` leaves it to the reconnect road).

Left out until later items, and not stubbed: the journal records of
adapters (slice 3), per-session serving metrics and tracing (ROADMAP item
2c.5) and fleet-pool pinning (2c.7).
"""

from __future__ import annotations

import asyncio
import os
import time
import uuid
from typing import Any, AsyncIterator, Callable

from ..agent import AgentClient, AgentError
from ..cache import bytes_digest, cas_path
from ..fleet import journal as journal_mod
from ..fleet.health import HEALTH
from ..resilience import FaultClass, RetryPolicy, classify_error
from ..transport.base import TransportError
from ..utils.log import app_log
from .metrics import SERVE_HANDOFFS_TOTAL

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
                 deadline_s: float, tenant: str = "") -> None:
        self.rid = rid
        self.prompt = prompt
        self.params = dict(params or {})
        self.deadline_s = float(deadline_s)
        self.tenant = tenant
        #: the caller's multi-turn session key (set by a replica set); it
        #: rides the request so a re-route keeps the pin
        self.sticky = ""
        #: (bundle bytes, sha256) attached by a disaggregated set: the
        #: decode replica admits from it instead of prefilling, on a replay
        #: or a re-route too
        self.kv: tuple[bytes, str] | None = None
        #: prefix-affinity key (digest of the prompt's reusable prefix)
        self.prefix_key = ""
        self.tokens: list[int] = []
        #: the stream offset this request resumed from (crash recovery):
        #: tokens ``[0, resumed_from)`` went to the caller through a dead
        #: dispatcher and are not collected here, so a splice compares a
        #: chunk's ``idx`` with ``resumed_from + len(tokens)``
        self.resumed_from = 0
        #: tokens the worker re-emitted from its history at the resume
        #: (what it decoded while no dispatcher listened)
        self.resumed_sent = 0
        #: a resume is in flight and its replay (the ``resumed`` chunk) has
        #: not arrived: live chunks past the high-water mark overtook it
        self.awaiting_replay = False
        self.error = ""
        #: sid of the supervisor whose stream fed the first fresh tokens.
        #: With a hedge, two supervisors hold this request: the first to
        #: deliver wins, the other arm is abandoned; its chunks splice to
        #: nothing, so the stream is the same either way.
        self.served_by = ""
        #: a hedge copy of this request was issued (at most one)
        self.hedged = False
        #: sid -> monotonic submit time of every supervisor holding it
        self.arms: dict[str, float] = {}
        self.t_submit = time.monotonic()
        self.t_first: float | None = None
        self.t_done: float | None = None
        #: the first submit to a supervisor (a replay keeps it)
        self.t_dispatched: float | None = None
        #: set when the first fresh tokens (or any terminal) land: the
        #: hedge watcher's TTFT deadline races it
        self.first_token = asyncio.Event()
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
            self.first_token.set()
        if done:
            self.t_done = time.monotonic()
            self.error = error
            self._chunks.put_nowait(None)
            self._done.set_result(list(self.tokens))
            self.first_token.set()

    def _fail(self, err: BaseException) -> None:
        if self._done.done():
            return
        self.t_done = time.monotonic()
        self._chunks.put_nowait(err)
        self._done.set_exception(err)
        self.first_token.set()


class SessionSupervisor:
    """One resident serving session, supervised for its whole life.

    Registers itself in the executor's ``_serve_handles`` (so
    ``executor.serve_sessions()`` sees it) while open.  All methods must run
    on the executor's event loop.  Knob defaults come from
    ``COVALENT_TPU_SERVE_{QUEUE_MAX, DEADLINE_S, STATS_INTERVAL_S,
    OPEN_TIMEOUT_S, RETRIES}``.

    ``on_change(supervisor)`` fires on every state change and request
    completion (a router's pump signal); ``on_failed(supervisor, error)``
    fires when the session dies past its retry budget: a front that
    returns True has taken the in-flight requests
    (:meth:`detach_requests`) and re-routes them; otherwise they fail with
    the cause.
    """

    def __init__(self, executor: Any, *, sid: str = "", queue_max: int | None = None,
                 default_deadline_s: float | None = None,
                 stats_interval_s: float | None = None,
                 open_timeout_s: float | None = None, retries: int | None = None,
                 replica_of: tuple[str, str] | None = None,
                 on_change: Callable[["SessionSupervisor"], None] | None = None,
                 on_failed: Callable[["SessionSupervisor", BaseException], bool] | None = None
                 ) -> None:
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
        #: (set name, replica id) when a replica set owns this session
        self.replica_of = replica_of
        self._on_change = on_change
        self._on_failed = on_failed
        self.slots = 0
        self.generation = 0
        self.served = 0
        self.reconnects = 0
        #: warm handoffs completed (a replacement opened before the old
        #: generation died)
        self.handoffs = 0
        #: replayed tokens below a stream's high-water mark that differ from
        #: the ones already delivered (dropped by the splice all the same),
        #: by road: this session's own reconnect, a request re-routed here
        #: from another replica, the losing arm of a hedge, a planned
        #: handoff, a handoff on a preemption notice
        self.replay_mismatches_by_road = {"reconnect": 0, "reroute": 0, "hedge": 0,
                                          "handoff": 0, "preempt": 0}
        #: the road this generation's replays came by: what opened it
        self._move_road = "reconnect"
        self._in_handoff = False
        self._handoff_task: asyncio.Task | None = None
        #: a worker's preemption notice starts a warm handoff unless
        #: COVALENT_TPU_SERVE_HANDOFF=0
        self._auto_handoff = os.environ.get("COVALENT_TPU_SERVE_HANDOFF", "1").strip().lower() \
            not in ("0", "off", "false", "no")
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

    @property
    def replay_mismatches(self) -> int:
        """Replayed tokens that differed from those delivered, all roads."""
        return sum(self.replay_mismatches_by_road.values())

    @property
    def routable(self) -> bool:
        """Whether a router may send NEW requests here now."""
        return self.state == "open"

    @property
    def alive(self) -> bool:
        """Open or reconnecting: a sticky pin to this session still holds."""
        return self.state in ("open", "reconnecting")

    @property
    def _health_group(self) -> str:
        """Peer group of the differential health score: the replica set."""
        return self.replica_of[0] if self.replica_of is not None else ""

    def status(self) -> dict[str, Any]:
        """This session's view for ``executor.serve_sessions()``."""
        view: dict[str, Any] = {
            "state": self.state, "address": self.address, "slots": self.slots,
            "generation": self.generation, "served": self.served,
            "in_flight": self.in_flight, "reconnects": self.reconnects,
            "handoffs": self.handoffs,
            "replay_mismatches": self.replay_mismatches,
            "replay_mismatches_by_road": dict(self.replay_mismatches_by_road),
            "age_s": round(time.time() - self.opened_at, 3) if self.opened_at else 0,
            "health_score": HEALTH.score(self.sid), "health_state": HEALTH.state(self.sid),
        }
        if self.replica_of is not None:
            view["replica_set"], view["replica"] = self.replica_of
        for field in ("busy", "queued", "tokens_per_s", "tokens_total", "kv_admits",
                      "kv_fallbacks", "prefills"):
            if field in self.stats:
                view[field] = self.stats[field]
        return view

    def _changed(self) -> None:
        if self._on_change is not None:
            try:
                self._on_change(self)
            except Exception:  # noqa: BLE001 - a router's hook is never fatal
                app_log.exception("serve on_change hook failed")

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

    async def adopt(self, *, client: AgentClient, conns: list, address: str, sid_g: str,
                    slots: int = 1, digest: str = "", payload_path: str = ""
                    ) -> "SessionSupervisor":
        """Bind to a remote session that survived its dispatcher, instead of
        opening one: the recovery road.  The worker held the session in
        orphan mode and a successor dispatcher adopted its channel; no
        lease, no staging, no ``serve_open``, and supervision (reconnect,
        replay, stats, close) takes over from here.  Journaled in-flight
        streams come back one by one through :meth:`resume_stream`."""
        self._digest = digest
        self._local_payload = payload_path
        self._client = client
        self._conns = list(conns)
        self._sid_g = sid_g
        self.address = address
        self.slots = int(slots or 1)
        self.generation = 1
        # later generations count on after the adopted one: "serve-x.g2"
        # goes on at g3, never back onto a live sid
        tail = sid_g.rsplit(".g", 1)
        try:
            self._gen_counter = int(tail[1]) + 1 if len(tail) == 2 else 1
        except ValueError:
            self._gen_counter = 1
        client.watch_serve(sid_g, self._sink)
        self.opened_at = time.time()
        self.executor._serve_handles[self.sid] = self
        self._journal_binding()
        # a re-adopted session starts from a neutral health score: the
        # journal keeps no scores, and a recovered fleet must not inherit
        # its predecessor's quarantines
        HEALTH.neutral(self.sid, group=self._health_group)
        self._supervisor = asyncio.ensure_future(self._supervise())
        self._ready.set()
        return self

    async def resume_stream(self, request: ServeRequest) -> str:
        """Re-attach one journaled in-flight stream to this session.

        ``request.resumed_from`` holds the journaled high-water mark; the
        worker re-emits the stream's history from there (the splice of
        :meth:`_on_token` drops any overlap) and live chunks follow.  The
        adopted session decodes on meanwhile, so live chunks past the mark
        can arrive before the replay; they are dropped until it arrives,
        since it re-emits them.
        Returns the worker's answer: ``streaming``, ``done``, ``pending``,
        ``unknown`` (the worker never saw it: it is sent again from the
        journaled prompt, from token 0) or ``refused`` (this dispatcher
        was fenced as stale: the request fails)."""
        if self._client is None:
            raise ServeError(f"session {self.sid} has no live runtime")
        # registered before the wire write: re-emitted history races the ack
        self._requests[request.rid] = request
        request.awaiting_replay = True
        request.arms[self.sid] = time.monotonic()
        if request.t_dispatched is None:
            request.t_dispatched = time.monotonic()
        try:
            ack = await self._client.serve_resume(self._sid_g, request.rid,
                                                  request.resumed_from)
        except BaseException:
            self._requests.pop(request.rid, None)
            request.arms.pop(self.sid, None)
            request.awaiting_replay = False
            raise
        state = str(ack.get("state") or "")
        request.resumed_sent = int(ack.get("sent") or 0)
        if state not in ("streaming", "done"):
            request.awaiting_replay = False  # no replay comes
        if state == "refused":
            self._finish(request.rid, "error")
            request._fail(ServeError(f"resume of {request.rid} refused: the worker fenced "
                                     "this dispatcher as stale"))
        elif state == "unknown":
            # the dead dispatcher journaled the intent but not the wire
            # write: a fresh stream
            request.resumed_from = 0
            await self._send_request(request)
        return state

    async def _open_generation(self) -> None:
        """Open one remote session generation on a freshly leased worker
        and bind to it."""
        self._adopt(await self._dial_generation())

    async def _dial_generation(self) -> dict:
        """Lease, stage and open one generation WITHOUT touching the
        current binding; returns it for :meth:`_adopt`.  The split is what
        makes a warm handoff: the old generation streams on while the
        replacement opens.  A failure discards whatever channels the
        attempt dialed, so a retry starts a fresh pool server instead of
        reusing the broken one."""
        dialed: list = []
        try:
            return await asyncio.wait_for(self._dial_generation_on(dialed),
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

    def _adopt(self, binding: dict) -> None:
        self._client = binding["client"]
        self._conns = binding["conns"]
        self._sid_g = binding["sid_g"]
        self.address = binding["address"]
        self.slots = binding["slots"]
        self.generation += 1
        self._journal_binding()

    def _journal_binding(self) -> None:
        """Journal this session's remote binding: what a successor
        dispatcher needs to find the session again, or re-open it."""
        journal_mod.record(
            "session", sid=self.sid, sid_g=self._sid_g, address=self.address,
            digest=self._digest, payload=self._local_payload, slots=self.slots,
            queue_max=self.queue_max, default_deadline_s=self.default_deadline_s,
            stats_interval_s=self.stats_interval_s,
            replica_of=list(self.replica_of) if self.replica_of else None, sync=True,
        )

    async def _dial_generation_on(self, dialed: list) -> dict:
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

    async def submit(self, request: ServeRequest, *, fail_on_error: bool = True,
                     wait_ready: bool = True) -> ServeRequest:
        """Assign one request to this session and write its wire message.

        Fire-and-stream: tokens arrive on the side-band.  By default it
        waits out a reconnect in progress; ``wait_ready=False`` refuses a
        session that is not routable at once, so a router does not hold a
        whole batch behind one replica's reconnect.  A failed write raises,
        and fails the request unless ``fail_on_error=False`` (a router then
        re-routes it).
        """
        try:
            if wait_ready:
                await self._await_ready()
            elif not self.routable:
                raise ServeError(f"session {self.sid} is not routable ({self.state})")
            if request.t_dispatched is None:
                request.t_dispatched = time.monotonic()
            self._requests[request.rid] = request
            request.arms[self.sid] = time.monotonic()
            # write-ahead: the intent is durable before the wire write, so a
            # dispatcher that dies between the two replays the request
            journal_mod.record(
                "stream", sid=self.sid, rid=request.rid, prompt=list(request.prompt),
                params=request.params, deadline_s=request.deadline_s,
                tenant=request.tenant, resumed_from=request.resumed_from,
            )
            try:
                await self._send_request(request)
            except BaseException:
                self._requests.pop(request.rid, None)
                request.arms.pop(self.sid, None)
                raise
        except BaseException as err:
            if fail_on_error:
                request._fail(err if isinstance(err, ServeError)
                              else ServeError(f"request submit failed: {err!r}"))
            raise
        return request

    def detach_requests(self) -> list[ServeRequest]:
        """Hand every in-flight request back without failing or counting
        it: the drain-on-death road.  A replica set re-routes them onto
        survivors, and their own high-water marks keep the splice
        exactly-once across the move."""
        detached = list(self._requests.values())
        self._requests.clear()
        for request in detached:
            request.arms.pop(self.sid, None)
        return detached

    async def _send_request(self, request: ServeRequest) -> None:
        assert self._client is not None
        kv_bytes: bytes | None = None
        kv_digest = kv_path = ""
        if request.kv is not None:
            kv_bytes, kv_digest = request.kv
            if not self._client.frames_active:
                # Without frames the bundle would pay base64 on every send
                # and replay: ship it once into the worker's CAS and name
                # it by path.  A failed staging drops the KV: the worker's
                # full prefill keeps the stream right.
                try:
                    kv_path = await self._stage_kv(kv_bytes, kv_digest)
                    kv_bytes = None
                except Exception as err:  # noqa: BLE001 - degrade
                    app_log.debug("KV staging for %s failed (%s); degrading to a full "
                                  "prefill", request.rid, err)
                    kv_bytes, kv_digest = None, ""
        await self._client.serve_request(self._sid_g, request.rid, request.prompt,
                                         params=request.params,
                                         deadline_s=request.deadline_s, kv_bytes=kv_bytes,
                                         kv_digest=kv_digest, kv_path=kv_path)

    async def _stage_kv(self, data: bytes, digest: str) -> str:
        """Ship one KV bundle into this session's worker CAS; returns its
        remote path.  Content-addressed: an identical bundle (a repeated
        prompt) is already there and costs nothing."""
        executor = self.executor
        local = os.path.join(executor.cache_dir, "cas", f"{digest}.kv")
        if not os.path.exists(local):
            os.makedirs(os.path.dirname(local), exist_ok=True)
            await asyncio.to_thread(executor._write_payload_file, local, data)
        key = executor._pool_key(self.address)
        remote = cas_path(executor.remote_cache, digest, ".kv")
        await executor._cas.ensure(key, self._conns[0], digest, local, remote)
        return remote

    async def prefill_kv(self, prompt, params: dict | None = None, rid: str = "",
                         timeout_s: float = 60.0) -> dict:
        """Run a prefill-only pass on this session's engine; returns the
        ``serve_kv`` event (the bundle under ``data_bytes``, the worker's
        sha256 of it under ``digest``).  The caller checks the digest of
        the bytes it received and decides to degrade."""
        await self._await_ready()
        client = self._client
        if client is None:
            raise ServeError(f"session {self.sid} has no live runtime")
        rid = rid or f"kv-{uuid.uuid4().hex[:8]}"
        return await client.serve_prefill(self._sid_g, rid, [int(t) for t in prompt],
                                          params=params, timeout=timeout_s)

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
        elif kind == "serve.preempt":
            self._on_preempt(data)

    def _on_preempt(self, data: dict) -> None:
        """The worker announced a preemption notice (its SIGTERM): start a
        warm handoff now, inside the old worker's grace window."""
        app_log.info("session %s: preemption notice from %s (%s)", self.sid, self.address,
                     data.get("reason") or "")
        if not self._auto_handoff or self._closed or self._in_handoff:
            return

        async def run() -> None:
            try:
                await self.handoff(reason="preempt_notice")
            except Exception:  # noqa: BLE001 - the reconnect road still guards
                app_log.exception("preemption-notice handoff of %s failed", self.sid)

        # held, so the task is not collected mid-await
        self._handoff_task = asyncio.ensure_future(run())
        self._handoff_task.add_done_callback(lambda _t: setattr(self, "_handoff_task", None))

    def _replay_road(self, request: ServeRequest) -> str:
        """Which road a replayed chunk came by: this session's reconnect, a
        re-route from the replica that first fed the request, or the
        losing arm of a hedge."""
        if request.served_by in ("", self.sid):
            return self._move_road
        return "hedge" if request.hedged else "reroute"

    def _on_token(self, data: dict) -> None:
        rid = str(data.get("rid") or "")
        request = self._requests.get(rid)
        if request is None:
            return
        idx = int(data.get("idx") or 0)
        tokens = list(data.get("tokens") or ())
        base = request.resumed_from
        have = base + len(request.tokens)
        if data.get("resumed"):
            request.awaiting_replay = False
        elif request.awaiting_replay and idx > have:
            return  # a live chunk ahead of the resume's replay, which re-emits it
        if idx > have:
            # A chunk went missing: exactly-once is broken for this stream;
            # fail it loudly rather than splice around a hole.
            self._finish(rid, "error")
            request._fail(ServeError(f"token stream gap for {rid}: chunk starts at {idx}, "
                                     f"have {have}"))
            return
        # Replay splice: a re-opened session (or another replica, or a
        # hedge's second arm) streams from idx 0; what is at or below the
        # high-water mark is a duplicate and drops here.  A replay decoded
        # in another batch may flip a near-tie there: the caller keeps what
        # it was given, and the flip is counted by road.
        replayed = tokens[:have - idx]
        # only what this dispatcher delivered (from ``base`` on) is compared
        lo = max(idx, base)
        differ = sum(a != b for a, b in zip(replayed[lo - idx:], request.tokens[lo - base:]))
        if differ:
            road = self._replay_road(request)
            self.replay_mismatches_by_road[road] += differ
            app_log.warning("session %s: %s replay of %s differs from the delivered stream "
                            "at %d of %d tokens below its high-water mark", self.sid, road,
                            rid, differ, len(replayed))
        fresh = tokens[have - idx:]
        first = request.t_first is None and bool(fresh)
        if first and not request.served_by:
            request.served_by = self.sid  # the hedge's winner, when there is one
        done = bool(data.get("done"))
        error = str(data.get("error") or "")
        hedge_loser = bool(request.hedged and request.served_by
                           and request.served_by != self.sid)
        if hedge_loser and error:
            # The losing arm's error (its cancel's ack, or its death) must
            # not reach the shared request: the winner owns its terminal.
            self.abandon(rid)
            return
        request._feed(fresh, done, error=error)
        if fresh:
            # the stream's durable high-water mark: a successor dispatcher
            # resumes it from here, exactly once
            journal_mod.record("stream_hwm", sid=self.sid, rid=rid,
                               hwm=request.resumed_from + len(request.tokens))
        if first and request.ttft_s is not None:
            # The straggler signal: TTFT against the sibling replicas.  A
            # hedge's arm is measured from its own dispatch.
            latency = request.ttft_s
            sent = request.arms.get(self.sid)
            if request.hedged and sent is not None and request.t_first is not None:
                latency = max(0.0, request.t_first - sent)
            HEALTH.record_latency(self.sid, latency, group=self._health_group)
        if done:
            if hedge_loser:
                # finished before its cancel landed: the chunks spliced as
                # duplicates, and the outcome is the winner's to count
                self.abandon(rid)
                return
            if error and error != "deadline_exceeded":
                HEALTH.record_fault(self.sid, label=error[:40], group=self._health_group)
            elif not error:
                HEALTH.record_success(self.sid, group=self._health_group)
            self._finish(rid, "ok" if not error else (
                "deadline" if error == "deadline_exceeded" else "error"))

    def _on_reject(self, data: dict) -> None:
        rid = str(data.get("rid") or "")
        request = self._requests.get(rid)
        if request is None:
            return
        code = str(data.get("code") or "rejected")
        if code == "unknown_session" and not self._ready.is_set():
            return  # raced a dying generation: the replay re-sends it
        HEALTH.record_fault(self.sid, label=code, group=self._health_group)
        if request.hedged and request.served_by != self.sid and (
                request.served_by or request.arms.keys() - {self.sid}):
            # One arm of a hedge refused (the copy shed under the load that
            # triggered the hedge): the other arm still owns the request.
            self.abandon(rid)
            return
        self._finish(rid, "rejected")
        request._fail(ServeRequestRejected(rid, code, str(data.get("message") or "")))

    def _on_stats(self, data: dict) -> None:
        """The worker's latest ``serve.stats``: occupancy, totals, the
        engine's counters and the card's memory, without the envelope."""
        self.stats = {k: v for k, v in data.items() if k not in _ENVELOPE}
        HEALTH.record_queue_depth(self.sid, float(self.stats.get("queued") or 0),
                                  group=self._health_group)

    def _finish(self, rid: str, outcome: str) -> None:
        request = self._requests.pop(rid, None)
        if request is not None:
            request.arms.pop(self.sid, None)
            self.served += 1
            journal_mod.record("stream_done", sid=self.sid, rid=rid, outcome=outcome, sync=True)
            self._changed()

    def abandon(self, rid: str) -> None:
        """Drop one request's assignment without failing or counting it,
        and free its worker lane with a fire-and-forget ``serve_cancel``:
        the caller gave it up, or it lives on under a hedge's winner."""
        request = self._requests.pop(rid, None)
        if request is None:
            return
        request.arms.pop(self.sid, None)
        # a successor dispatcher must not resume the dead arm
        journal_mod.record("stream_done", sid=self.sid, rid=rid, outcome="hedge_abandoned")
        client, sid_g = self._client, self._sid_g
        if client is not None and client.alive and not self._closed:
            task = asyncio.ensure_future(client.serve_cancel(sid_g, rid))
            self._bg_tasks.add(task)
            task.add_done_callback(
                lambda t: (self._bg_tasks.discard(t),
                           None if t.cancelled() else t.exception())
            )
        self._changed()

    async def canary(self, timeout: float = 10.0) -> bool:
        """The probe that readmits a quarantined replica: one ping round
        trip, no model work, no lane taken."""
        client = self._client
        if client is None or not client.alive or self.state != "open":
            return False
        try:
            await client.ping(timeout=timeout)
            return True
        except (AgentError, TransportError, asyncio.TimeoutError, OSError):
            return False

    # -- warm handoff ---------------------------------------------------------

    async def handoff(self, reason: str = "planned") -> bool:
        """Drain-and-reopen: move this session to a fresh generation with
        no token lost or repeated.

        The replacement is leased, staged and opened while the old
        generation still serves; then every in-flight request is sent again
        on it, and its streams, which restart at token 0, are spliced on
        each request's high-water mark.  The old generation's copies of the
        requests are cancelled and it is closed, best-effort (it is about to
        die anyway); the reference lets its close drain them.  Returns True when
        the session runs on the new generation; False when no handoff was
        possible (closed, failed, already moving, or the replacement did
        not open: the reconnect road still guards the old generation).
        ``reason`` ``"preempt_notice"`` counts the replays' mismatches
        under the ``preempt`` road, any other under ``handoff``.
        """
        if self._closed or self._failed is not None or self._in_handoff \
                or not self._ready.is_set():
            return False
        self._in_handoff = True
        try:
            old_client, old_sid = self._client, self._sid_g
            old_conns = list(self._conns)
            try:
                binding = await self._dial_generation()
            except asyncio.CancelledError:
                raise
            except BaseException as err:  # noqa: BLE001 - degrade, not fail
                SERVE_HANDOFFS_TOTAL.labels(outcome="failed").inc()
                app_log.warning("warm handoff of %s failed (%s); the reconnect road "
                                "recovers when the old worker dies", self.sid, err)
                return False
            # stop the old generation's feed before the replay, so the
            # splice sees one stream at a time
            self._adopt(binding)
            self._move_road = "preempt" if reason == "preempt_notice" else "handoff"
            if old_client is not None:
                old_client.unwatch_serve(old_sid)
            await self._replay_in_flight()
            self.handoffs += 1
            SERVE_HANDOFFS_TOTAL.labels(outcome="ok").inc()
            app_log.info("session %s handed off (%s) to generation %d; replayed %d requests",
                         self.sid, reason, self.generation, len(self._requests))
            if old_client is not None and old_client.alive:
                try:
                    # the old generation's streams are duplicates now: cancel
                    # them, or its close drains every one of them (beside
                    # the replays, on the same worker when the replacement
                    # landed there)
                    for rid in list(self._requests):
                        await old_client.serve_cancel(old_sid, rid)
                    await old_client.serve_close(old_sid, timeout=5.0)
                except (AgentError, TransportError, asyncio.TimeoutError) as err:
                    app_log.debug("post-handoff close of %s failed: %s", old_sid, err)
            # the old channels leave the pool unless the replacement landed
            # on the very same ones
            shared = {id(c) for c in self._conns}
            leftovers = [c for c in old_conns if id(c) not in shared]
            if leftovers:
                try:
                    await self.executor._discard_workers(leftovers)
                except Exception:  # noqa: BLE001 - teardown is best-effort
                    pass
            self._changed()
            return True
        finally:
            self._in_handoff = False

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
            if self._client is not client:
                continue  # a handoff moved the session: the retired channel died
            if self._in_handoff:
                # the old worker died mid-handoff: the handoff's replay owns
                # the streams; then watch the new channel
                while self._in_handoff and not self._closed:
                    await asyncio.sleep(0.05)
                if self._client is not client:
                    continue
            app_log.info("serving session %s lost its channel: %r", self.sid, death)
            if not await self._reconnect(death):
                return

    async def _reconnect(self, death: BaseException) -> bool:
        """Tear down, re-lease, re-open, replay — or hand the streams to
        the front (``on_failed``), or fail every one."""
        self._ready.clear()
        self._changed()
        if self._client is not None:
            self._client.unwatch_serve(self._sid_g)
        try:
            await self.executor._discard_workers(self._conns)
        except Exception:  # noqa: BLE001 - teardown is best-effort
            pass
        failure: BaseException = death
        fault, label = classify_error(death)
        HEALTH.record_fault(self.sid, label=label or fault.name.lower(),
                            group=self._health_group)
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
                    self._move_road = "reconnect"
                    app_log.info("serving session %s re-opened on generation %d; "
                                 "replaying %d requests", self.sid, self.generation,
                                 len(self._requests))
                    await self._replay_in_flight()
                    self._ready.set()
                    self._changed()
                    return True
        # Permanent refusal or retry budget spent: the front may take the
        # in-flight requests (a replica set drains them onto survivors);
        # otherwise every stream fails with the cause.  New requests are
        # refused either way until the caller closes.
        self._failed = failure
        handled = False
        if self._on_failed is not None:
            try:
                handled = bool(self._on_failed(self, failure))
            except Exception:  # noqa: BLE001 - a router's hook is never fatal
                app_log.exception("serve on_failed hook failed")
        if not handled:
            for rid, request in list(self._requests.items()):
                self._finish(rid, "error")
                request._fail(ServeError(
                    f"session {self.sid} died and could not be re-opened: {failure}"))
        self._ready.set()
        HEALTH.drop(self.sid)
        self._changed()
        return False

    async def _replay_in_flight(self) -> None:
        """Re-send unfinished requests on the fresh generation; the splice
        in :meth:`_on_token` drops the already-delivered prefix."""
        for request in list(self._requests.values()):
            try:
                await self._send_request(request)
            except BaseException as err:  # noqa: BLE001 - fail just this one
                self._finish(request.rid, "error")
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
            self._finish(rid, "error")
            request._fail(ServeError(f"session {self.sid} closed"))
        self.executor._serve_handles.pop(self.sid, None)
        journal_mod.record("session_closed", sid=self.sid, sync=True)
        HEALTH.drop(self.sid)
        self._changed()
        return closed_event
