"""Dispatcher side of the resident serving session: the one-session front.

Own copy of ``covalent_tpu_plugin/serving/handle.py``.  A
:class:`ServeHandle` multiplexes any number of concurrent callers onto ONE
resident serving session: the model factory is cloudpickled once, shipped
by digest, and opened on the executor's resident runtime (``serve_open``:
in the pool server, or in a ``--serve-child`` the native agent forks);
every :meth:`ServeHandle.request` is then one
``serve_request`` line on the held-open channel, and the response streams
back incrementally as ``serve.token`` records, so time to first token is
one decode chunk, not the end of a batch.  Reconnect and exactly-once
replay, the warm handoff (:meth:`ServeHandle.handoff`) and the journal
records crash recovery reads live in :class:`~.supervisor.SessionSupervisor`.

Several sessions of one factory behind a router are a
:class:`~.replicas.ReplicaSet` (``open_replica_set``); split into prefill
and decode tiers, a :class:`~.disagg.DisaggregatedSet`.

The target is a ``GPUExecutor`` or a fleet ``Pool`` (:mod:`..fleet.pools`):
a session opened on a pool pins one of its capacity slots for its life,
and :meth:`ServeHandle.handoff` may move it to another pool.
:meth:`ServeHandle.capture_profile` traces the runtime that holds the
model while it serves.  :meth:`ServeHandle.attach_adapter` splices a named
LoRA adapter into the running session (the engine's adapter bank) and
:meth:`ServeHandle.detach_adapter` retires one.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any

import cloudpickle

from ..cache import bytes_digest
from .supervisor import (
    ServeError,
    ServeRequest,
    ServeRequestRejected,
    SessionSupervisor,
    split_target,
)

__all__ = ["ServeError", "ServeHandle", "ServeRequest", "ServeRequestRejected",
           "open_session"]

class ServeHandle:
    """One resident serving session and every caller multiplexed onto it.

    Build it through :func:`open_session`.  All methods must run on the
    event loop the session was opened on.
    """

    def __init__(self, executor: Any, factory: Any, *, queue_max: int | None = None,
                 default_deadline_s: float | None = None,
                 stats_interval_s: float | None = None,
                 open_timeout_s: float | None = None, retries: int | None = None,
                 name: str = "", pool: Any = None) -> None:
        self.factory = factory
        self.sid = name or f"serve-{uuid.uuid4().hex[:10]}"
        self._sup = SessionSupervisor(
            executor, sid=self.sid, queue_max=queue_max,
            default_deadline_s=default_deadline_s, stats_interval_s=stats_interval_s,
            open_timeout_s=open_timeout_s, retries=retries, pool=pool,
        )
        self._next_rid = 0
        #: bytes of the cloudpickled factory shipped to the worker
        self.payload_bytes = 0

    # -- supervisor views ---------------------------------------------------

    @property
    def supervisor(self) -> SessionSupervisor:
        return self._sup

    @property
    def executor(self) -> Any:
        """The executor whose runtime hosts the session now (a handoff to
        another target changes it)."""
        return self._sup.executor

    @property
    def pool(self) -> Any:
        """The fleet Pool whose slot the session pins, or None."""
        return self._sup._pool

    @property
    def state(self) -> str:
        return self._sup.state

    @property
    def in_flight(self) -> int:
        return self._sup.in_flight

    @property
    def slots(self) -> int:
        return self._sup.slots

    @property
    def generation(self) -> int:
        return self._sup.generation

    @property
    def served(self) -> int:
        return self._sup.served

    @property
    def reconnects(self) -> int:
        return self._sup.reconnects

    @property
    def handoffs(self) -> int:
        return self._sup.handoffs

    async def handoff(self, reason: str = "planned", target: Any = None) -> bool:
        """Warm drain-and-reopen onto a fresh generation (planned churn):
        the replacement opens before the old one is retired, and every
        in-flight stream is spliced exactly once across the move.
        ``target`` (a fleet ``Pool`` or an executor) moves the session
        there."""
        return await self._sup.handoff(reason=reason, target=target)

    @property
    def replay_mismatches(self) -> int:
        """Replayed tokens that differed from those already delivered."""
        return self._sup.replay_mismatches

    @property
    def stats(self) -> dict[str, Any]:
        """The worker's latest ``serve.stats`` (the last one, after close)."""
        return self._sup.stats

    # -- open / requests / close --------------------------------------------

    async def _open(self) -> "ServeHandle":
        payload = await asyncio.to_thread(cloudpickle.dumps, self.factory)
        self.payload_bytes = len(payload)
        await self._sup.open(payload, bytes_digest(payload))
        return self

    async def request(self, prompt, params: dict | None = None,
                      deadline_s: float | None = None) -> ServeRequest:
        """Submit one request; returns its :class:`ServeRequest` stream.

        Fire-and-stream: this only writes the ``serve_request`` line (after
        any reconnect in progress).  ``params`` may carry per-request
        ``max_new_tokens``; sampling is session-wide.
        """
        self._next_rid += 1
        request = ServeRequest(
            f"{self.sid}-r{self._next_rid}", [int(t) for t in prompt], params,
            self._sup.default_deadline_s if deadline_s is None else deadline_s,
        )
        return await self._sup.submit(request)

    async def capture_profile(self, duration_s: float = 2.0) -> dict:
        """Trace this session's resident runtime with ``torch.profiler`` for
        ``duration_s`` while it serves; returns the digest-checked
        artifact's ``{sid, duration_s, path, digest, bytes}`` (see
        :meth:`~.supervisor.SessionSupervisor.capture_profile`)."""
        return await self._sup.capture_profile(duration_s)

    async def close(self, timeout: float = 30.0) -> dict:
        """Drain and close the session; returns the ``serve_closed`` event.
        Idempotent."""
        return await self._sup.close(timeout)

    # -- the multi-adapter bank --------------------------------------------------

    @property
    def adapters(self) -> dict[str, str]:
        """name -> content digest of every adapter attached here."""
        return self._sup.adapters

    async def attach_adapter(self, name: str, payload: Any = None, *, path: str = "",
                             digest: str = "", rank: int | None = None, alpha: float = 16.0,
                             timeout_s: float | None = None) -> dict:
        """Splice a named LoRA adapter into the running session (a re-attach
        of a live name is a hot swap: requests in flight finish on the old
        generation).  See :meth:`~.supervisor.SessionSupervisor.attach_adapter`."""
        return await self._sup.attach_adapter(name, payload, path=path, digest=digest,
                                              rank=rank, alpha=alpha, timeout_s=timeout_s)

    async def detach_adapter(self, name: str, timeout_s: float = 30.0) -> dict:
        """Retire a named adapter of the running session."""
        return await self._sup.detach_adapter(name, timeout_s=timeout_s)


async def open_session(target: Any, factory: Any, *, queue_max: int | None = None,
                       default_deadline_s: float | None = None,
                       stats_interval_s: float | None = None,
                       open_timeout_s: float | None = None, retries: int | None = None,
                       name: str = "") -> ServeHandle:
    """Open a resident serving session; returns the live handle.

    ``target`` is a ``GPUExecutor`` whose resident runtime is on
    (``use_agent`` True, ``"auto"``, ``"pool"`` or ``"native"``), or a
    fleet ``Pool`` (the session then pins one of the pool's capacity slots
    for its life, released when it closes).  ``factory``
    is a zero-argument callable returning the serving engine (see
    ``models.serve.lm_engine_factory``); it is cloudpickled, shipped by
    digest and called ONCE inside the resident worker, where the model is
    built on the card.  Knob defaults come from ``COVALENT_TPU_SERVE_{
    QUEUE_MAX, DEADLINE_S, STATS_INTERVAL_S, OPEN_TIMEOUT_S, RETRIES}``.
    """
    executor, pool = split_target(target)
    handle = ServeHandle(
        executor, factory, queue_max=queue_max, default_deadline_s=default_deadline_s,
        stats_interval_s=stats_interval_s, open_timeout_s=open_timeout_s, retries=retries,
        name=name, pool=pool,
    )
    return await handle._open()
