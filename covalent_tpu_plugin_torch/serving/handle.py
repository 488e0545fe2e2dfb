"""Dispatcher side of the resident serving session: the one-session front.

Own copy of ``covalent_tpu_plugin/serving/handle.py``.  A
:class:`ServeHandle` multiplexes any number of concurrent callers onto ONE
resident serving session: the model factory is cloudpickled once, shipped
by digest, and opened on the executor's resident pool server
(``serve_open``); every :meth:`ServeHandle.request` is then one
``serve_request`` line on the held-open channel, and the response streams
back incrementally as ``serve.token`` records, so time to first token is
one decode chunk, not the end of a batch.  Reconnect and exactly-once
replay live in :class:`~.supervisor.SessionSupervisor`.

Refused until later items, with :class:`NotImplementedError`: a fleet
``Pool`` as the target and ``handoff`` (ROADMAP item 2c),
``attach_adapter``/``detach_adapter`` (slice 3's LoRA, then item 2c) and
``capture_profile`` (item 2c).
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any

import cloudpickle

from ..cache import bytes_digest
from .supervisor import ServeError, ServeRequest, ServeRequestRejected, SessionSupervisor

__all__ = ["ServeError", "ServeHandle", "ServeRequest", "ServeRequestRejected",
           "open_session"]

ITEM_2C = "ROADMAP item 2c (replica sets, recovery, handoff, serving metrics and tracing)"


class ServeHandle:
    """One resident serving session and every caller multiplexed onto it.

    Build it through :func:`open_session`.  All methods must run on the
    event loop the session was opened on.
    """

    def __init__(self, executor: Any, factory: Any, *, queue_max: int | None = None,
                 default_deadline_s: float | None = None,
                 stats_interval_s: float | None = None,
                 open_timeout_s: float | None = None, retries: int | None = None,
                 name: str = "") -> None:
        self.executor = executor
        self.factory = factory
        self.sid = name or f"serve-{uuid.uuid4().hex[:10]}"
        self._sup = SessionSupervisor(
            executor, sid=self.sid, queue_max=queue_max,
            default_deadline_s=default_deadline_s, stats_interval_s=stats_interval_s,
            open_timeout_s=open_timeout_s, retries=retries,
        )
        self._next_rid = 0
        #: bytes of the cloudpickled factory shipped to the worker
        self.payload_bytes = 0

    # -- supervisor views ---------------------------------------------------

    @property
    def supervisor(self) -> SessionSupervisor:
        return self._sup

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

    async def close(self, timeout: float = 30.0) -> dict:
        """Drain and close the session; returns the ``serve_closed`` event.
        Idempotent."""
        return await self._sup.close(timeout)

    # -- refused until later items --------------------------------------------

    async def handoff(self, reason: str = "planned") -> bool:
        raise NotImplementedError(f"handoff is not ported yet: it comes with {ITEM_2C}")

    async def attach_adapter(self, name: str, payload: Any = None, **_: Any) -> dict:
        raise NotImplementedError(
            "attach_adapter is not ported yet: it needs slice 3's LoRA, then " + ITEM_2C)

    async def detach_adapter(self, name: str, timeout_s: float = 30.0) -> dict:
        raise NotImplementedError(
            "detach_adapter is not ported yet: it needs slice 3's LoRA, then " + ITEM_2C)

    async def capture_profile(self, duration_s: float = 2.0) -> dict:
        raise NotImplementedError(f"capture_profile is not ported yet: it comes with {ITEM_2C}")


async def open_session(target: Any, factory: Any, *, queue_max: int | None = None,
                       default_deadline_s: float | None = None,
                       stats_interval_s: float | None = None,
                       open_timeout_s: float | None = None, retries: int | None = None,
                       name: str = "") -> ServeHandle:
    """Open a resident serving session; returns the live handle.

    ``target`` is a ``GPUExecutor`` whose resident runtime is on
    (``use_agent`` True, ``"auto"`` or ``"pool"``).  ``factory``
    is a zero-argument callable returning the serving engine (see
    ``models.serve.lm_engine_factory``); it is cloudpickled, shipped by
    digest and called ONCE inside the resident worker, where the model is
    built on the card.  Knob defaults come from ``COVALENT_TPU_SERVE_{
    QUEUE_MAX, DEADLINE_S, STATS_INTERVAL_S, OPEN_TIMEOUT_S, RETRIES}``.
    """
    if hasattr(target, "spec") and hasattr(target, "executor"):
        raise NotImplementedError(
            f"a fleet Pool as the session target is not ported yet: it comes with {ITEM_2C}")
    handle = ServeHandle(
        target, factory, queue_max=queue_max, default_deadline_s=default_deadline_s,
        stats_interval_s=stats_interval_s, open_timeout_s=open_timeout_s, retries=retries,
        name=name,
    )
    return await handle._open()
