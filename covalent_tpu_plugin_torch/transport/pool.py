"""Connection pooling across electrons (own copy of
``covalent_tpu_plugin/transport/pool.py``).

The reference opens a fresh SSH connection per ``run()``
(``covalent_ssh_plugin/ssh.py:497``) and closes it at the end
(``ssh.py:585-587``), paying the handshake on every electron.  The pool
keeps one live transport per key (``{transport}:{address}``), dials it
once under a single-flight lock (optionally behind a circuit breaker), and
closes them all at executor teardown.  Each dial is a ``pool.connect``
span; ``covalent_tpu_pool_acquires_total`` counts hits and misses and
``covalent_tpu_pool_size`` the live transports.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable

from ..obs import events as obs_events
from ..obs.metrics import REGISTRY
from ..obs.trace import Span
from .base import Transport

_POOL_ACQUIRES = REGISTRY.counter(
    "covalent_tpu_pool_acquires_total",
    "Transport pool lookups by result (hit = reused channel, "
    "miss = fresh dial)",
    ("result",),
)
_POOL_SIZE = REGISTRY.gauge(
    "covalent_tpu_pool_size",
    "Live transports currently held by pools in this process",
)


class TransportPool:
    """Keyed cache of live transports with single-flight connection setup."""

    def __init__(self) -> None:
        self._transports: dict[str, Transport] = {}
        self._locks: dict[str, asyncio.Lock] = {}
        self._guard = asyncio.Lock()

    async def acquire(
        self,
        key: str,
        factory: Callable[[], Awaitable[Transport]],
        gate=None,
    ) -> Transport:
        """Return the pooled transport for ``key``, creating it via
        ``factory`` exactly once even under concurrent electron fan-out.

        ``gate`` is an optional circuit breaker (duck-typed: ``check()`` /
        ``record_success()`` / ``record_failure()``, see resilience.py)
        consulted *before* a fresh dial: a quarantined host fails fast with
        ``CircuitOpenError`` instead of burning the full connect-retry
        envelope.  A pooled hit bypasses the gate — an already-live channel
        is itself evidence the host works (a broken one gets discarded, and
        its redial is gated).
        """
        async with self._guard:
            lock = self._locks.setdefault(key, asyncio.Lock())
        async with lock:
            transport = self._transports.get(key)
            if transport is not None:
                _POOL_ACQUIRES.labels(result="hit").inc()
                return transport
            if gate is not None:
                gate.check()
            _POOL_ACQUIRES.labels(result="miss").inc()
            # The span surfaces what pooling saves: its histogram is the
            # per-dial handshake cost that hits only on a miss.
            try:
                with Span("pool.connect", {"key": key}):
                    transport = await factory()
            except BaseException:
                if gate is not None:
                    gate.record_failure()
                raise
            if gate is not None:
                gate.record_success()
            self._transports[key] = transport
            _POOL_SIZE.inc()
            return transport

    async def discard(self, key: str, only=None) -> bool:
        """Drop (and close) a broken transport so the next acquire redials.

        ``only`` (an iterable of transports) scopes the discard to the
        channels the caller actually observed failing: under concurrent
        fan-out, electron A's teardown must not close the FRESH channel
        electron B just redialed under the same key — that cascade turns
        one injected fault into N spurious launch failures.  Returns
        whether a transport was discarded.
        """
        transport = self._transports.get(key)
        if transport is None:
            return False
        if only is not None and not any(transport is t for t in only):
            return False
        self._transports.pop(key, None)
        _POOL_SIZE.dec()
        obs_events.emit("pool.discard", key=key)
        await transport.close()
        return True

    async def close_all(self) -> None:
        transports = list(self._transports.values())
        self._transports.clear()
        _POOL_SIZE.dec(len(transports))
        await asyncio.gather(*(t.close() for t in transports), return_exceptions=True)

    def has(self, key: str) -> bool:
        """Whether a live transport is currently pooled under ``key``."""
        return key in self._transports

    def __len__(self) -> int:
        return len(self._transports)

    async def __aenter__(self) -> "TransportPool":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close_all()
