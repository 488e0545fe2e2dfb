"""Fault classification, retry backoff and circuit breakers (own copy of
the part of ``covalent_tpu_plugin/resilience.py`` the serving supervisor,
RPC dispatch and the SSH dial use).

* :func:`classify_error` — transient (channel death, transport faults,
  connection errors, an open circuit) against permanent (anything tagged
  so, SSH authentication and host-key verdicts, filesystem errors,
  anything unrecognized).
* :func:`tag_fault` — an exception's own classification: a dead resident
  worker or dropped channel under an RPC electron is transient
  (``rpc_channel``); a digest mismatch at registration is permanent
  (``rpc_digest_mismatch``).
* :class:`RetryPolicy` — exponential backoff with full jitter.
* :class:`CircuitBreaker` / :class:`CircuitBreakerRegistry` — per-address
  quarantine of a worker that keeps failing its dial or pre-flight: the
  transport pool consults it before a fresh dial, so a dead host fails
  fast (:class:`CircuitOpenError`) instead of paying the whole connect
  retry envelope on every electron.

Task retries, deadlines and the retry counters are not ported yet (ROADMAP
Queue 1): an electron that meets a transient fault fails, with the
classification on its error.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

from .obs import events as obs_events
from .obs.metrics import REGISTRY
from .transport.base import TransportError

__all__ = [
    "CircuitBreaker",
    "CircuitBreakerRegistry",
    "CircuitOpenError",
    "CircuitState",
    "FaultClass",
    "RetryPolicy",
    "classify_error",
    "tag_fault",
]

_CIRCUIT_STATE = REGISTRY.gauge(
    "covalent_tpu_circuit_state",
    "Per-worker circuit state (0=closed, 1=half_open, 2=open)",
    ("address",),
)
_CIRCUIT_TRANSITIONS = REGISTRY.counter(
    "covalent_tpu_circuit_transitions_total",
    "Circuit-breaker state transitions by destination state",
    ("to",),
)

#: SSH verdicts no retry can change, by exception class name (matched by
#: name so that classifying needs neither ``cryptography`` nor asyncssh):
#: a refused credential and a host key that fails its pin.
_SSH_AUTH_ERRORS = ("MiniSSHAuthError", "PermissionDenied")
_SSH_HOST_KEY_ERRORS = ("MiniSSHHostKeyError", "HostKeyNotVerifiable")


class FaultClass(str, Enum):
    """Whether a failure is worth retrying."""

    TRANSIENT = "transient"   # infrastructure: retry may succeed
    PERMANENT = "permanent"   # deterministic: retrying re-runs the failure


def classify_error(error: BaseException) -> tuple[FaultClass, str]:
    """``(fault class, reason label)`` for one dispatch-layer exception.

    Exceptions may classify themselves with ``fault_label`` /
    ``fault_transient`` attributes (an admission shed is PERMANENT under
    ``serve_admission_shed``: retrying amplifies the overload that shed
    it).  Otherwise by the cause chain, which an aggregating layer wraps
    (``_connect_all``'s "failed to connect to N workers"): an open circuit
    is transient (``circuit_open``: a later attempt waits out the cooldown),
    an SSH authentication or host-key verdict permanent (``ssh_auth``,
    ``ssh_host_key``).  Then by type: a ``TransportError`` (an agent
    channel's death included) and connection errors are transient,
    filesystem errors and anything unrecognized permanent.
    """
    if isinstance(error, asyncio.CancelledError):
        return FaultClass.PERMANENT, "cancelled"
    label = getattr(error, "fault_label", None)
    if isinstance(label, str) and label:
        transient = bool(getattr(error, "fault_transient", False))
        return (FaultClass.TRANSIENT if transient else FaultClass.PERMANENT), label
    cause: BaseException | None = error
    for _ in range(8):
        if cause is None:
            break
        if isinstance(cause, CircuitOpenError):
            return FaultClass.TRANSIENT, "circuit_open"
        name = type(cause).__name__
        if name in _SSH_AUTH_ERRORS:
            return FaultClass.PERMANENT, "ssh_auth"
        if name in _SSH_HOST_KEY_ERRORS:
            return FaultClass.PERMANENT, "ssh_host_key"
        cause = cause.__cause__
    if isinstance(error, TransportError):
        return FaultClass.TRANSIENT, "transport"
    if isinstance(error, (FileNotFoundError, PermissionError, IsADirectoryError,
                          NotADirectoryError)):
        return FaultClass.PERMANENT, type(error).__name__
    if isinstance(error, (ConnectionError, TimeoutError, OSError)):
        return FaultClass.TRANSIENT, "connection"
    return FaultClass.PERMANENT, type(error).__name__


def tag_fault(error: BaseException, label: str, transient: bool) -> BaseException:
    """Give ``error`` its own classification (read first by
    :func:`classify_error`) and return it."""
    error.fault_label = label  # type: ignore[attr-defined]
    error.fault_transient = transient  # type: ignore[attr-defined]
    return error


@dataclass
class RetryPolicy:
    """Exponential backoff with full jitter: the sleep before retry
    ``attempt + 1`` is uniform in ``[0, min(max_delay, base_delay * 2**attempt)]``."""

    base_delay: float = 0.25
    max_delay: float = 10.0
    _rng: random.Random = field(default_factory=random.Random, repr=False)

    def delay(self, attempt: int) -> float:
        ceiling = min(self.max_delay, self.base_delay * (2 ** attempt))
        return self._rng.uniform(0.0, ceiling)


class CircuitOpenError(TransportError):
    """Fail-fast: the worker's circuit is open; no dial was attempted."""


class CircuitState(str, Enum):
    CLOSED = "closed"          # normal operation
    OPEN = "open"              # quarantined: fail fast, no dialing
    HALF_OPEN = "half_open"    # cooldown elapsed: one probe in flight

    @property
    def gauge_value(self) -> int:
        return {"closed": 0, "half_open": 1, "open": 2}[self.value]


class CircuitBreaker:
    """Per-worker-address failure quarantine.

    CLOSED -> OPEN after ``failure_threshold`` consecutive failures; OPEN ->
    HALF_OPEN once ``cooldown`` has elapsed (the next :meth:`check` lets
    exactly one probe through); HALF_OPEN -> CLOSED on success, back to
    OPEN on failure.  Not thread-safe: every dispatch path runs on the one
    dispatcher event loop.
    """

    def __init__(self, address: str, failure_threshold: int = 3, cooldown: float = 30.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.address = address
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown = float(cooldown)
        self._clock = clock
        self._state = CircuitState.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        _CIRCUIT_STATE.labels(address=address).set(0)

    @property
    def state(self) -> CircuitState:
        """Current state, promoting OPEN -> HALF_OPEN after the cooldown."""
        if (self._state is CircuitState.OPEN
                and self._clock() - self._opened_at >= self.cooldown):
            self._transition(CircuitState.HALF_OPEN)
        return self._state

    def _transition(self, to: CircuitState) -> None:
        if to is self._state:
            return
        obs_events.emit("circuit.state", address=self.address, from_state=self._state.value,
                        to_state=to.value, consecutive_failures=self._consecutive_failures)
        _CIRCUIT_TRANSITIONS.labels(to=to.value).inc()
        _CIRCUIT_STATE.labels(address=self.address).set(to.gauge_value)
        self._state = to
        if to is CircuitState.OPEN:
            self._opened_at = self._clock()

    def check(self) -> None:
        """Raise :class:`CircuitOpenError` while the host is quarantined.

        In HALF_OPEN the first check passes (the probe); callers that come
        while the probe is in flight fail fast until its outcome is
        recorded.
        """
        state = self.state
        if state is CircuitState.OPEN:
            raise CircuitOpenError(
                f"circuit open for {self.address} ({self._consecutive_failures} consecutive "
                f"failures; retrying after {self.cooldown:.0f}s cooldown)")
        if state is CircuitState.HALF_OPEN:
            if self._probe_in_flight:
                raise CircuitOpenError(f"circuit half-open for {self.address}; probe in flight")
            self._probe_in_flight = True

    def record_success(self) -> None:
        self._consecutive_failures = 0
        self._probe_in_flight = False
        self._transition(CircuitState.CLOSED)

    def record_failure(self) -> None:
        self._consecutive_failures += 1
        self._probe_in_flight = False
        if (self._state is CircuitState.HALF_OPEN
                or self._consecutive_failures >= self.failure_threshold):
            # a failed half-open probe re-opens at once; in CLOSED the
            # threshold governs
            self._transition(CircuitState.OPEN)


class CircuitBreakerRegistry:
    """One :class:`CircuitBreaker` per worker address, created on demand."""

    def __init__(self, failure_threshold: int = 3, cooldown: float = 30.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown
        self._clock = clock
        self._breakers: dict[str, CircuitBreaker] = {}

    def get(self, address: str) -> CircuitBreaker:
        breaker = self._breakers.get(address)
        if breaker is None:
            breaker = CircuitBreaker(address, failure_threshold=self.failure_threshold,
                                     cooldown=self.cooldown, clock=self._clock)
            self._breakers[address] = breaker
        return breaker

    def states(self) -> dict[str, str]:
        """address -> state snapshot."""
        return {a: b.state.value for a, b in self._breakers.items()}
