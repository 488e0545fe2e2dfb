"""Fault classification and retry backoff (own copy of the part of
``covalent_tpu_plugin/resilience.py`` the serving supervisor and RPC
dispatch use).

* :func:`classify_error` — transient (channel death, transport faults,
  connection errors) against permanent (anything tagged so, filesystem
  errors, anything unrecognized).
* :func:`tag_fault` — an exception's own classification: a dead resident
  worker or dropped channel under an RPC electron is transient
  (``rpc_channel``); a digest mismatch at registration is permanent
  (``rpc_digest_mismatch``).
* :class:`RetryPolicy` — exponential backoff with full jitter.

Task retries, circuit breakers, deadlines and the retry counters
come with slice 5b: until then an electron that meets a transient fault
fails, with the classification on its error.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field
from enum import Enum

from .transport.base import TransportError

__all__ = ["FaultClass", "RetryPolicy", "classify_error", "tag_fault"]


class FaultClass(str, Enum):
    """Whether a failure is worth retrying."""

    TRANSIENT = "transient"   # infrastructure: retry may succeed
    PERMANENT = "permanent"   # deterministic: retrying re-runs the failure


def classify_error(error: BaseException) -> tuple[FaultClass, str]:
    """``(fault class, reason label)`` for one dispatch-layer exception.

    Exceptions may classify themselves with ``fault_label`` /
    ``fault_transient`` attributes (an admission shed is PERMANENT under
    ``serve_admission_shed``: retrying amplifies the overload that shed
    it).  Otherwise by type: a ``TransportError`` (an agent channel's death
    included) and connection errors are transient, filesystem errors and
    anything unrecognized permanent.
    """
    if isinstance(error, asyncio.CancelledError):
        return FaultClass.PERMANENT, "cancelled"
    label = getattr(error, "fault_label", None)
    if isinstance(label, str) and label:
        transient = bool(getattr(error, "fault_transient", False))
        return (FaultClass.TRANSIENT if transient else FaultClass.PERMANENT), label
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
