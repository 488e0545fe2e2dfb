"""Content addressing of staged artifacts (own copy of the part of
``covalent_tpu_plugin/cache.py`` the serving session and RPC dispatch use).

A serving session's factory payload, an RPC electron's function pickle and
its oversized args are staged under their sha256 in the worker's
``{remote_cache}/cas/`` and verified by digest there before they are
unpickled.

* :class:`CASIndex` — per-connection "already present" digest sets, seeded
  by one existence probe per connection and maintained locally, with
  single-flight puts: a fan-out of electrons sharing one function ships it
  once.
* :class:`FnRegistry` — per-connection registered-function digests: one
  ``register_fn`` per digest and resident runtime.

The result cache, pruning and ``harness_digest`` come with slice 5b.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import shlex
import uuid

from .obs.metrics import REGISTRY
from .obs.trace import Span
from .transport.base import Transport, TransportError

__all__ = [
    "CAS_DIR",
    "CASIndex",
    "FnRegistry",
    "bytes_digest",
    "cas_path",
    "file_digest",
    "CAS_UPLOADS_TOTAL",
    "RPC_REGISTRATIONS_TOTAL",
]

#: Directory of digest-named artifacts under a remote cache.
CAS_DIR = "cas"

CAS_UPLOADS_TOTAL = REGISTRY.counter(
    "covalent_tpu_cas_uploads_total",
    "CAS artifact upload decisions (hit = worker already holds the digest, "
    "put skipped; miss = payload shipped)",
    ("result",),
)
RPC_REGISTRATIONS_TOTAL = REGISTRY.counter(
    "covalent_tpu_rpc_registrations_total",
    "RPC function-registry decisions (hit = the connection's resident "
    "runtime already holds the digest; miss = function registered)",
    ("result",),
)


def bytes_digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def file_digest(path: str) -> str:
    """Streaming sha256 of a file's content."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def cas_path(remote_cache: str, digest: str, suffix: str = "") -> str:
    """Digest-addressed remote path under ``{remote_cache}/cas/``."""
    return f"{remote_cache}/{CAS_DIR}/{digest}{suffix}"


class CASIndex:
    """Per-connection "already present" digest sets with single-flight puts.

    Keys are the executor's pool keys (``transport:address``), so a
    discarded connection evicts its knowledge with it (:meth:`forget`) and
    a recreated worker is probed again instead of trusted.
    """

    def __init__(self) -> None:
        self._present: dict[str, set[str]] = {}
        self._probed: set[str] = set()
        #: (key, digest) -> future resolved when the winning put settles;
        #: losers re-check the present set and retry if the put failed.
        self._inflight: dict[tuple[str, str], asyncio.Future] = {}
        self._probe_locks: dict[str, asyncio.Lock] = {}

    async def ensure_probed(
        self, key: str, conn: Transport, entries: list[tuple[str, str]]
    ) -> None:
        """Seed ``key``'s present set with ONE existence probe (which also
        creates the CAS directory).

        ``entries`` is ``[(digest, remote_path), ...]`` for the artifacts
        about to upload.  Runs at most once per key: later electrons trust
        the locally kept set (a digest they introduce is simply absent and
        uploaded).  A failed probe reads as all-absent: a spurious upload at
        worst, never a failed dispatch.
        """
        if key in self._probed:
            return
        lock = self._probe_locks.setdefault(key, asyncio.Lock())
        async with lock:
            if key in self._probed:
                return
            present = self._present.setdefault(key, set())
            cas_dirs = sorted({os.path.dirname(path) for _, path in entries})
            probe = " ".join(
                [f"mkdir -p {' '.join(shlex.quote(d) for d in cas_dirs)};"]
                + [f"if test -e {shlex.quote(path)}; then echo 1; else echo 0; fi;"
                   for _, path in entries]
            )
            try:
                result = await conn.run(probe)
                flags = [line == "1" for line in result.stdout.split()]
            except (TransportError, OSError):
                flags = []
            for (digest, _), held in zip(entries, flags):
                if held:
                    present.add(digest)
            self._probed.add(key)

    async def ensure(
        self, key: str, conn: Transport, digest: str, local_path: str, remote_path: str
    ) -> None:
        """Upload ``local_path`` unless ``key`` already holds ``digest``.

        Single-flight per (key, digest): concurrent electrons sharing one
        payload trigger exactly one put; the rest await it and count as
        hits.  The put is published atomically (temporary name, then a
        rename): another dispatcher's probe never sees half an artifact.
        """
        while True:
            present = self._present.setdefault(key, set())
            if digest in present:
                CAS_UPLOADS_TOTAL.labels(result="hit").inc()
                return
            pending = self._inflight.get((key, digest))
            if pending is None:
                break
            await pending  # the winner settles (result-only, never raises)
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._inflight[(key, digest)] = future
        try:
            with Span("executor.cas_put", {"key": key, "digest": digest[:12]}):
                tmp = f"{remote_path}.tmp.{uuid.uuid4().hex[:12]}"
                await conn.run(f"mkdir -p {shlex.quote(os.path.dirname(remote_path))}")
                await conn.put(local_path, tmp)
                moved = await conn.run(f"mv -f {shlex.quote(tmp)} {shlex.quote(remote_path)}")
                if moved.exit_status != 0:
                    raise TransportError(
                        f"cannot publish {remote_path}: {moved.stderr.strip()}"
                    )
            present.add(digest)
            CAS_UPLOADS_TOTAL.labels(result="miss").inc()
        finally:
            self._inflight.pop((key, digest), None)
            if not future.done():
                future.set_result(None)

    def forget(self, key: str) -> None:
        """Evict one connection's knowledge (channel discarded: the worker
        may have been recreated with an empty cache)."""
        self._present.pop(key, None)
        self._probed.discard(key)
        self._probe_locks.pop(key, None)


class FnRegistry:
    """Per-connection registered-function digests for RPC dispatch.

    Mirrors :class:`CASIndex` (pool keys, single-flight, per-key
    :meth:`forget`), with one more rule: the remote registry lives in the
    resident runtime's process, not on disk, so a restarted runtime under
    the same key has lost everything.  Each set is therefore bound to the
    client object that filled it, and a new client starts it afresh.
    """

    def __init__(self) -> None:
        self._registered: dict[str, set[str]] = {}
        #: pool key -> id(client) whose resident runtime owns the set.
        self._owners: dict[str, int] = {}
        self._inflight: dict[tuple[str, str], asyncio.Future] = {}

    def holds(self, digest: str) -> bool:
        """Whether ANY live connection registered this digest."""
        return any(digest in held for held in self._registered.values())

    def counts(self) -> dict[str, int]:
        """pool key -> registered-digest count."""
        return {key: len(held) for key, held in self._registered.items()}

    def digests(self) -> set[str]:
        """Union of registered digests across every connection."""
        out: set[str] = set()
        for held in self._registered.values():
            out |= held
        return out

    async def ensure(self, key: str, client, digest: str, path: str) -> None:
        """Register ``digest`` on ``key``'s resident runtime, at most once.

        ``client`` is the live :class:`~.agent.AgentClient`; its
        ``register_fn`` digest-verifies the CAS artifact remotely before
        unpickling.  Raises exactly what the client raises (a digest
        mismatch arrives tagged PERMANENT), leaving the digest unregistered.
        """
        if self._owners.get(key) != id(client):
            # A fresh client under this key: the old runtime and its
            # in-process registry are gone.
            self._registered.pop(key, None)
            self._owners[key] = id(client)
        while True:
            registered = self._registered.setdefault(key, set())
            if digest in registered:
                RPC_REGISTRATIONS_TOTAL.labels(result="hit").inc()
                return
            pending = self._inflight.get((key, digest))
            if pending is None:
                break
            await pending  # the winner settles (result-only, never raises)
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._inflight[(key, digest)] = future
        try:
            with Span("executor.rpc_register", {"key": key, "digest": digest[:12]}):
                await client.register_fn(digest, path)
            registered.add(digest)
            RPC_REGISTRATIONS_TOTAL.labels(result="miss").inc()
        finally:
            self._inflight.pop((key, digest), None)
            if not future.done():
                future.set_result(None)

    def forget(self, key: str) -> None:
        """Evict one connection's registrations (channel discarded)."""
        self._registered.pop(key, None)
        self._owners.pop(key, None)
