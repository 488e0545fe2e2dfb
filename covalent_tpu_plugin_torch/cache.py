"""Content addressing of staged artifacts (own copy of the part of
``covalent_tpu_plugin/cache.py`` that staging, the serving session and RPC
dispatch use).

The harness, a serving session's factory payload and an RPC electron's
function pickle and oversized args are staged under their sha256 in the
worker's ``{remote_cache}/cas/`` and verified by digest there before they
are used.  A launched electron's function pickle and specs ride the same
bundle under the operation's own names (``op_files``) and leave with it.

* :func:`harness_digest` — the harness's digest, so it ships once per
  connection under that name (the pool server runs the same file).
* :class:`CASIndex` — per-connection "already present" digest sets, seeded
  by one existence probe per connection and maintained locally, with
  single-flight puts: a fan-out of electrons sharing one function ships it
  once.  Uploads ride the connection's codec (:mod:`.transport.codec`),
  and two or more missing artifacts travel as one bundle
  (:meth:`CASIndex.ensure_bundle`: one put, one unpack exec).
* :class:`FnRegistry` — per-connection registered-function digests: one
  ``register_fn`` per digest and resident runtime.
* :func:`prune_cas_dir` — the byte-budget LRU prune of one CAS directory,
  which bounds the disaggregated set's local mirror of KV bundles, and
  :func:`cas_bytes_prune_command`, the same prune as a shell clause the
  executor runs on a worker after each electron (it prints
  ``CAS_EVICTED=<n>``).  The TTL prune is the executor's (``find -mmin``).
* :class:`ResultCache` — the opt-in, disk-backed LRU of completed electron
  results (``cache_results``): a repeat dispatch of an identical electron
  returns the stored result without touching the transport.  Bounded by
  entries and bytes, oldest first; only clean completions are stored.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import pickle
import shlex
import threading
import uuid
from functools import lru_cache
from typing import Any

import cloudpickle

from .obs import events as obs_events
from .obs.metrics import REGISTRY
from .obs.trace import Span
from .transport import codec as codec_mod
from .transport.base import Transport, TransportError
from .utils.log import app_log

__all__ = [
    "CAS_DIR",
    "CASIndex",
    "FnRegistry",
    "ResultCache",
    "bytes_digest",
    "cas_bytes_prune_command",
    "cas_path",
    "file_digest",
    "harness_digest",
    "prune_cas_dir",
    "CAS_EVICTIONS_TOTAL",
    "CAS_UPLOADS_TOTAL",
    "RESULT_CACHE_TOTAL",
    "RPC_REGISTRATIONS_TOTAL",
    "STAGING_OPS_TOTAL",
]

#: Directory of digest-named artifacts under a remote cache.
CAS_DIR = "cas"

CAS_UPLOADS_TOTAL = REGISTRY.counter(
    "covalent_tpu_cas_uploads_total",
    "CAS artifact upload decisions (hit = worker already holds the digest, "
    "put skipped; miss = payload shipped)",
    ("result",),
)
RESULT_CACHE_TOTAL = REGISTRY.counter(
    "covalent_tpu_result_cache_total",
    "Electron result-memoization events by result",
    ("result",),
)
RPC_REGISTRATIONS_TOTAL = REGISTRY.counter(
    "covalent_tpu_rpc_registrations_total",
    "RPC function-registry decisions (hit = the connection's resident "
    "runtime already holds the digest; miss = function registered)",
    ("result",),
)
STAGING_OPS_TOTAL = REGISTRY.counter(
    "covalent_tpu_staging_ops_total",
    "Control-plane round trips spent shipping staged artifacts, by path "
    "(per_file = put+publish per artifact, bundled = one tar per worker)",
    ("mode",),
)

CAS_EVICTIONS_TOTAL = REGISTRY.counter(
    "covalent_tpu_cas_evictions_total",
    "CAS artifacts evicted by the byte-budget LRU prune "
    "(site = the dispatcher's local mirror vs a worker's remote cache)",
    ("site",),
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


@lru_cache(maxsize=1)
def harness_digest() -> str:
    """Digest of this package's ``harness.py``, once per process: the file
    is copied to workers verbatim, so its digest names it in the CAS."""
    from . import harness as harness_module

    return file_digest(harness_module.__file__)


def cas_path(remote_cache: str, digest: str, suffix: str = "") -> str:
    """Digest-addressed remote path under ``{remote_cache}/cas/``."""
    return f"{remote_cache}/{CAS_DIR}/{digest}{suffix}"


def prune_cas_dir(root: str, max_bytes: int) -> int:
    """Byte-budget LRU prune of one CAS directory; returns the evictions.

    KV bundles are orders of magnitude larger than function pickles and can
    fill a disk quickly.  Oldest modification first until the directory
    fits ``max_bytes``; 0 disables.  Best-effort: a file that vanishes mid
    scan (a concurrent prune, a publish in flight) is skipped.
    """
    if max_bytes <= 0:
        return 0
    entries: list[tuple[float, int, str]] = []
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    for name in names:
        path = os.path.join(root, name)
        try:
            stat = os.stat(path)
        except OSError:
            continue
        if os.path.isfile(path):
            entries.append((stat.st_mtime, stat.st_size, path))
    entries.sort()
    total = sum(size for _, size, _ in entries)
    evicted = 0
    for _, size, path in entries:
        if total <= max_bytes:
            break
        try:
            os.remove(path)
        except OSError:
            continue
        total -= size
        evicted += 1
    if evicted:
        CAS_EVICTIONS_TOTAL.labels(site="local").inc(evicted)
        obs_events.emit("cas.bytes_pruned", root=root, evicted=evicted, budget=max_bytes)
    return evicted


#: :func:`prune_cas_dir` as a stdlib-only program for a worker's own
#: interpreter (``python -E -S -c``): it prints ``CAS_EVICTED=<n>`` for the
#: dispatcher's eviction counter.
_REMOTE_PRUNE_PROGRAM = """\
import os, sys
root, budget = sys.argv[1], int(sys.argv[2])
entries = []
try:
    names = os.listdir(root)
except OSError:
    names = []
for name in names:
    path = os.path.join(root, name)
    try:
        stat = os.stat(path)
    except OSError:
        continue
    if os.path.isfile(path):
        entries.append((stat.st_mtime, stat.st_size, path))
entries.sort()
total = sum(size for _, size, _ in entries)
evicted = 0
for _, size, path in entries:
    if total <= budget:
        break
    try:
        os.remove(path)
    except OSError:
        continue
    total -= size
    evicted += 1
print('CAS_EVICTED=%d' % evicted)
"""


def cas_bytes_prune_command(python_path: str, cas_dir: str, max_bytes: int) -> str:
    """Shell clause running the byte-budget LRU prune on a worker."""
    return (f"{python_path} -E -S -c {shlex.quote(_REMOTE_PRUNE_PROGRAM)} "
            f"{shlex.quote(cas_dir)} {int(max_bytes)}")


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

    def known(self, key: str, digest: str) -> bool:
        return digest in self._present.get(key, ())

    def holds(self, digest: str) -> bool:
        """Whether ANY live connection's present set holds ``digest``."""
        return bool(digest) and any(digest in present for present in self._present.values())

    async def ensure_probed(
        self, key: str, conn: Transport, entries: list[tuple[str, str]]
    ) -> None:
        """Seed ``key``'s present set with ONE batched existence probe
        (``conn.exists_batch``; the executor's pre-flight made the CAS
        directory).

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
            try:
                flags = await conn.exists_batch([path for _, path in entries])
            except (TransportError, OSError):
                flags = []
            for (digest, _), held in zip(entries, flags):
                if held:
                    present.add(digest)
            self._probed.add(key)

    async def ensure(self, key: str, conn: Transport, digest: str, local_path: str,
                     remote_path: str, *, codec: "codec_mod.Codec | None" = None,
                     python_path: str = "python3") -> None:
        """Upload ``local_path`` unless ``key`` already holds ``digest``.

        Single-flight per (key, digest): concurrent electrons sharing one
        payload trigger exactly one put; the rest await it and count as
        hits.  The publish is atomic (:func:`~.transport.codec.put_file`:
        a temporary name, then a rename or the remote decompress-and-check
        exec), so another dispatcher's probe never sees half an artifact;
        with a ``codec`` the payload ships compressed and the worker checks
        the digest of the decompressed bytes.
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
                stats = await codec_mod.put_file(conn, local_path, remote_path, codec=codec,
                                                 python_path=python_path, digest=digest)
            STAGING_OPS_TOTAL.labels(mode="per_file").inc(stats["ops"])
            present.add(digest)
            CAS_UPLOADS_TOTAL.labels(result="miss").inc()
        finally:
            self._inflight.pop((key, digest), None)
            if not future.done():
                future.set_result(None)

    async def ensure_bundle(self, key: str, conn: Transport,
                            artifacts: "list[tuple[str, str, str]]", *,
                            op_files: "list[tuple[str, str, str]]" = (),
                            codec: "codec_mod.Codec | None" = None,
                            python_path: str = "python3") -> None:
        """Ship every missing artifact of ``[(local, remote, digest)]`` in
        ONE bundle (one put and one unpack exec) instead of a pair each.

        Artifacts the worker holds, or that a concurrent electron is
        uploading, count as hits as in :meth:`ensure`.  ``op_files`` are
        files named for one operation, not for their digest (a launched
        electron's function pickle and spec): they ride the same bundle
        every time and never enter the present set.  With at most one file
        to ship the per-file road is taken (a bundle of one saves no round
        trip).  The missing digests sit in the single-flight map while the
        bundle travels, so a concurrent electron sharing one waits for it.
        """
        while True:
            pending = [self._inflight[(key, digest)] for _, _, digest in artifacts
                       if (key, digest) in self._inflight]
            if not pending:
                break
            await asyncio.gather(*pending)
        present = self._present.setdefault(key, set())
        missing: list[tuple[str, str, str]] = []
        seen: set[str] = set()
        for local, remote, digest in artifacts:
            if digest in present:
                CAS_UPLOADS_TOTAL.labels(result="hit").inc()
            elif digest not in seen:  # identical payloads bundle once
                seen.add(digest)
                missing.append((local, remote, digest))
        op_files = list(op_files)
        if len(missing) + len(op_files) <= 1:
            for local, remote, digest in missing:
                await self.ensure(key, conn, digest, local, remote, codec=codec,
                                  python_path=python_path)
            for local, remote, digest in op_files:
                stats = await codec_mod.put_file(conn, local, remote, codec=codec,
                                                 python_path=python_path, digest=digest)
                STAGING_OPS_TOTAL.labels(mode="per_file").inc(stats["ops"])
            return
        loop = asyncio.get_running_loop()
        futures = {digest: loop.create_future() for _, _, digest in missing}
        for digest, future in futures.items():
            self._inflight[(key, digest)] = future
        try:
            members = missing + op_files
            bundle_path = f"{os.path.dirname(members[0][1])}/bundle-{uuid.uuid4().hex[:12]}.tar"
            with Span("executor.cas_bundle", {"key": key, "members": len(members)}):
                stats = await conn.put_bundle(members, bundle_path, python_path=python_path,
                                              codec=codec)
            STAGING_OPS_TOTAL.labels(mode="bundled").inc(stats["ops"])
            for _, _, digest in missing:
                present.add(digest)
                CAS_UPLOADS_TOTAL.labels(result="miss").inc()
            obs_events.emit("cas.bundle", key=key, members=len(members),
                            wire_bytes=stats["wire_bytes"], codec=stats["codec"])
        finally:
            for _, _, digest in missing:
                self._inflight.pop((key, digest), None)
                if not futures[digest].done():
                    futures[digest].set_result(None)

    def forget(self, key: str) -> None:
        """Evict one connection's knowledge (channel discarded: the worker
        may have been recreated with an empty cache)."""
        self._present.pop(key, None)
        self._probed.discard(key)
        self._probe_locks.pop(key, None)

    def forget_digest(self, digest: str) -> None:
        """Drop one digest from every present set (its remote file was
        deleted)."""
        for present in self._present.values():
            present.discard(digest)


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

    async def ensure(self, key: str, client, digest: str, path: str,
                     runner: list[str] | None = None) -> None:
        """Register ``digest`` on ``key``'s resident runtime, at most once.

        ``client`` is the live :class:`~.agent.AgentClient`; its
        ``register_fn`` digest-verifies the CAS artifact remotely before
        unpickling (``runner``: the native agent's ``--rpc-child`` argv).
        Raises exactly what the client raises (a digest mismatch arrives
        tagged PERMANENT), leaving the digest unregistered.
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
                if runner:
                    await client.register_fn(digest, path, runner=runner)
                else:
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


class ResultCache:
    """Disk-backed LRU of completed electron results (the reference's
    ``ResultCache``, ``covalent_tpu_plugin/cache.py:563``).

    One file per entry (``{key}.pkl`` under ``root``); recency is the
    file's mtime, touched on every hit, so the store outlives the process
    and is shared by every executor pointing at the same ``cache_dir``
    (the fresh executor each workflow dispatch builds from an alias among
    them).  Bounded by ``max_entries`` and ``max_bytes``, oldest first.
    """

    def __init__(self, root: str, max_entries: int = 512,
                 max_bytes: int = 256 * 1024 * 1024) -> None:
        self.root = root
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = max(1, int(max_bytes))
        self._lock = threading.Lock()

    @staticmethod
    def make_key(*parts: str) -> str:
        return bytes_digest("\x00".join(parts).encode())

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.pkl")

    def get(self, key: str) -> tuple[bool, Any]:
        """``(hit, value)``: a missing or corrupt entry is a miss, never an
        error in the dispatch it would have spared."""
        path = self._path(key)
        with self._lock:
            try:
                with open(path, "rb") as f:
                    value = pickle.load(f)
                os.utime(path)  # the LRU touch
            except Exception:  # noqa: BLE001 - any unreadable entry is a miss
                RESULT_CACHE_TOTAL.labels(result="miss").inc()
                return False, None
        RESULT_CACHE_TOTAL.labels(result="hit").inc()
        return True, value

    def put(self, key: str, value: Any) -> bool:
        """Best-effort store; True when the entry landed.  An unpicklable
        or oversized value is counted and skipped."""
        try:
            data = cloudpickle.dumps(value)
        except Exception as err:  # noqa: BLE001 - arbitrary user objects
            RESULT_CACHE_TOTAL.labels(result="unpicklable").inc()
            app_log.debug("result cache: value not picklable (%s)", err)
            return False
        if len(data) > self.max_bytes:
            RESULT_CACHE_TOTAL.labels(result="oversize").inc()
            return False
        path = self._path(key)
        with self._lock:
            try:
                os.makedirs(self.root, exist_ok=True)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
            except OSError as err:
                RESULT_CACHE_TOTAL.labels(result="error").inc()
                app_log.warning("result cache write failed: %s", err)
                return False
            RESULT_CACHE_TOTAL.labels(result="store").inc()
            self._evict_locked()
        return True

    def _entries(self) -> list[tuple[float, int, str]]:
        out = []
        try:
            with os.scandir(self.root) as it:
                for entry in it:
                    if not entry.name.endswith(".pkl"):
                        continue
                    try:
                        stat = entry.stat()
                    except OSError:
                        continue
                    out.append((stat.st_mtime, stat.st_size, entry.path))
        except OSError:
            return []
        return sorted(out)

    def _evict_locked(self) -> None:
        entries = self._entries()
        total = sum(size for _, size, _ in entries)
        evicted = 0
        while entries and (len(entries) > self.max_entries or total > self.max_bytes):
            _, size, path = entries.pop(0)
            try:
                os.remove(path)
            except OSError:
                continue
            total -= size
            evicted += 1
            RESULT_CACHE_TOTAL.labels(result="evict").inc()
        if evicted:
            obs_events.emit("result_cache.evicted", count=evicted, root=self.root)

    def clear(self) -> None:
        with self._lock:
            for _, _, path in self._entries():
                try:
                    os.remove(path)
                except OSError:
                    pass

    def __len__(self) -> int:
        return len(self._entries())
