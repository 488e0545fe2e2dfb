"""Client of the resident worker runtimes: the pool server and the native
agent (own copy of ``covalent_tpu_plugin/agent.py``).

Two runtimes speak one protocol, and :attr:`AgentClient.mode` says which
one a channel reaches:

* ``"pool"``: :func:`start_pool_server` starts this package's ``harness.py``
  as ``--serve``, a warm interpreter that runs RPC invocations and serving
  sessions in-process and forks launch-mode tasks from its zygote.
* ``"native"``: :func:`ensure_agent_binary` uploads ``native/agent.cc`` (the
  port's copy of the reference's agent; C++17, POSIX only) and compiles it
  on the worker once per content hash, with ``g++``, ``c++`` or ``clang++``;
  :meth:`AgentClient.start` runs it.  It execs launch-mode tasks from an
  argv, forks a fresh ``harness.py --rpc-child`` per invocation and a
  ``harness.py --serve-child`` per serving session (the ``runner`` argv the
  client names), and forwards each session's commands, the profile verbs
  included, to its child.  It holds no Python, so no CUDA context crosses
  its forks.

:func:`start_pool_server` starts this package's ``harness.py`` on a worker
as ``harness.py --serve`` (the executor stages it in the worker's CAS by
its digest, once per connection, over any transport: a local subprocess
or an SSH exec channel); :class:`AgentClient` holds the
channel: a background reader files pushed events by id, so any number of
callers await their own answers, and a serving session's side-band records
go to the sink it registered (:meth:`AgentClient.watch_serve`).

The verbs: ``run`` (a launch-mode spec forked from the server's zygote)
with ``wait_exit``, ``kill``, ``watch``/``unwatch`` and ``task_inventory``;
RPC execute-by-digest (``register_fn``, ``invoke``, ``wait_result``); the
serving session's ``serve_*``, ``serve_prefill`` (the disaggregated set's
prefill tier) included; ``profile_start``/``profile_stop``
(:meth:`AgentClient.profile_start`), which trace the resident runtime with
``torch.profiler`` and pack the trace into one content-addressed artifact.

The channel starts on JSON lines.  When the server's ready banner
advertises frames, :meth:`AgentClient.negotiate_frames` switches it to
binary frames (:mod:`.transport.frames`) unless ``frames_enabled=False``
or ``COVALENT_TPU_AGENT_FRAMES=0``: RPC args and results, KV bundles and
coalesced token batches then ride raw frame bodies, and invokes of one
digest that queue in the same event-loop turn (or within
``COVALENT_TPU_RPC_BATCH_WINDOW_MS``, up to ``COVALENT_TPU_RPC_BATCH_MAX``)
leave as one ``multi_invoke`` frame.  The wire counters
(``covalent_tpu_agent_frames_total``, ``covalent_tpu_agent_wire_bytes_total``)
count both encodings.

Crash recovery: :meth:`AgentClient.declare_epoch` puts the dispatcher's
journal epoch on the channel (the worker refuses mutating commands from a
lower one), :meth:`AgentClient.serve_inventory` and
:meth:`AgentClient.task_inventory` ask what survives on the worker, and
:meth:`AgentClient.serve_resume` re-attaches a stream from a token offset.
A pool server whose dispatcher died waits in orphan mode behind
``pool_orphan.json`` (:func:`read_orphan_rendezvous`);
:func:`attach_pool_server` adopts it through the ``--attach`` relay.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import os
import shlex
import uuid
from functools import lru_cache
from pathlib import Path
from typing import Any

from .obs.metrics import AGENT_BATCHED_INVOKES_TOTAL, AGENT_FRAMES_TOTAL, AGENT_WIRE_BYTES_TOTAL
from .resilience import tag_fault
from .transport import frames
from .transport.base import Transport, TransportError
from .utils.log import app_log

#: Remote filename of the staged harness the pool server runs.
HARNESS_BASENAME = "covalent_gpu_harness.py"

#: The native agent's source, compiled on each worker.
AGENT_SOURCE = Path(__file__).parent / "native" / "agent.cc"

#: Modules the pool server and its zygote import once, at start-up: the cold
#: start is paid there, not by each electron or session.  ``torch._dynamo``
#: is what a torch optimizer imports at its first construction.
POOL_PRELOAD = "cloudpickle,torch,torch._dynamo,covalent_tpu_plugin_torch"


def frames_env_enabled() -> bool:
    """Process-wide kill switch: ``COVALENT_TPU_AGENT_FRAMES=0`` keeps JSON lines."""
    return os.environ.get("COVALENT_TPU_AGENT_FRAMES", "").strip().lower() not in (
        "0", "off", "false", "no")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


#: Invoke micro-batching: by default (window 0) only invokes queued in the
#: same event-loop turn coalesce, so a lone invoke waits for nothing; a
#: positive window trades a bounded wait for bigger batches.
_BATCH_WINDOW_S = max(0.0, _env_float("COVALENT_TPU_RPC_BATCH_WINDOW_MS", 0.0) / 1000.0)
_BATCH_MAX_OPS = max(1, int(_env_float("COVALENT_TPU_RPC_BATCH_MAX", 16)))


class AgentError(TransportError):
    """The resident runtime is unavailable, refused a command, or its
    channel failed."""


class AgentTimeoutError(AgentError):
    """No answer within the waiter's timeout: the command may still have
    taken effect on the worker."""


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


@lru_cache(maxsize=1)
def agent_source_hash() -> str:
    """Content hash naming the compiled agent, so a stale binary never runs."""
    return hashlib.sha256(AGENT_SOURCE.read_bytes()).hexdigest()[:12]


async def ensure_agent_binary(conn: Transport, remote_cache: str) -> str:
    """Upload and compile the native agent on the worker, once per content
    hash (``{remote_cache}/agent_<hash>``); returns the binary's path.

    One round trip when the binary exists; the upload and one compile
    round trip the first time (a unique temporary name and an atomic
    ``mv``, so concurrent dispatchers race safely).  Raises
    :class:`AgentError` when the worker has no C++ compiler or the build
    fails.
    """
    binary = f"{remote_cache}/agent_{agent_source_hash()}"
    q_binary = shlex.quote(binary)
    try:
        probe = await conn.run(f"mkdir -p {shlex.quote(remote_cache)}; "
                               f"test -x {q_binary} && echo HAVE || echo MISSING")
        if "HAVE" in probe.stdout:
            return binary
        source = f"{binary}.cc"
        await conn.put(str(AGENT_SOURCE), source)
        tmp = shlex.quote(f"{binary}.tmp.{uuid.uuid4().hex[:8]}")
        build = await conn.run(
            "CXX=$(command -v g++ || command -v c++ || command -v clang++) "
            '&& [ -n "$CXX" ] '
            f"&& $CXX -O2 -std=c++17 -o {tmp} {shlex.quote(source)} "
            f"&& mv {tmp} {q_binary}",
            timeout=120.0,
        )
    except (TransportError, OSError) as err:
        raise AgentError(f"cannot build the agent on {conn.address}: {err}") from err
    if build.exit_status != 0:
        raise AgentError(f"no agent on {conn.address}: compile failed or no C++ compiler "
                         f"({build.stderr.strip()[:200]})")
    return binary


async def start_pool_server(
    conn: Transport,
    remote_cache: str,
    python_path: str,
    env: dict[str, str] | None = None,
    timeout: float = 90.0,
    preload: str = POOL_PRELOAD,
    frames_enabled: bool | None = None,
    harness_path: str | None = None,
    conda_env: str = "",
) -> "AgentClient":
    """Start ``harness.py --serve`` on a worker, prove it with a ping and
    negotiate binary frames (``frames_enabled``: None reads
    ``COVALENT_TPU_AGENT_FRAMES``).

    ``harness_path`` is the harness already staged on the worker (the
    executor's CAS copy); None puts a fresh copy at
    ``{remote_cache}/covalent_gpu_harness.py``.  ``conda_env`` activates
    that environment first (ssh.py:379-380).

    ``env`` goes into the server's environment before the interpreter
    starts (the executor's ``task_env``: ``CUDA_VISIBLE_DEVICES`` cannot
    change once CUDA is up, and ``PYTHONPATH`` then reaches imports too).
    ``preload`` becomes ``COVALENT_TPU_POOL_PRELOAD``: the modules the
    server and its zygote import at start-up.  The timeout covers that
    cold start.  The server's stderr (and the zygote's) goes to
    ``{remote_cache}/pool_server.log``.
    """
    from . import harness as harness_module

    remote_harness = harness_path
    if remote_harness is None:
        remote_harness = f"{remote_cache}/{HARNESS_BASENAME}"
        try:
            await conn.run(f"mkdir -p {shlex.quote(remote_cache)}")
            await conn.put(harness_module.__file__, remote_harness)
        except (TransportError, OSError) as err:
            raise AgentError(f"cannot stage pool server on {conn.address}: {err}") from err
    assignments = " ".join(
        shlex.quote(f"{k}={v}")
        for k, v in {**(env or {}), "COVALENT_TPU_POOL_PRELOAD": preload}.items()
    )
    command = _in_conda(
        f"env {assignments} {python_path} {shlex.quote(remote_harness)} --serve "
        f"2>> {shlex.quote(remote_cache + '/pool_server.log')}", conda_env)
    try:
        process = await conn.start_process(command, describe=f"pool@{conn.address}")
    except TransportError as err:
        raise AgentError(f"cannot start pool server on {conn.address}: {err}") from err
    client = AgentClient(process, conn.address)
    client.mode = "pool"
    try:
        await client.ping(timeout)
        await client.negotiate_frames(enabled=frames_enabled)
    except AgentError:
        await client.close()
        raise
    return client


def _in_conda(command: str, conda_env: str) -> str:
    """``command`` run inside a conda environment when one is named (the
    reference's wrapping, ssh.py:379-380)."""
    if not conda_env:
        return command
    return (f'eval "$(conda shell.bash hook)" && conda activate '
            f"{shlex.quote(conda_env)} && {command}")


def orphan_rendezvous_path(remote_cache: str) -> str:
    """Where an orphaned pool server publishes its adoption coordinates."""
    return f"{remote_cache}/pool_orphan.json"


async def read_orphan_rendezvous(conn: Transport, remote_cache: str) -> dict | None:
    """The worker's ``pool_orphan.json``, or None when no orphan waits."""
    import tempfile

    path = orphan_rendezvous_path(remote_cache)
    with tempfile.TemporaryDirectory(prefix="covalent-orphan-") as tmp:
        local = f"{tmp}/pool_orphan.json"
        try:
            await conn.get(path, local)
            with open(local, "r", encoding="utf-8") as fh:
                meta = json.load(fh)
        except (TransportError, OSError, ValueError):
            return None
    if not isinstance(meta, dict) or not meta.get("sock"):
        return None
    return meta


async def attach_pool_server(
    conn: Transport,
    remote_cache: str,
    python_path: str,
    sock_path: str,
    epoch: int,
    timeout: float = 30.0,
    frames_enabled: bool | None = None,
    harness_path: str | None = None,
    conda_env: str = "",
) -> "AgentClient":
    """Adopt an orphaned pool server instead of starting a fresh one.

    Spawns the ``--attach`` stdio relay through the transport (the road a
    fresh pool server takes, so adoption works wherever a server can be
    started), sends the epoch-fenced ``adopt`` line, and waits for the
    orphan's re-attach ready banner.  The orphan refuses a stale epoch
    with an error event, raised here as :class:`AgentError` so the caller
    starts a fresh server instead.  The relay forks nothing and imports no
    CUDA: it pumps bytes between its stdio and the orphan's socket.
    """
    remote_harness = harness_path or f"{remote_cache}/{HARNESS_BASENAME}"
    command = _in_conda(
        f"{python_path} {shlex.quote(remote_harness)} --attach {shlex.quote(sock_path)} "
        f"2>> {shlex.quote(remote_cache + '/pool_server.log')}", conda_env)
    try:
        process = await conn.start_process(command, describe=f"adopt@{conn.address}")
    except TransportError as err:
        raise AgentError(f"cannot start attach relay on {conn.address}: {err}") from err
    client = AgentClient(process, conn.address)
    client.mode = "pool"
    try:
        await client._send({"cmd": "adopt", "epoch": int(epoch)})

        def adopted(c: "AgentClient"):
            if c._banner.get("reattach"):
                return c._banner
            code = c._error_codes.get("")
            if code in ("stale_epoch", "attach_failed"):
                message = c._errors.pop("", code)
                c._error_codes.pop("", None)
                what = "adopt refused: " if code == "stale_epoch" else ""
                raise AgentError(f"agent@{c.address}: {what}{message}")
            return None

        await client._wait(adopted, timeout)
        await client.ping(timeout)
        await client.negotiate_frames(enabled=frames_enabled)
    except AgentError:
        await client.close()
        raise
    return client


class AgentClient:
    """One channel to a worker's resident runtime, demultiplexing pushed
    events."""

    #: "native" (the C++ agent: argv exec, runner children) or "pool" (the
    #: harness's pool server: zygote forks, in-process RPC and sessions)
    mode: str = "native"

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
        self._serve_inventory: dict | None = None
        #: "sid/rid" -> pushed ``serve_resumed`` ack (recovery path), bounded
        self._serve_resumed: dict[str, dict] = {}
        #: the last ``epoch_ok`` ack of :meth:`declare_epoch`
        self._epoch_ack: dict | None = None
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
        #: "sid/rid" -> pushed ``serve_kv`` answer to a prefill (a KV bundle
        #: or an error), bounded: a late answer nobody waits for is dropped
        self._serve_kv: dict[str, dict] = {}
        #: "kind:sid/adapter" -> pushed ``serve_attached``/``serve_detached``
        #: ack or refusal of a live adapter splice, bounded the same way
        self._serve_attached: dict[str, dict] = {}
        #: resident profiling: profile id -> pushed profile_started /
        #: profile_stopped / profile_error event
        self._profile_started: dict[str, dict] = {}
        self._profile_stopped: dict[str, dict] = {}
        self._profile_errors: dict[str, dict] = {}
        #: frames: the ready banner (the server's capabilities), the pushed
        #: ``frames`` ack, and whether the channel runs on frames
        self._banner: dict = {}
        self._frames_ack: dict | None = None
        self.frames_active = False
        #: invoke micro-batching: digest -> [(command, args bytes)] queued
        #: this window, flushed as one frame per digest
        self._pending_invokes: dict[str, list] = {}
        self._flush_scheduled = False
        self._flush_now = False
        #: live flusher tasks (the loop keeps only weak references)
        self._flush_tasks: set = set()
        self._reader = asyncio.ensure_future(self._read_loop())

    @classmethod
    async def start(cls, conn: Transport, binary: str, timeout: float = 15.0,
                    frames_enabled: bool | None = None, env: dict[str, str] | None = None,
                    conda_env: str = "") -> "AgentClient":
        """Run the compiled native agent on a worker, prove it with a ping and
        negotiate frames.  ``env`` goes into its environment, and so into
        every runner it forks (the executor's ``task_env``: a runner unpickles
        the function before the invocation's own env applies, so
        ``PYTHONPATH`` must be there from the start)."""
        assignments = " ".join(shlex.quote(f"{k}={v}") for k, v in (env or {}).items())
        command = _in_conda(f"env {assignments} {shlex.quote(binary)}" if assignments
                            else shlex.quote(binary), conda_env)
        try:
            process = await conn.start_process(command, describe=f"agent@{conn.address}")
        except TransportError as err:
            raise AgentError(f"cannot start agent on {conn.address}: {err}") from err
        client = cls(process, conn.address)
        try:
            await client.ping(timeout)
            await client.negotiate_frames(enabled=frames_enabled)
        except AgentError:
            await client.close()
            raise
        return client

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

    def _decode_message(self, message) -> dict | None:
        """One message off :meth:`TransportProcess.read_event` as a protocol
        dict, counted on the wire counters; None for stray output."""
        if message[0] == "frame":
            _kind, verb, flags, header, body = message
            AGENT_FRAMES_TOTAL.labels(verb=frames.VERB_NAMES.get(verb, str(verb)),
                                      encoding="binary").inc()
            AGENT_WIRE_BYTES_TOTAL.labels(direction="down", encoding="binary").inc(
                frames.HEADER_LEN + len(header) + len(body))
            try:
                return frames.decode_payload(flags, header, body)
            except frames.FrameIntegrityError as err:
                # The frame arrived whole, so this is torn content, not a
                # dead channel: deliver it marked, so its waiter fails
                # PERMANENT.  (A header that is not JSON raises FrameError
                # and ends the reader: the stream cannot be trusted.)
                try:
                    event = json.loads(header.decode("utf-8"))
                except ValueError:
                    raise TransportError(
                        f"agent@{self.address}: undecodable torn frame: {err}") from err
                event.pop("_body", None)
                event["torn"] = repr(err)
                return event
        line = message[1]
        try:
            event = json.loads(line)
        except ValueError:
            return None  # stray non-protocol output
        AGENT_FRAMES_TOTAL.labels(
            verb=str(event.get("event")) if isinstance(event, dict) else "?",
            encoding="jsonl").inc()
        AGENT_WIRE_BYTES_TOTAL.labels(direction="down", encoding="jsonl").inc(len(line) + 1)
        return event

    def _handle_batch(self, task_id: str, event: dict) -> None:
        """A coalesced ``telemetry_batch``: each record takes the
        per-record road (seq dedup, the session's sink, the splice)."""
        if event.get("torn"):
            app_log.warning("agent@%s: dropped torn telemetry batch for %s: %s",
                            self.address, task_id, event["torn"])
            return
        records = event.get("records") or b"[]"
        try:
            parsed = json.loads(records.decode("utf-8")
                                if isinstance(records, (bytes, bytearray)) else records)
        except (ValueError, UnicodeDecodeError):
            parsed = []
        for record in parsed if isinstance(parsed, list) else []:
            self._handle_telemetry(task_id, record)

    async def _read_loop(self) -> None:
        try:
            while True:
                event = self._decode_message(await self._process.read_event())
                if not isinstance(event, dict):
                    continue
                async with self._cond:
                    kind = event.get("event")
                    task_id = str(event.get("id") or "")
                    if kind == "telemetry":
                        self._handle_telemetry(task_id, event.get("data"))
                        continue  # side-band: no waiter to notify
                    if kind == "telemetry_batch":
                        self._handle_batch(task_id, event)
                        continue
                    if kind == "started":
                        self._started[task_id] = int(event["pid"])
                    elif kind == "multi_started":
                        pid = int(event.get("pid") or 0)
                        for tid in event.get("ids") or []:
                            self._started[str(tid)] = pid
                    elif kind == "ready":
                        self._banner = event
                    elif kind == "frames":
                        self._frames_ack = event
                    elif kind == "serve_kv":
                        self._serve_kv[f"{task_id}/{event.get('rid') or ''}"] = event
                        while len(self._serve_kv) > 256:
                            self._serve_kv.pop(next(iter(self._serve_kv)))
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
                    elif kind == "serve_inventory":
                        self._serve_inventory = event
                    elif kind == "serve_resumed":
                        self._serve_resumed[f"{task_id}/{event.get('rid') or ''}"] = event
                        while len(self._serve_resumed) > 1024:
                            self._serve_resumed.pop(next(iter(self._serve_resumed)))
                    elif kind in ("serve_attached", "serve_detached"):
                        self._serve_attached[f"{kind}:{task_id}/{event.get('adapter') or ''}"] = event
                        while len(self._serve_attached) > 256:
                            self._serve_attached.pop(next(iter(self._serve_attached)))
                    elif kind == "epoch_ok":
                        self._epoch_ack = event
                    elif kind == "profile_started":
                        self._profile_started[task_id] = event
                    elif kind == "profile_stopped":
                        self._profile_stopped[task_id] = event
                    elif kind == "profile_error":
                        self._profile_errors[task_id] = event
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
                        # invoke, kill or watch; an id-less one is logged
                        # only, but for the epoch fence's refusal and a
                        # failed attach relay, which declare_epoch and
                        # attach_pool_server wait on.
                        if task_id or event.get("code") in ("stale_epoch", "attach_failed"):
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
            raise AgentTimeoutError(f"agent@{self.address}: no event within {timeout}s") from None

    async def _send(self, command: dict) -> None:
        if self._dead is not None:
            raise AgentError(f"agent@{self.address} channel died: {self._dead}")
        line = json.dumps(command)
        AGENT_FRAMES_TOTAL.labels(verb=str(command.get("cmd", "?")), encoding="jsonl").inc()
        AGENT_WIRE_BYTES_TOTAL.labels(direction="up", encoding="jsonl").inc(len(line) + 1)
        try:
            await self._process.write_line(line)
        except TransportError as err:
            raise AgentError(f"agent@{self.address}: send failed: {err}") from err

    async def _send_frame(self, verb: int, header: dict, body: bytes = b"") -> None:
        """One binary frame down the channel (negotiated channels only)."""
        if self._dead is not None:
            raise AgentError(f"agent@{self.address} channel died: {self._dead}")
        payload = frames.encode_frame(verb, header, body)
        AGENT_FRAMES_TOTAL.labels(verb=frames.VERB_NAMES.get(verb, str(verb)),
                                  encoding="binary").inc()
        AGENT_WIRE_BYTES_TOTAL.labels(direction="up", encoding="binary").inc(len(payload))
        try:
            await self._process.write_bytes(payload)
        except TransportError as err:
            raise AgentError(f"agent@{self.address}: send failed: {err}") from err

    async def _send_serve(self, command: dict, body: bytes | None = None) -> None:
        """A serving command: a frame on a negotiated channel (with ``body``
        under the field the header's ``_body`` names), a JSON line
        otherwise."""
        if self.frames_active:
            await self._send_frame(frames.VERB_SERVE, command, body or b"")
        else:
            await self._send(command)

    # -- commands ------------------------------------------------------------

    async def ping(self, timeout: float = 15.0) -> None:
        before = self._pongs
        await self._send({"cmd": "ping"})
        await self._wait(lambda c: c._pongs > before, timeout)

    async def negotiate_frames(self, timeout: float = 15.0, enabled: bool | None = None) -> bool:
        """Switch the channel to binary frames when both ends can.

        The server advertised ``frames`` in its ready banner (read before
        the ping's answer, so this never races it) and answers the
        ``frames`` command with an ack.  A silent banner, a ``version: 0``
        refusal (the worker's kill switch) or ``enabled=False`` (this
        side's) leave the channel on JSON lines, with byte-equal results.
        Frame bodies go uncompressed: the reference asks for zlib bodies
        only where its file-staging codec is pinned, which the port has not.
        """
        if enabled is None:
            enabled = frames_env_enabled()
        if not enabled or not self._banner.get("frames"):
            return False
        await self._send({"cmd": "frames", "version": frames.VERSION, "codec": ""})
        ack = await self._wait(lambda c: c._frames_ack, timeout)
        self.frames_active = int(ack.get("version") or 0) >= 1
        return self.frames_active

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
        elif code == "bad_frame":
            # torn content: the same bytes cannot be sent successfully again
            tag_fault(rejection, "agent_bad_frame", transient=False)
        return rejection

    # -- the run verb ---------------------------------------------------------

    async def run_task(self, task_id: str, spec: str = "", log: str = "",
                       timeout: float = 30.0, argv: list[str] | None = None) -> int:
        """Run a launch-mode task; returns its pid from the ``started`` event.

        ``spec`` (the pool server) names a staged spec the zygote forks a
        child for; ``argv`` (the native agent) is the command it execs.

        The task's files (spec, log, pid, result) are those a launch-mode
        harness uses, so the pid and result-file probes still work if the
        channel dies.  A raised :class:`AgentError` carries
        ``maybe_started``: whether the command left for the worker without
        a rejection, so the task may be running there and must not be
        launched again.
        """
        command: dict = {"cmd": "run", "id": task_id}
        if spec:
            command["spec"] = spec
        else:
            command["argv"] = [str(part) for part in argv or ()]
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
        """The forked tasks still running on the worker (``tasks``: id,
        pid) and the worker's epoch fence (``epoch``)."""
        self._task_inventory = None
        await self._send({"cmd": "task_inventory"})
        inventory = await self._wait(lambda c: c._task_inventory, timeout)
        self._task_inventory = None
        return inventory

    # -- crash recovery (epoch fence, inventories, stream resume) ---------

    async def declare_epoch(self, epoch: int, timeout: float = 15.0) -> dict:
        """Declare this dispatcher's journal epoch on the channel; returns
        the ``epoch_ok`` ack.  The worker keeps the highest epoch it has
        seen and refuses mutating commands from channels that declared a
        lower one: raises :class:`AgentError` when this channel is the
        stale one."""
        self._epoch_ack = None
        self._errors.pop("", None)
        self._error_codes.pop("", None)
        await self._send({"cmd": "epoch", "epoch": int(epoch)})

        def settled(c: "AgentClient"):
            if c._epoch_ack is not None:
                return c._epoch_ack
            if c._error_codes.get("") == "stale_epoch":
                message = c._errors.pop("", "stale epoch")
                c._error_codes.pop("", None)
                raise AgentError(f"agent@{c.address}: {message}")
            return None

        return await self._wait(settled, timeout)

    async def serve_inventory(self, timeout: float = 30.0) -> dict:
        """The serving sessions that survive in the worker: the
        ``serve_inventory`` event (per session its sid, factory digest,
        slots, running rids with their emitted-token counts and the
        finished ring), and the worker's epoch fence."""
        self._serve_inventory = None
        await self._send({"cmd": "serve_inventory"})
        inventory = await self._wait(lambda c: c._serve_inventory, timeout)
        self._serve_inventory = None
        return inventory

    async def serve_resume(self, sid: str, rid: str, start: int, timeout: float = 30.0) -> dict:
        """Resume one stream from token ``start`` after re-adoption: the
        worker re-emits its history from there on the side-band (under the
        lock its live chunks take, so no gap can open) and answers
        ``serve_resumed`` with what it knows of the rid: ``streaming``,
        ``done``, ``pending``, ``unknown`` or (a stale channel) ``refused``."""
        key = f"{sid}/{rid}"
        self._serve_resumed.pop(key, None)
        await self._send({"cmd": "serve_resume", "id": sid, "rid": rid, "from": int(start)})
        return await self._wait(lambda c: c._serve_resumed.pop(key, None), timeout)

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

    async def register_fn(self, digest: str, path: str, runner: list[str] | None = None,
                          timeout: float = 60.0) -> None:
        """Register a CAS-staged cloudpickled function by its digest.

        The runtime verifies ``path``'s sha256 against ``digest`` before
        unpickling and keeps the function for invoke-by-digest.  A digest
        this channel already registered is a no-op.  A digest mismatch (a
        torn or stale artifact) raises :class:`AgentError` tagged PERMANENT
        (``rpc_digest_mismatch``): sending the same bytes again cannot help.
        ``runner`` (the native agent) is the argv it forks per invocation,
        ``[python, harness, "--rpc-child"]``.
        """
        if digest in self._registered:
            return
        command: dict = {"cmd": "register_fn", "digest": digest, "path": path}
        if runner:
            command["runner"] = [str(part) for part in runner]
        await self._send(command)

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

        The args travel inline: raw bytes in a frame body on a negotiated
        channel (``args_bytes``), base64 in the JSON line otherwise
        (``args_b64``, or ``args_bytes`` encoded here); or by CAS path and
        digest when oversized.  On a negotiated channel, inline invokes of
        one digest queued in the same event-loop turn (or window) leave as
        ONE ``multi_invoke`` frame, acked by one ``multi_started``; their
        results still arrive one by one.  ``path`` (the function's CAS
        artifact) lets a restarted runtime heal a lost registration.  Given
        ``result_path`` and ``result_max_inline``, a result pickle over the
        threshold is staged to that remote path instead of inlined.  The
        result arrives separately (:meth:`wait_result`).
        """
        command: dict = {"cmd": "invoke", "id": task_id, "digest": digest}
        if path:
            command["path"] = path
        if spec:
            command["spec"] = dict(spec)
        framed = self.frames_active and args_bytes is not None and not args_path
        if not framed:
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
        if framed and self.mode == "pool":
            self._enqueue_invoke(digest, command, args_bytes or b"")
        elif framed:
            # The native agent forks one runner per invoke: frames, but
            # nothing to batch.
            await self._send_frame(frames.VERB_INVOKE, {**command, "_body": "args_bytes"},
                                   args_bytes or b"")
        else:
            await self._send(command)

        def ready(c: "AgentClient"):
            rejection = c._pop_rejection(task_id, "invoke")
            if rejection is not None:
                raise rejection
            return c._started.get(task_id)

        pid = await self._wait(ready, timeout)
        self._started.pop(task_id, None)
        return pid

    # -- invoke micro-batching ---------------------------------------------

    def _enqueue_invoke(self, digest: str, command: dict, body: bytes) -> None:
        """Queue one framed invoke; the flusher coalesces per digest."""
        self._pending_invokes.setdefault(digest, []).append((command, body))
        total = sum(len(v) for v in self._pending_invokes.values())
        if not self._flush_scheduled:
            self._flush_scheduled = True
            self._spawn_flush(immediate=False)
        elif total >= _BATCH_MAX_OPS and not self._flush_now:
            # a full batch leaves now, without waiting out the window
            self._flush_now = True
            self._spawn_flush(immediate=True)

    def _spawn_flush(self, immediate: bool) -> None:
        task = asyncio.ensure_future(self._flush_invokes(immediate))
        self._flush_tasks.add(task)
        task.add_done_callback(self._flush_tasks.discard)

    async def _flush_invokes(self, immediate: bool = False) -> None:
        """Send every queued invoke, one frame per digest.  A send failure
        files a rejection for each op, so its waiter fails at once."""
        if not immediate and _BATCH_WINDOW_S > 0:
            await asyncio.sleep(_BATCH_WINDOW_S)
        else:
            await asyncio.sleep(0)
        pending, self._pending_invokes = self._pending_invokes, {}
        self._flush_scheduled = False
        self._flush_now = False
        for digest, entries in pending.items():
            try:
                await self._send_invoke_group(digest, entries)
            except (AgentError, TransportError, ValueError) as err:
                async with self._cond:
                    for command, _body in entries:
                        self._errors[str(command.get("id") or "")] = (
                            f"batched invoke send failed: {err}")
                    self._cond.notify_all()

    async def _send_invoke_group(self, digest: str, entries: list) -> None:
        if len(entries) == 1:
            command, body = entries[0]
            await self._send_frame(frames.VERB_INVOKE, {**command, "_body": "args_bytes"}, body)
            return
        ops, bodies, fn_path = [], [], ""
        for command, body in entries:
            fn_path = fn_path or str(command.get("path") or "")
            ops.append({k: v for k, v in command.items() if k not in ("cmd", "digest", "path")})
            bodies.append(body)
        header: dict = {"cmd": "multi_invoke", "digest": digest, "ops": ops,
                        "args_lens": [len(b) for b in bodies], "_body": "args_bytes"}
        if fn_path:
            header["path"] = fn_path
        await self._send_frame(frames.VERB_MULTI_INVOKE, header, b"".join(bodies))
        AGENT_BATCHED_INVOKES_TOTAL.inc(len(entries))

    async def wait_result(self, task_id: str, timeout: float | None = None) -> dict:
        """Block until the invocation's pushed ``result`` event."""
        event = await self._wait(lambda c: c._results.get(task_id), timeout)
        self._results.pop(task_id, None)
        return event

    # -- serving sessions -------------------------------------------------------

    async def serve_open(self, sid: str, digest: str, path: str,
                         options: dict | None = None, spec: dict | None = None,
                         runner: list[str] | None = None, timeout: float = 120.0) -> dict:
        """Open a resident serving session; returns the ``serve_opened``
        event (``slots``, worker ``pid``).

        The worker verifies ``path``'s sha256 against ``digest`` before
        unpickling the factory, calls it once (the model build on the card:
        hence the generous timeout) and serves requests for the session's
        lifetime.  A refused open raises :class:`AgentError`, tagged
        PERMANENT when the refusal is deterministic (a digest mismatch, a
        factory refusing its model).  ``runner`` (the native agent) is the
        argv it forks to host the session, ``[python, harness,
        "--serve-child"]``.
        """
        command: dict = {"cmd": "serve_open", "id": sid, "digest": digest, "path": path}
        if options:
            command["options"] = dict(options)
        if spec:
            command["spec"] = dict(spec)
        if runner:
            command["runner"] = [str(part) for part in runner]
        await self._send(command)

        def settled(c: "AgentClient"):
            if sid in c._serve_errors:
                raise _refusal(c.address, f"serve_open {sid}", c._serve_errors.pop(sid))
            return c._serve_opened.pop(sid, None)

        return await self._wait(settled, timeout)

    async def serve_request(self, sid: str, rid: str, prompt, params: dict | None = None,
                            deadline_s: float = 0.0, tenant: str = "",
                            kv_bytes: bytes | None = None, kv_digest: str = "",
                            kv_path: str = "", trace: dict | None = None) -> None:
        """Submit one request to an open session (fire-and-stream): its
        ``serve.token`` records, or a ``serve.reject``, arrive at the
        session's :meth:`watch_serve` sink.

        A disaggregated request attaches its prefilled KV bundle:
        ``kv_bytes`` rides a raw frame body on a negotiated channel (base64
        in the line otherwise), ``kv_path`` names a CAS-staged copy.  Either
        way the worker checks ``kv_digest`` before the engine unpickles
        anything, and any mismatch degrades to a full prefill.  ``trace`` (an
        :func:`~.obs.trace.context_of` carrier) rides the command, so the
        worker's spans of the request join its trace.
        """
        command: dict = {"cmd": "serve_request", "id": sid, "rid": rid, "prompt": prompt}
        if params:
            command["params"] = dict(params)
        if deadline_s:
            command["deadline_s"] = float(deadline_s)
        if tenant:
            command["tenant"] = str(tenant)
        if trace:
            command["trace"] = dict(trace)
        if kv_digest:
            command["kv_digest"] = kv_digest
        if kv_path:
            command["kv_path"] = kv_path
        inline_kv = kv_bytes is not None and not kv_path
        if inline_kv and self.frames_active:
            command["_body"] = "kv_bytes"
        elif inline_kv:
            command["kv"] = base64.b64encode(kv_bytes).decode("ascii")
        await self._send_serve(command, kv_bytes if inline_kv else None)

    async def serve_attach(self, sid: str, adapter: str, digest: str, path: str,
                           timeout: float = 60.0) -> dict:
        """Splice a LoRA adapter bundle into a running session (reference
        ``agent.py:1315-1340``).  ``path`` names a CAS-staged bundle on the
        worker and ``digest`` its sha256: the worker checks the bytes before
        the engine reads them.  Returns the ``serve_attached`` ack (the
        content ``digest`` and ``attach_s``); a refusal raises
        :class:`AgentError`, tagged permanent where the worker says so (no
        bank, a digest mismatch, an unknown adapter, a geometry refusal)."""
        return await self._serve_attach_rpc(
            {"cmd": "serve_attach", "id": sid, "adapter": str(adapter),
             "digest": str(digest), "path": str(path)}, timeout)

    async def serve_detach(self, sid: str, adapter: str, timeout: float = 30.0) -> dict:
        """Retire a named adapter of a running session (its bank slot frees
        once the requests pinned to it finish)."""
        return await self._serve_attach_rpc(
            {"cmd": "serve_detach", "id": sid, "adapter": str(adapter)}, timeout)

    async def _serve_attach_rpc(self, command: dict, timeout: float) -> dict:
        name = str(command["cmd"])
        sid, adapter = str(command["id"]), str(command["adapter"])
        key = f"{name}ed:{sid}/{adapter}"
        self._serve_attached.pop(key, None)
        await self._send_serve(command)
        event = await self._wait(lambda c: c._serve_attached.pop(key, None), timeout)
        if event.get("code"):
            failure = AgentError(f"agent@{self.address}: {name} {adapter!r} on {sid} failed "
                                 f"({event.get('code')}): {event.get('message')}")
            if event.get("permanent"):
                failure.fault_label = str(event.get("label")
                                          or f"serve_{event.get('code') or 'error'}")
                failure.fault_transient = False
            raise failure
        return event

    async def serve_prefill(self, sid: str, rid: str, prompt, params: dict | None = None,
                            timeout: float = 60.0, trace: dict | None = None) -> dict:
        """Run a prefill-only pass on an open session; returns the
        ``serve_kv`` event, the bundle under ``data_bytes`` and its sha256
        (as the worker computed it) under ``digest``.

        The bundle rides a raw frame body on a negotiated channel, base64
        in a JSON line otherwise.  A refusal on the worker (unknown
        session, a full queue, an engine without the surface) raises
        :class:`AgentError`: the disaggregated set then degrades to a full
        prefill on the decode replica.
        """
        command: dict = {"cmd": "serve_prefill", "id": sid, "rid": rid, "prompt": prompt}
        if params:
            command["params"] = dict(params)
        if trace:
            command["trace"] = dict(trace)
        await self._send_serve(command)
        key = f"{sid}/{rid}"
        event = await self._wait(lambda c: c._serve_kv.pop(key, None), timeout)
        if event.get("code"):
            raise AgentError(f"agent@{self.address}: serve_prefill {rid} failed "
                             f"({event.get('code')}): {event.get('message')}")
        if event.get("torn"):
            raise AgentError(f"agent@{self.address}: serve_prefill {rid} returned a torn "
                             f"bundle: {event['torn']}")
        if "data_bytes" not in event and event.get("data"):
            try:
                event["data_bytes"] = base64.b64decode(event["data"])
            except (TypeError, ValueError) as err:
                raise AgentError(f"agent@{self.address}: serve_prefill {rid} returned an "
                                 f"undecodable bundle: {err}") from err
        return event

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

    # -- resident profiling ---------------------------------------------------

    async def profile_start(self, profile_id: str, trace_dir: str, sid: str = "",
                            timeout: float = 60.0) -> dict:
        """Start a ``torch.profiler`` trace inside the resident runtime;
        returns the ``profile_started`` event.

        The pool server traces itself (its RPC invocations and sessions run
        in-process); the native agent forwards the command into a live
        ``--serve-child`` (``sid`` pins which one).  One trace per runtime:
        a second start is refused ``busy``."""
        command: dict = {"cmd": "profile_start", "id": profile_id, "dir": trace_dir}
        if sid:
            command["sid"] = sid
        await self._send(command)
        return await self._wait(self._profile_settled(profile_id, self._profile_started),
                                timeout)

    async def profile_stop(self, profile_id: str, artifact_dir: str = "", sid: str = "",
                           timeout: float = 120.0, discard: bool = False) -> dict:
        """Stop the active trace; returns the ``profile_stopped`` event.

        The worker packs the trace directory into one content-addressed
        ``<sha256>.profile.tgz`` under ``artifact_dir`` and announces
        ``path``/``digest``/``bytes``; the caller fetches it and checks the
        digest before trusting it.  ``discard`` (the stop of an abandoned
        capture) skips the packing: the worker deletes the trace."""
        command: dict = {"cmd": "profile_stop", "id": profile_id}
        if artifact_dir:
            command["artifact_dir"] = artifact_dir
        if sid:
            command["sid"] = sid
        if discard:
            command["discard"] = True
        await self._send(command)
        return await self._wait(self._profile_settled(profile_id, self._profile_stopped),
                                timeout)

    async def profile_wait_stopped(self, profile_id: str, timeout: float = 120.0) -> dict:
        """Wait out an in-flight stop's ``profile_stopped`` without sending
        the command again (a second stop during the packing is refused, and
        would leave the artifact unclaimed)."""
        return await self._wait(self._profile_settled(profile_id, self._profile_stopped),
                                timeout)

    def _profile_settled(self, profile_id: str, table: dict):
        def settled(c: "AgentClient"):
            if profile_id in c._profile_errors:
                event = c._profile_errors.pop(profile_id)
                raise AgentError(f"agent@{c.address}: profile {profile_id} failed "
                                 f"({event.get('code')}): {event.get('message')}")
            return table.pop(profile_id, None)

        return settled

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
        for key in [k for k in self._serve_attached if k.partition(":")[2].startswith(f"{sid}/")]:
            del self._serve_attached[key]

    async def wait_dead(self) -> None:
        """Block until this channel dies, then raise :class:`AgentError`:
        the session supervisor's cue to reconnect."""
        await self._wait(lambda c: None, None)
