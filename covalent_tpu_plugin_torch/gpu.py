"""``GPUExecutor``: dispatch an electron to a GPU worker and bring back its result.

Counterpart of ``covalent_tpu_plugin/tpu.py``'s ``TPUExecutor`` in launch
mode over the local transport: stage the pickled ``(fn, args, kwargs)`` and
a task spec, upload them with this package's own ``harness.py``, launch the
harness detached, poll until its result file appears (or its process dies),
fetch and unpickle ``(result, exception)``, clean up on both sides, and
re-raise a remote exception locally.

Each ``run`` is one root span (``executor.task``) with a child per stage:
``stage``, ``upload``, ``submit``, ``poll``, ``fetch`` and ``cleanup``, plus
``execute``, the electron's own runtime as the harness measured it.
``last_timings`` then holds each stage's seconds, ``total``, ``overhead``
(the stages but ``execute``) and ``wall_overhead`` (``total`` minus
``execute``), the reference's dispatch-overhead accounting
(``tpu.py:4211-4243``).

With ``use_agent="pool"`` the executor also keeps a resident pool server
per worker (the port's ``harness.py --serve``, started lazily and proved by
a ping before each use): the runtime that ``serving.open_session`` opens
its sessions on.  Electrons still run detached in launch mode: the pool's
``run`` verb and RPC mode come with slice 5.

The native C++ agent comes with ROADMAP item 2c; the content-addressed
cache, fleet, retries, the ops endpoint, the SSH transport and
multi-process gangs with later slices.
"""

from __future__ import annotations

import asyncio
import json
import os
import shlex
import uuid
from enum import Enum
from pathlib import Path
from typing import Any, Callable, NamedTuple

from . import harness as _harness_module
from .agent import AgentClient, AgentError, start_pool_server
from .executor_base import RemoteExecutor
from .obs import events as obs_events
from .obs.metrics import REGISTRY
from .obs.trace import Span, record_span
from .transport import LocalTransport, Transport, TransportError
from .utils.config import get_config, update_config
from .utils.log import app_log
from .utils.serialize import dump_task, load_result

# Plugin identity: the hook Covalent's loader keys on (pattern: ssh.py:34).
EXECUTOR_PLUGIN_NAME = "GPUExecutor"

# Defaults merged into the config under [executors.gpu]
# (pattern: _EXECUTOR_PLUGIN_DEFAULTS, ssh.py:39-50).
_EXECUTOR_PLUGIN_DEFAULTS = {
    "transport": "local",
    "cache_dir": os.path.join("~", ".cache", "covalent-gpu"),
    "remote_cache": ".cache/covalent-gpu",
    "remote_workdir": "covalent_gpu_workdir",
    "create_unique_workdir": False,
    "python_path": "python3",
    "poll_freq": 0.5,
    "task_timeout": 0.0,
    "task_env": {},
    "do_cleanup": True,
    "profile_dir": "",
    "use_agent": False,
}

_TASKS_TOTAL = REGISTRY.counter(
    "covalent_tpu_tasks_total",
    "Electron outcomes by terminal state",
    ("outcome",),
)
_ACTIVE_ELECTRONS = REGISTRY.gauge(
    "covalent_tpu_active_electrons",
    "Electrons currently inside GPUExecutor.run()",
)
_OVERHEAD_HIST = REGISTRY.histogram(
    "covalent_tpu_dispatch_overhead_seconds",
    "Per-electron dispatch overhead (lifecycle stages minus execute)",
)
_WALL_OVERHEAD_HIST = REGISTRY.histogram(
    "covalent_tpu_wall_overhead_seconds",
    "Per-electron wall-clock dispatch overhead (elapsed minus execute)",
)

#: Stages that are the electron's own work, not dispatch overhead.
_NOT_OVERHEAD = ("execute", "profile")


class TaskStatus(str, Enum):
    """Remote task state from one combined status round-trip."""

    READY = "READY"          # result file exists
    RUNNING = "RUNNING"      # process alive, no result yet
    STARTING = "STARTING"    # no result, no pid file yet (launch window)
    DEAD = "DEAD"            # process gone and no result -> failure
    TIMEOUT = "TIMEOUT"      # task_timeout expired while RUNNING


class StagedTask:
    """Paths produced by staging one task (reference: ``ssh.py:173-179``)."""

    def __init__(self, operation_id: str, cache_dir: Path, remote_cache: str):
        self.operation_id = operation_id
        self.function_file = str(cache_dir / f"function_{operation_id}.pkl")
        self.spec_file = str(cache_dir / f"spec_{operation_id}.json")
        self.local_result_file = str(cache_dir / f"result_{operation_id}.pkl")
        self.remote_function_file = f"{remote_cache}/function_{operation_id}.pkl"
        self.remote_harness_file = f"{remote_cache}/harness_{operation_id}.py"
        self.remote_spec_file = f"{remote_cache}/spec_{operation_id}.json"
        self.remote_result_file = f"{remote_cache}/result_{operation_id}.pkl"
        self.remote_log_file = f"{remote_cache}/log_{operation_id}.txt"
        self.remote_pid_file = f"{remote_cache}/pid_{operation_id}"

    def uploads(self) -> list[tuple[str, str]]:
        return [
            (self.function_file, self.remote_function_file),
            (_harness_module.__file__, self.remote_harness_file),
            (self.spec_file, self.remote_spec_file),
        ]

    def local_files(self) -> list[str]:
        return [self.function_file, self.spec_file, self.local_result_file]

    def remote_files(self) -> list[str]:
        return [remote for _, remote in self.uploads()] + [
            self.remote_result_file, self.remote_log_file, self.remote_pid_file,
        ]


class GangLease(NamedTuple):
    """The warmed channels of one lease: one per worker, with its address."""

    conns: list[Transport]
    addresses: list[str]


class GPUExecutor(RemoteExecutor):
    """Executor plugin: ``@ct.electron(executor=GPUExecutor(...))``.

    ``task_env`` travels in the task spec and is applied in the worker before
    the electron runs (``CUDA_VISIBLE_DEVICES`` pins the card there);
    ``profile_dir`` traces the electron with ``torch.profiler`` into
    ``{profile_dir}/{operation_id}/trace.json`` on the worker.

    ``use_agent="pool"`` enables the resident pool server (serving
    sessions); ``task_env`` is in its environment from the start.

    An argument left at None takes ``get_config("executors.gpu.<key>")``,
    else the default in ``_EXECUTOR_PLUGIN_DEFAULTS``: that is how
    ``executor="gpu"`` builds one.
    """

    SHORT_NAME = "gpu"

    #: How long a task may stay STARTING (no result, no pid file) before it
    #: is declared DEAD.
    STARTING_GRACE_S = 30.0

    #: How long a cached pool server may take to answer the ping that
    #: proves it before each use.
    AGENT_PING_TIMEOUT_S = 15.0

    def __init__(
        self,
        transport: str | None = None,
        cache_dir: str | None = None,
        remote_cache: str | None = None,
        remote_workdir: str | None = None,
        create_unique_workdir: bool | None = None,
        python_path: str | None = None,
        poll_freq: float | None = None,
        task_timeout: float | None = None,
        task_env: dict[str, str] | None = None,
        do_cleanup: bool | None = None,
        profile_dir: str | None = None,
        use_agent: bool | str | None = None,
    ) -> None:
        def resolve(value, key):
            if value is not None:
                return value
            return get_config(f"executors.gpu.{key}", _EXECUTOR_PLUGIN_DEFAULTS[key])

        transport = resolve(transport, "transport")
        use_agent = resolve(use_agent, "use_agent")
        if transport != "local":
            raise NotImplementedError(
                f"transport={transport!r} is not ported yet: the SSH transport "
                "comes with slice 5 (the rest of the executor)"
            )
        if use_agent not in (False, "pool"):
            raise NotImplementedError(
                f"use_agent={use_agent!r} is not ported yet: the native agent comes "
                "with ROADMAP item 2c; use_agent='pool' is the resident runtime"
            )
        super().__init__(poll_freq=resolve(poll_freq, "poll_freq"),
                         remote_cache=resolve(remote_cache, "remote_cache"))
        self.cache_dir = str(Path(resolve(cache_dir, "cache_dir")).expanduser().resolve())
        self.remote_workdir = resolve(remote_workdir, "remote_workdir")
        self.create_unique_workdir = bool(resolve(create_unique_workdir, "create_unique_workdir"))
        self.python_path = resolve(python_path, "python_path")
        self.task_timeout = float(resolve(task_timeout, "task_timeout"))
        self.task_env = dict(resolve(task_env, "task_env") or {})
        self.do_cleanup = bool(resolve(do_cleanup, "do_cleanup"))
        self.profile_dir = resolve(profile_dir, "profile_dir")
        self.use_agent = use_agent
        #: the stage timings of the last ``run`` (module docstring).
        self.last_timings: dict[str, float] = {}
        #: operation ids inside ``run``, and the PIDs of their running harnesses.
        self._active_ops: set[str] = set()
        self._pids: dict[str, int] = {}
        #: operation ids a caller cancelled: their runs end in CancelledError.
        self._cancelled_ops: set[str] = set()
        #: address -> the pooled channel and its resident pool server.
        self._transports: dict[str, Transport] = {}
        self._agents: dict[str, AgentClient] = {}
        self._agent_locks: dict[str, asyncio.Lock] = {}
        #: sid -> live serving-session supervisor (``serve_sessions``).
        self._serve_handles: dict[str, Any] = {}

    # ------------------------------------------------------------------ #
    # Stage / upload / submit                                             #
    # ------------------------------------------------------------------ #

    async def _validate_credentials(self) -> bool:
        return True  # the local transport needs none

    def _write_function_files(
        self, operation_id: str, fn: Callable, args: tuple, kwargs: dict,
        workdir: str, pip_deps=(),
    ) -> StagedTask:
        """Stage the function pickle and the task spec locally
        (reference: ``ssh.py:126-179``)."""
        Path(self.cache_dir).mkdir(parents=True, exist_ok=True)
        staged = StagedTask(operation_id, Path(self.cache_dir), self.remote_cache)
        dump_task(fn, args, kwargs, staged.function_file)
        spec: dict[str, Any] = {
            "operation_id": operation_id,
            "function_file": staged.remote_function_file,
            "result_file": staged.remote_result_file,
            "workdir": workdir,
            "pid_file": staged.remote_pid_file,
        }
        if self.task_env:
            spec["env"] = self.task_env
        if self.profile_dir:
            spec["profile_dir"] = f"{self.profile_dir}/{operation_id}"
        if pip_deps:
            # installed by the harness before it unpickles the function
            spec["pip_deps"] = list(pip_deps)
        with open(staged.spec_file, "w") as f:
            json.dump(spec, f)
        return staged

    async def _upload_task(self, conn: Transport, staged: StagedTask) -> None:
        """Ship the staged files (reference: ``ssh.py:337-361``)."""
        result = await conn.run(f"mkdir -p {shlex.quote(self.remote_cache)}")
        if result.exit_status != 0:
            raise TransportError(
                f"cannot create {self.remote_cache}: {result.stderr.strip()}"
            )
        for local, remote in staged.uploads():
            await conn.put(local, remote)

    def _task_command(self, staged: StagedTask) -> str:
        # `exec` makes the harness replace the wrapper shell, so the PID
        # captured at launch is the python process itself.
        return (
            f"exec {self.python_path} {shlex.quote(staged.remote_harness_file)} "
            f"{shlex.quote(staged.remote_spec_file)}"
        )

    async def submit_task(self, conn: Transport, staged: StagedTask) -> int:
        """Launch the harness detached; return its PID."""
        launch = (
            f"nohup sh -c {shlex.quote(self._task_command(staged))} "
            f"> {shlex.quote(staged.remote_log_file)} 2>&1 & echo $!"
        )
        result = await conn.run(launch)
        if result.exit_status != 0:
            raise TransportError(
                f"submit failed on {conn.address}: {result.stderr.strip()}"
            )
        try:
            return int(result.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError) as err:
            raise TransportError(
                f"submit on {conn.address} returned no PID: {result.stdout!r}"
            ) from err

    # ------------------------------------------------------------------ #
    # Status / poll / fetch / cancel / cleanup                            #
    # ------------------------------------------------------------------ #

    async def get_status(self, conn: Transport, staged: StagedTask,
                         pid: int | None) -> TaskStatus:
        """Combined result-exists + process-alive probe, one round trip.

        Zombie-aware: ``kill -0`` answers true for a zombie, and a
        nohup-launched harness can stay one on hosts without a reaping
        init, so the probe reads the process state first.  A process found
        gone is checked for its result once more: it may have written it and
        exited between the first check and the liveness test, and once it is
        gone the second check cannot miss it.
        """
        result_file = shlex.quote(staged.remote_result_file)
        gone = f"if test -f {result_file}; then echo READY; else echo DEAD; fi"
        if pid is not None:
            liveness = (
                f"elif ps -o state= -p {pid} 2>/dev/null | grep -q Z; "
                f"then {gone}; "
                f"elif kill -0 {pid} 2>/dev/null; then echo RUNNING; "
            )
        else:
            quoted = shlex.quote(staged.remote_pid_file)
            liveness = (
                f"elif test -s {quoted}; then "
                f"if kill -0 \"$(cat {quoted})\" 2>/dev/null; "
                f"then echo RUNNING; else {gone}; fi; "
                "elif true; then echo STARTING; "
            )
        probe = (
            f"if test -f {result_file}; then echo READY; "
            + liveness + f"else {gone}; fi"
        )
        result = await conn.run(probe)
        lines = result.stdout.strip().splitlines()
        try:
            return TaskStatus(lines[-1] if lines else "")
        except ValueError:
            raise TransportError(
                f"status probe on {conn.address} failed: {result.stderr.strip()!r}"
            )

    async def _poll_task(self, conn: Transport, staged: StagedTask,
                         pid: int | None) -> TaskStatus:
        """Adaptive wait for the result: the interval starts at 50 ms and
        doubles up to ``poll_freq``; STARTING is tolerated for
        ``STARTING_GRACE_S``; ``task_timeout`` (0 = none) ends in TIMEOUT."""
        interval, waited, starting_for = 0.05, 0.0, 0.0
        while True:
            status = await self.get_status(conn, staged, pid)
            if status not in (TaskStatus.RUNNING, TaskStatus.STARTING):
                return status
            if status is TaskStatus.STARTING:
                if starting_for >= self.STARTING_GRACE_S:
                    return TaskStatus.DEAD
                starting_for += interval
            if self.task_timeout and waited >= self.task_timeout:
                return TaskStatus.TIMEOUT
            await asyncio.sleep(interval)
            waited += interval
            interval = min(interval * 2, float(self.poll_freq))

    async def query_result(self, conn: Transport, staged: StagedTask):
        """Fetch and unpickle ``(result, exception, times)``
        (reference: ``ssh.py:434-458``)."""
        await conn.get(staged.remote_result_file, staged.local_result_file)
        return load_result(staged.local_result_file)

    async def _remote_log_tail(self, conn: Transport, staged: StagedTask) -> str:
        result = await conn.run(f"tail -n 50 {shlex.quote(staged.remote_log_file)}")
        return result.stdout.strip()

    @staticmethod
    async def _kill_group(conn: Transport, pid: int) -> None:
        """TERM the harness's process group (it is a session leader), so the
        electron's own subprocesses die too.  ``-s TERM -- -pid``: dash's
        kill builtin rejects ``-TERM -- -pid``."""
        await conn.run(f"kill -s TERM -- -{pid} 2>/dev/null || kill -s TERM {pid} 2>/dev/null; true")

    async def _kill(self, conn: Transport, staged: StagedTask) -> None:
        """``run``'s own teardown of its harness (timeout, cancellation)."""
        pid = self._pids.get(staged.operation_id)
        if pid is not None:
            await self._kill_group(conn, pid)

    async def cancel(self, operation_id: str | None = None, mark: bool = True) -> None:
        """Kill the harness of every run whose operation id is
        ``operation_id`` or starts with ``f"{operation_id}_"`` (every run
        when None); the reference's signature (``tpu.py:3046``).

        The workflow runner cancels a node as ``f"{dispatch_id}_{node_id}"``,
        which prefixes that node's uuid-suffixed operation ids.  ``mark``
        records the cancel first, so the killed run ends in
        ``asyncio.CancelledError`` and not in a task failure, and a run that
        has not launched its harness yet stops before it does.
        """
        targets = [op for op in self._active_ops
                   if operation_id is None or op == operation_id
                   or op.startswith(f"{operation_id}_")]
        if mark:
            self._cancelled_ops.update(targets)
        pids = [self._pids[op] for op in targets if op in self._pids]
        if not pids:
            return
        conn = LocalTransport()
        try:
            for pid in pids:
                await self._kill_group(conn, pid)
        finally:
            await conn.close()

    async def cleanup(self, conn: Transport, staged: StagedTask) -> None:
        """Delete the operation's staged files locally and on the worker
        (reference: ``ssh.py:284-315``)."""
        for path in staged.local_files():
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
        result = await conn.remove(staged.remote_files())
        if result.exit_status != 0:
            app_log.warning("cleanup on %s: %s", conn.address, result.stderr.strip())

    # ------------------------------------------------------------------ #
    # Resident pool servers (reference: tpu.py lease_gang, _agent_for,   #
    # _discard_workers, close)                                            #
    # ------------------------------------------------------------------ #

    def serve_sessions(self) -> dict[str, dict[str, Any]]:
        """sid -> live serving-session view (state, slots, queue depth,
        tokens/s)."""
        return {sid: handle.status() for sid, handle in list(self._serve_handles.items())}

    def _worker_addresses(self) -> list[str]:
        return ["localhost"]  # the local transport's one worker

    async def lease_gang(self, dialed: list[Transport] | None = None) -> GangLease:
        """Connect to every worker and warm its pool server.

        ``dialed`` receives the channels as soon as they exist, before the
        warm-up can fail, so a caller that discards a failed attempt's
        channels holds them either way.
        """
        addresses = self._worker_addresses()
        conns = [self._transports.setdefault(a, LocalTransport()) for a in addresses]
        if dialed is not None:
            dialed.extend(conns)
        await asyncio.gather(*(self._agent_for(c) for c in conns))
        return GangLease(conns, addresses)

    async def _agent_for(self, conn: Transport) -> AgentClient | None:
        """A live pool server for this worker (None with ``use_agent`` off).

        A cached server is proved by a ping before it is handed out; one
        that fails it is replaced.  One start at a time per worker.
        """
        if not self.use_agent:
            return None
        lock = self._agent_locks.setdefault(conn.address, asyncio.Lock())
        async with lock:
            client = self._agents.get(conn.address)
            if client is not None:
                if client.alive:
                    try:
                        await client.ping(self.AGENT_PING_TIMEOUT_S)
                        return client
                    except AgentError as err:
                        app_log.warning("worker %s: cached pool server failed ping (%s); "
                                        "restarting it", conn.address, err)
                await client.close()
                self._agents.pop(conn.address, None)
            client = await start_pool_server(
                conn, self.remote_cache, self.python_path, env=self.task_env
            )
            self._agents[conn.address] = client
            return client

    async def _discard_workers(self, conns: list[Transport] | None = None) -> None:
        """Drop the pooled channels (``None``: all of them) and their pool
        servers after a control-plane failure, so the next lease starts
        fresh ones."""
        for address, conn in list(self._transports.items()):
            if conns is not None and not any(conn is c for c in conns):
                continue
            self._transports.pop(address, None)
            client = self._agents.pop(address, None)
            if client is not None:
                await client.close()
            await conn.close()

    async def close(self) -> None:
        """Shut every pool server down and release the channels."""
        await self._discard_workers()

    # ------------------------------------------------------------------ #
    # Orchestration                                                       #
    # ------------------------------------------------------------------ #

    async def run(
        self,
        function: Callable,
        args: list | tuple,
        kwargs: dict,
        task_metadata: dict,
    ) -> Any:
        """Full electron lifecycle (reference orchestrator: ``ssh.py:466-591``),
        one span per stage (module docstring)."""
        dispatch_id = task_metadata.get("dispatch_id", "dispatch")
        node_id = task_metadata.get("node_id", 0)
        operation_id = f"{dispatch_id}_{node_id}_{uuid.uuid4().hex[:8]}"
        workdir = self.remote_workdir
        if self.create_unique_workdir:
            workdir = os.path.join(self.remote_workdir, dispatch_id, f"node_{node_id}")

        root = Span("executor.task", {"operation_id": operation_id,
                                      "dispatch_id": dispatch_id, "node_id": node_id})
        root.__enter__()
        self._active_ops.add(operation_id)
        _ACTIVE_ELECTRONS.inc()
        obs_events.emit("task.state", operation_id=operation_id, state="starting",
                        trace_id=root.trace_id)
        outcome = "failed"
        try:
            await self._validate_credentials()
            with Span("executor.stage"):
                staged = await asyncio.to_thread(
                    self._write_function_files, operation_id, function,
                    tuple(args or ()), dict(kwargs or {}), workdir,
                    task_metadata.get("pip_deps", ()),
                )
            result, exception = await self._run_staged(root, staged)
            if exception is not None:
                # Re-raise the remote exception locally (ssh.py:581-583).
                outcome = "remote_exception"
                raise exception
            outcome = "completed"
            return result
        except asyncio.CancelledError:
            outcome = "cancelled"
            raise
        finally:
            self._active_ops.discard(operation_id)
            self._cancelled_ops.discard(operation_id)
            self._epilogue(root, outcome, operation_id)

    async def _run_staged(self, root: Span, staged: StagedTask):
        """Upload, launch, wait for, fetch and clean up one staged task:
        ``(result, exception)``."""
        operation_id = staged.operation_id
        conn = LocalTransport()
        try:
            with Span("executor.upload"):
                await self._upload_task(conn, staged)
            if operation_id in self._cancelled_ops:
                raise asyncio.CancelledError(f"task {operation_id} cancelled")
            with Span("executor.submit"):
                pid = self._pids[operation_id] = await self.submit_task(conn, staged)
            try:
                with Span("executor.poll"):
                    status = await self._poll_task(conn, staged, pid)
            except asyncio.CancelledError:
                await self._kill(conn, staged)
                raise
            if status is not TaskStatus.READY:
                if operation_id in self._cancelled_ops:
                    raise asyncio.CancelledError(f"task {operation_id} cancelled")
                if status is TaskStatus.TIMEOUT:
                    await self._kill(conn, staged)
                log_tail = await self._remote_log_tail(conn, staged)
                raise RuntimeError(
                    f"remote task {operation_id} failed on {conn.address} "
                    f"({status.value}); log tail:\n{log_tail}"
                )
            with Span("executor.fetch"):
                result, exception, times = await self.query_result(conn, staged)
            if times:
                # The electron's own runtime, as the harness measured it.  The
                # poll span waited for it too: what the poll adds beyond it
                # (the worker's start, its imports, the result write and the
                # poll interval) stays the poll stage's.
                execute = max(0.0, times["end"] - times["start"])
                record_span("executor.execute", trace_id=root.trace_id,
                            parent_id=root.span_id, start_ts=times["start"],
                            duration_s=execute)
                stages = root.stage_durations
                stages["execute"] = execute
                stages["poll"] = max(0.0, stages.get("poll", 0.0) - execute)
            return result, exception
        finally:
            self._pids.pop(operation_id, None)
            if self.do_cleanup:
                with Span("executor.cleanup"):
                    await self.cleanup(conn, staged)
            await conn.close()

    def _epilogue(self, root: Span, outcome: str, operation_id: str) -> None:
        """Terminal accounting on every exit path (``tpu.py:4211-4243``)."""
        root.set_attribute("outcome", outcome)
        if outcome != "completed":
            root.record_error(outcome)
        root.end()
        overhead = root.overhead(exclude=_NOT_OVERHEAD)
        wall_overhead = max(0.0, root.total() - sum(
            root.stage_durations.get(stage, 0.0) for stage in _NOT_OVERHEAD))
        self.last_timings = root.summary()
        self.last_timings["overhead"] = overhead
        self.last_timings["wall_overhead"] = wall_overhead
        _ACTIVE_ELECTRONS.dec()
        _TASKS_TOTAL.labels(outcome=outcome).inc()
        _OVERHEAD_HIST.observe(overhead)
        _WALL_OVERHEAD_HIST.observe(wall_overhead)
        obs_events.emit(
            "task.state", operation_id=operation_id, state=outcome,
            trace_id=root.trace_id, overhead_s=round(overhead, 6),
            total_s=round(root.total(), 6),
        )


update_config(_EXECUTOR_PLUGIN_DEFAULTS, section="executors.gpu")
