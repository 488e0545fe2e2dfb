"""``GPUExecutor``: dispatch an electron to a GPU worker and bring back its result.

Counterpart of ``covalent_tpu_plugin/tpu.py``'s ``TPUExecutor`` over the
local transport.  Each electron takes one of two roads (``dispatch_mode``):

* **launch**: stage the pickled ``(fn, args, kwargs)`` and a task spec,
  upload them with this package's own ``harness.py``, start the harness,
  wait for it to exit, fetch and unpickle ``(result, exception)``, clean up
  on both sides, and re-raise a remote exception locally.  With the
  resident runtime on (``use_agent``, the default) the harness runs as a
  fork of the pool server's zygote (the pool's ``run`` verb), an
  interpreter that has already imported ``torch`` and this package, and
  its exit is pushed over the channel; without it, a fresh interpreter is
  started detached with ``nohup`` and polled.
* **rpc**: execute by digest inside the warm pool server itself.  The
  function's cloudpickle is shipped once per connection into the worker's
  content-addressed store and registered once per digest; each electron is
  then one ``invoke`` with its args inline (or staged in the store when
  larger than ``rpc_inline_args_max``) and one pushed ``result``.

Each ``run`` is one root span (``executor.task``) with a child per stage:
``stage``, ``upload``, ``connect`` (the pool server's start or its ping),
``submit``, ``poll``, ``fetch`` and ``cleanup``, plus ``execute``, the
electron's own runtime as the harness measured it, in either road.
``last_timings`` then holds each stage's seconds, ``total``, ``overhead``
(the stages but ``execute``) and ``wall_overhead`` (``total`` minus
``execute``), the reference's dispatch-overhead accounting
(``tpu.py:4211-4243``).

The pool server is also the runtime ``serving.open_session``,
``open_replica_set`` and ``open_disaggregated_set`` open their sessions
on.  Its channel negotiates binary frames at connect (``agent_frames``,
default True; ``COVALENT_TPU_AGENT_FRAMES`` overrides): RPC args and
results, KV bundles and streamed tokens then ride raw frame bodies, and a
channel that stays on JSON lines gives byte-equal results.

Gangs: ``workers=["w0", "w1", ...]`` runs each electron as that many
processes, one a worker, joined by a ``torch.distributed`` process group
(the harness's ``distributed`` bootstrap).  Under the local transport the
workers are processes on this machine, their names bookkeeping labels, and
they rendezvous on ``127.0.0.1:{coordinator_port}`` (``coordinator_port=0``
picks a free port per electron).  One spec is staged per process, each
with its ``distributed`` block; all of them start (pool forks or nohup
launches), and the watcher waits on process 0's result while it watches
every process: one that dies first (a failed pip install, a torn file, a
crash before the rendezvous) fails the task at once with its index and
worker blamed, and the others are killed.  A gang always takes the launch
road.

Crash recovery: with ``COVALENT_TPU_JOURNAL_DIR`` set, each electron's
intent, placement and outcome go to the control-plane journal
(``fleet/journal.py``), every pool channel is fenced with the journal's
epoch, and a pool server that a dead dispatcher orphaned is adopted
(``pool_orphan.json`` and the ``--attach`` relay) before a fresh one is
started; :meth:`GPUExecutor.recover` then re-adopts its sessions and
streams (``fleet/recovery.py``).  A journaled electron that was in flight
is reported, not run again: the checkpoint-resume discovery of the
reference (``_discover_resume``) comes with ``utils/checkpoint.py`` in
slice 5b.  The native
C++ agent comes with ROADMAP item 2c.6; the SSH
transport, the result cache, fleet, task retries and the ops endpoint
with slice 5b; gangs over several hosts need it too.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import os
import pickle
import shlex
import socket
import time
import uuid
from enum import Enum
from pathlib import Path
from typing import Any, Callable, NamedTuple

import cloudpickle

from . import harness as _harness_module
from .agent import (
    POOL_PRELOAD,
    AgentClient,
    AgentError,
    attach_pool_server,
    read_orphan_rendezvous,
    start_pool_server,
)
from .cache import CASIndex, FnRegistry, bytes_digest, cas_path
from .executor_base import RemoteExecutor
from .fleet import journal as journal_mod
from .obs import events as obs_events
from .obs.metrics import REGISTRY
from .obs.trace import Span, record_span
from .resilience import FaultClass, classify_error, tag_fault
from .transport import LocalTransport, Transport, TransportError
from .transport.frames import FrameIntegrityError
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
    # The resident runtime (the reference's default, tpu.py:158): True or
    # "auto" try the pool server and fall back to nohup + poll when it
    # cannot start; "pool" pins it; False or "off" never start it.
    "use_agent": True,
    # "launch" runs every electron as a harness process (a zygote fork with
    # the pool on); "auto" and "rpc" execute eligible electrons by digest
    # inside the pool server (tpu.py:169).  COVALENT_TPU_DISPATCH_MODE
    # overrides per process, electron metadata ("dispatch_mode") per electron.
    "dispatch_mode": "launch",
    # RPC args and results up to this many pickled bytes ride the channel;
    # larger ones are staged by digest (tpu.py:173).
    # COVALENT_TPU_RPC_INLINE_MAX overrides.
    "rpc_inline_args_max": 64 * 1024,
    # Modules the pool server and its zygote import at start-up.
    "pool_preload": POOL_PRELOAD,
    # Binary frames on the pool server's channel (tpu.py:197-204), negotiated
    # at connect; COVALENT_TPU_AGENT_FRAMES overrides.  Either side
    # declining keeps the channel on JSON lines, with byte-equal results.
    "agent_frames": True,
    # Gang workers (tpu.py:123): one process each, joined by a process
    # group; [] runs one process.  Local-transport workers are processes on
    # this machine named by these labels.
    "workers": [],
    # The gang's rendezvous port on the coordinator (tpu.py:155); 0 picks
    # a free one per electron (local transport).
    "coordinator_port": 8476,
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

_DISPATCH_MODES = ("launch", "auto", "rpc")


class _RpcUnavailable(Exception):
    """Internal control flow: the worker has no live pool runtime to
    execute by digest.  ``run`` takes the launch road for the same electron
    and emits ``task.rpc_fallback``."""


class TaskStatus(str, Enum):
    """Remote task state from one combined status round-trip."""

    READY = "READY"          # result file exists
    RUNNING = "RUNNING"      # process alive, no result yet
    STARTING = "STARTING"    # no result, no pid file yet (launch window)
    DEAD = "DEAD"            # process gone and no result -> failure
    TIMEOUT = "TIMEOUT"      # task_timeout expired while RUNNING


class StagedTask:
    """Paths produced by staging one task (reference: ``ssh.py:173-179``).

    A gang of ``processes`` > 1 has a spec, a log and a pid file per
    process (``..._{i}``) and the done markers of processes 1.. beside the
    one result file (:meth:`rank`); a single process keeps the plain names.
    """

    def __init__(self, operation_id: str, cache_dir: Path, remote_cache: str,
                 processes: int = 1):
        self.operation_id = operation_id
        self.processes = processes
        self.function_file = str(cache_dir / f"function_{operation_id}.pkl")
        self.spec_file = str(cache_dir / f"spec_{operation_id}.json")
        self.local_result_file = str(cache_dir / f"result_{operation_id}.pkl")
        self.remote_function_file = f"{remote_cache}/function_{operation_id}.pkl"
        self.remote_harness_file = f"{remote_cache}/harness_{operation_id}.py"
        self.remote_spec_file = f"{remote_cache}/spec_{operation_id}.json"
        self.remote_result_file = f"{remote_cache}/result_{operation_id}.pkl"
        self.remote_log_file = f"{remote_cache}/log_{operation_id}.txt"
        self.remote_pid_file = f"{remote_cache}/pid_{operation_id}"

    def rank(self, i: int) -> dict[str, str]:
        """Process ``i``'s files: ``spec`` (local), ``remote_spec``, ``log``,
        ``pid`` and ``done`` (what the watcher waits on: the result file for
        process 0, ``{result}.done.{i}`` for the others)."""
        if self.processes == 1:
            return {"spec": self.spec_file, "remote_spec": self.remote_spec_file,
                    "log": self.remote_log_file, "pid": self.remote_pid_file,
                    "done": self.remote_result_file}
        return {
            "spec": self.spec_file.replace(".json", f"_{i}.json"),
            "remote_spec": self.remote_spec_file.replace(".json", f"_{i}.json"),
            "log": self.remote_log_file.replace(".txt", f"_{i}.txt"),
            "pid": f"{self.remote_pid_file}.{i}",
            "done": self.remote_result_file if i == 0 else f"{self.remote_result_file}.done.{i}",
        }

    def uploads(self) -> list[tuple[str, str]]:
        return [
            (self.function_file, self.remote_function_file),
            (_harness_module.__file__, self.remote_harness_file),
        ] + [(self.rank(i)["spec"], self.rank(i)["remote_spec"])
             for i in range(self.processes)]

    def local_files(self) -> list[str]:
        return [self.function_file, self.local_result_file] + [
            self.rank(i)["spec"] for i in range(self.processes)]

    def remote_files(self) -> list[str]:
        ranks = [self.rank(i) for i in range(self.processes)]
        return [remote for _, remote in self.uploads()] + [self.remote_result_file] + [
            f for r in ranks for f in (r["log"], r["pid"], r["done"])
            if f != self.remote_result_file]


class GangLease(NamedTuple):
    """The warmed channels of one lease: one per worker, with its address."""

    conns: list[Transport]
    addresses: list[str]


class GPUExecutor(RemoteExecutor):
    """Executor plugin: ``@ct.electron(executor=GPUExecutor(...))``.

    ``task_env`` travels in the task spec and is applied in the worker before
    the electron runs (``CUDA_VISIBLE_DEVICES`` pins the card there), and is
    in the pool server's environment from its start; ``profile_dir`` traces
    the electron with ``torch.profiler`` into
    ``{profile_dir}/{operation_id}/trace.json`` on the worker.

    ``use_agent`` (True, "auto", "pool", False or "off") and
    ``dispatch_mode`` ("launch", "auto" or "rpc") choose the road (module
    docstring); ``rpc_inline_args_max`` is the inline size limit of RPC args
    and results, ``pool_preload`` the pool server's and zygote's preloads,
    ``agent_frames`` whether its channel negotiates binary frames.

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

    #: How often a wait on a pushed result wakes to notice a cancel.
    RPC_WAKE_S = 0.5

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
        dispatch_mode: str | None = None,
        rpc_inline_args_max: int | None = None,
        pool_preload: str | None = None,
        agent_frames: bool | None = None,
        workers: list[str] | None = None,
        coordinator_port: int | None = None,
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
                "comes with slice 5b (the rest of the executor)"
            )
        if use_agent == "native":
            raise NotImplementedError(
                "use_agent='native' is not ported yet: the native agent comes with "
                "ROADMAP item 2c.6; True, 'auto' and 'pool' use the pool server"
            )
        if use_agent not in (True, False, "auto", "pool", "off"):
            raise ValueError(
                f"use_agent must be True/False/'auto'/'pool'/'off', got {use_agent!r}"
            )
        env_mode = os.environ.get("COVALENT_TPU_DISPATCH_MODE")
        if dispatch_mode is None and env_mode is not None:
            dispatch_mode = env_mode.strip().lower() or None
        dispatch_mode = str(resolve(dispatch_mode, "dispatch_mode")).lower()
        if dispatch_mode not in _DISPATCH_MODES:
            raise ValueError(
                f'dispatch_mode must be "launch", "auto" or "rpc", got {dispatch_mode!r}'
            )
        env_inline = os.environ.get("COVALENT_TPU_RPC_INLINE_MAX")
        if rpc_inline_args_max is None and env_inline is not None:
            try:
                rpc_inline_args_max = int(env_inline)
            except ValueError:
                app_log.warning("ignoring non-integer COVALENT_TPU_RPC_INLINE_MAX=%r",
                                env_inline)
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
        self.use_agent = False if use_agent == "off" else use_agent
        self.dispatch_mode = dispatch_mode
        self.rpc_inline_args_max = max(
            0, int(resolve(rpc_inline_args_max, "rpc_inline_args_max")))
        self.pool_preload = str(resolve(pool_preload, "pool_preload"))
        #: binary frames on the pool channel: argument >
        #: COVALENT_TPU_AGENT_FRAMES > config.  Declining only stops this
        #: side from negotiating; the server keeps advertising.
        env_frames = os.environ.get("COVALENT_TPU_AGENT_FRAMES")
        if agent_frames is None and env_frames is not None:
            agent_frames = env_frames.strip().lower() not in ("0", "off", "false", "no")
        self.agent_frames = bool(resolve(agent_frames, "agent_frames"))
        #: gang workers (module docstring); [] runs one process
        self.workers = [str(w) for w in (resolve(workers, "workers") or [])]
        self.coordinator_port = int(resolve(coordinator_port, "coordinator_port"))
        #: the road the most recent electron took ("rpc" or "launch")
        self.last_dispatch_mode = ""
        #: the stage timings of the last ``run`` (module docstring).
        self.last_timings: dict[str, float] = {}
        #: operation ids inside ``run``, and the PIDs of their running harnesses
        #: (process 0's, and every process's of a gang).
        self._active_ops: set[str] = set()
        self._pids: dict[str, list] = {}
        #: operation id -> its road, and the pool client it ran through
        self._op_modes: dict[str, str] = {}
        self._op_agents: dict[str, AgentClient] = {}
        #: operation ids a caller cancelled: their runs end in CancelledError.
        self._cancelled_ops: set[str] = set()
        #: address -> the pooled channel and its resident pool server (None:
        #: the server could not start; the worker launches with nohup).
        self._transports: dict[str, Transport] = {}
        self._agents: dict[str, AgentClient | None] = {}
        self._agent_locks: dict[str, asyncio.Lock] = {}
        #: per-connection artifacts the worker holds, and functions its
        #: resident runtime registered
        self._cas = CASIndex()
        self._fn_registry = FnRegistry()
        #: sid -> live serving-session supervisor (``serve_sessions``).
        self._serve_handles: dict[str, Any] = {}

    # -- RPC registry views ------------------------------------------------

    def holds_fn_digest(self, digest: str) -> bool:
        """Whether any live connection's resident runtime registered this
        function digest."""
        return bool(digest) and self._fn_registry.holds(digest)

    def rpc_digest_count(self) -> int:
        """Distinct function digests registered across the connections."""
        return len(self._fn_registry.digests())

    def in_flight_modes(self) -> dict[str, str]:
        """operation id -> dispatch road of every electron in flight."""
        return dict(self._op_modes)

    # ------------------------------------------------------------------ #
    # Stage / upload / submit                                             #
    # ------------------------------------------------------------------ #

    async def _validate_credentials(self) -> bool:
        return True  # the local transport needs none

    def _num_processes(self) -> int:
        return max(1, len(self.workers))

    def _coordinator_address(self) -> str:
        """Local-transport workers are processes on this machine; their
        labels are bookkeeping names, not hosts (tpu.py:1064-1068)."""
        port = self.coordinator_port
        if port == 0:
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
        return f"127.0.0.1:{port}"

    def _write_function_files(
        self, operation_id: str, fn: Callable, args: tuple, kwargs: dict,
        workdir: str, pip_deps=(),
    ) -> StagedTask:
        """Stage the function pickle and one task spec per process locally
        (reference: ``ssh.py:126-179``, ``tpu.py:1494-1566``)."""
        from .parallel.distributed import coordinator_spec

        Path(self.cache_dir).mkdir(parents=True, exist_ok=True)
        processes = self._num_processes()
        staged = StagedTask(operation_id, Path(self.cache_dir), self.remote_cache, processes)
        dump_task(fn, args, kwargs, staged.function_file)
        with open(staged.function_file, "rb") as f:
            function_digest = bytes_digest(f.read())
        blocks = (coordinator_spec(coordinator_address=self._coordinator_address(),
                                   num_processes=processes) if processes > 1 else None)
        for i in range(processes):
            files = staged.rank(i)
            spec: dict[str, Any] = {
                "operation_id": operation_id,
                "function_file": staged.remote_function_file,
                # checked by the harness before it unpickles (and before a
                # gang's rendezvous): a torn file fails loud, with its blame
                "function_digest": function_digest,
                "result_file": staged.remote_result_file,
                "workdir": workdir,
                "pid_file": files["pid"],
            }
            if self.task_env:
                spec["env"] = self.task_env
            if self.profile_dir:
                spec["profile_dir"] = f"{self.profile_dir}/{operation_id}"
            if pip_deps:
                # installed by the harness before it unpickles the function
                spec["pip_deps"] = list(pip_deps)
            if blocks is not None:
                spec["distributed"] = blocks[i]
            with open(files["spec"], "w") as f:
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

    def _task_command(self, staged: StagedTask, process: int = 0) -> str:
        # `exec` makes the harness replace the wrapper shell, so the PID
        # captured at launch is the python process itself.
        return (
            f"exec {self.python_path} {shlex.quote(staged.remote_harness_file)} "
            f"{shlex.quote(staged.rank(process)['remote_spec'])}"
        )

    async def submit_task(self, conn: Transport, staged: StagedTask, process: int = 0) -> int:
        """Launch one process's harness detached; return its PID."""
        launch = (
            f"nohup sh -c {shlex.quote(self._task_command(staged, process))} "
            f"> {shlex.quote(staged.rank(process)['log'])} 2>&1 & echo $!"
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
                         pid: int | None, process: int = 0) -> TaskStatus:
        """Combined result-exists + process-alive probe, one round trip.

        Zombie-aware: ``kill -0`` answers true for a zombie, and a
        nohup-launched harness can stay one on hosts without a reaping
        init, so the probe reads the process state first.  A process found
        gone is checked for its result once more: it may have written it and
        exited between the first check and the liveness test, and once it is
        gone the second check cannot miss it.
        """
        files = staged.rank(process)
        result_file = shlex.quote(files["done"])
        # a marker of process 1.. that records the electron's error is a death
        found = (f"if grep -qs '^error' {result_file}; then echo DEAD; else echo READY; fi"
                 if process else "echo READY")
        gone = f"if test -f {result_file}; then {found}; else echo DEAD; fi"
        if pid is not None:
            liveness = (
                f"elif ps -o state= -p {pid} 2>/dev/null | grep -q Z; "
                f"then {gone}; "
                f"elif kill -0 {pid} 2>/dev/null; then echo RUNNING; "
            )
        else:
            quoted = shlex.quote(files["pid"])
            liveness = (
                f"elif test -s {quoted}; then "
                f"if kill -0 \"$(cat {quoted})\" 2>/dev/null; "
                f"then echo RUNNING; else {gone}; fi; "
                "elif true; then echo STARTING; "
            )
        probe = (
            f"if test -f {result_file}; then {found}; "
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

    #: How long a gang's processes 1.. may take to leave once process 0 wrote
    #: the result (they leave the process group and write their markers).
    GANG_EXIT_GRACE_S = 60.0

    async def _poll_task(self, conn: Transport, staged: StagedTask,
                         pids: list[int | None]) -> tuple[TaskStatus, int]:
        """Wait for every process of the task: ``(status, index to blame)``
        (the reference's ``_poll_all``, ``tpu.py:2894-2905``).

        The interval starts at 50 ms and doubles up to ``poll_freq``;
        STARTING is tolerated for ``STARTING_GRACE_S``; ``task_timeout``
        (0 = none) ends in TIMEOUT.  A process 1.. found DEAD (it exited
        before its done marker, as a failed pip install does before the
        rendezvous, or its marker records the electron's error) fails the
        task at once, all or nothing, instead of leaving process 0 in a
        collective until its timeout.  Once process 0 is READY the others
        get ``GANG_EXIT_GRACE_S`` to leave, so the cleanup does not race a
        late marker; what is left after it is killed.
        """
        interval, waited, starting_for, ready_for = 0.05, 0.0, 0.0, 0.0
        while True:
            statuses = await asyncio.gather(*(
                self.get_status(conn, staged, pid, i) for i, pid in enumerate(pids)))
            for i, status in enumerate(statuses[1:], start=1):
                if status is TaskStatus.DEAD:
                    return TaskStatus.DEAD, i
            live = [i for i, st in enumerate(statuses)
                    if st in (TaskStatus.RUNNING, TaskStatus.STARTING)]
            if 0 not in live and (statuses[0] is not TaskStatus.READY or not live):
                return statuses[0], 0
            if 0 not in live:
                if ready_for >= self.GANG_EXIT_GRACE_S:
                    app_log.warning("task %s: gang processes %s still running %.0f s after "
                                    "process 0 finished; killing them", staged.operation_id,
                                    live, self.GANG_EXIT_GRACE_S)
                    await self._kill(conn, staged)
                    return TaskStatus.READY, 0
                if not ready_for:
                    interval = 0.05  # the others leave right after process 0
                ready_for += interval
            else:
                starting = [i for i in live if statuses[i] is TaskStatus.STARTING]
                if starting:
                    if starting_for >= self.STARTING_GRACE_S:
                        return TaskStatus.DEAD, starting[0]
                    starting_for += interval
                if self.task_timeout and waited >= self.task_timeout:
                    return TaskStatus.TIMEOUT, 0
            await asyncio.sleep(interval)
            waited += interval
            interval = min(interval * 2, float(self.poll_freq))

    async def query_result(self, conn: Transport, staged: StagedTask):
        """Fetch and unpickle ``(result, exception, times)``
        (reference: ``ssh.py:434-458``)."""
        await conn.get(staged.remote_result_file, staged.local_result_file)
        return load_result(staged.local_result_file)

    async def _remote_log_tail(self, conn: Transport, staged: StagedTask,
                               process: int = 0) -> str:
        result = await conn.run(f"tail -n 50 {shlex.quote(staged.rank(process)['log'])}")
        return result.stdout.strip()

    @staticmethod
    async def _kill_group(conn: Transport, pid: int) -> None:
        """TERM the harness's process group (it is a session leader), so the
        electron's own subprocesses die too.  ``-s TERM -- -pid``: dash's
        kill builtin rejects ``-TERM -- -pid``."""
        await conn.run(f"kill -s TERM -- -{pid} 2>/dev/null || kill -s TERM {pid} 2>/dev/null; true")

    async def _kill(self, conn: Transport, staged: StagedTask) -> None:
        """``run``'s own teardown of its harnesses (timeout, cancellation,
        a gang whose process failed)."""
        for pid in self._pids.get(staged.operation_id, ()):
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
        pids = [pid for op in targets for pid in self._pids.get(op, ())
                if pid is not None]
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
    # _submit_via_agent, _discard_workers, close)                         #
    # ------------------------------------------------------------------ #

    def serve_sessions(self) -> dict[str, dict[str, Any]]:
        """sid -> live serving-session view (state, slots, queue depth,
        tokens/s)."""
        return {sid: handle.status() for sid, handle in list(self._serve_handles.items())}

    def _worker_addresses(self) -> list[str]:
        return ["localhost"]  # the local transport's one worker

    @staticmethod
    def _pool_key(address: str) -> str:
        return f"local:{address}"

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
        """A live pool server for this worker, or None (``use_agent`` off,
        or the server could not start: the worker is then remembered as
        having none, and electrons launch with nohup + poll).

        A cached server is proved by a ping before it is handed out; one
        that fails it is replaced.  One start at a time per worker.
        """
        if not self.use_agent:
            return None
        lock = self._agent_locks.setdefault(conn.address, asyncio.Lock())
        async with lock:
            if conn.address in self._agents:
                client = self._agents[conn.address]
                if client is None:
                    return None
                if client.alive:
                    try:
                        await client.ping(self.AGENT_PING_TIMEOUT_S)
                        return client
                    except AgentError as err:
                        app_log.warning("worker %s: cached pool server failed ping (%s); "
                                        "restarting it", conn.address, err)
                        obs_events.emit("agent.restarted", address=conn.address,
                                        error=repr(err))
                await client.close()
                self._agents.pop(conn.address, None)
            client = await self._try_adopt_orphan(conn)
            if client is None:
                try:
                    client = await start_pool_server(
                        conn, self.remote_cache, self.python_path, env=self.task_env,
                        preload=self.pool_preload, frames_enabled=self.agent_frames,
                    )
                except (AgentError, TransportError) as err:
                    app_log.info("worker %s: no pool runtime (%s); using nohup + poll",
                                 conn.address, err)
                    obs_events.emit("agent.unavailable", address=conn.address,
                                    error=repr(err))
                    self._agents[conn.address] = None
                    return None
            self._agents[conn.address] = client
            await self._declare_epoch(client)
            obs_events.emit("agent.started", address=conn.address)
            return client

    async def _declare_epoch(self, client: AgentClient) -> None:
        """Fence this channel with the journal's dispatcher epoch (nothing
        without a journal).  Best-effort: fencing is a recovery guarantee,
        not a dispatch prerequisite."""
        epoch = journal_mod.epoch()
        if not epoch:
            return
        try:
            await client.declare_epoch(epoch, timeout=10.0)
        except (AgentError, TransportError, asyncio.TimeoutError) as err:
            app_log.debug("epoch declaration on %s failed (%s); channel unfenced",
                          client.address, err)

    async def _try_adopt_orphan(self, conn: Transport) -> AgentClient | None:
        """Re-attach a pool server a dead dispatcher orphaned, or None.

        Only with a journal (a dispatcher without one has no epoch to
        outrank the orphan's): reads ``pool_orphan.json`` from the remote
        cache, starts the ``--attach`` relay onto its socket through the
        transport, and adopts it at this incarnation's epoch.  Any failure
        (no rendezvous, a stale socket, a refused epoch) falls through to a
        fresh server, which is always correct.
        """
        journal = journal_mod.get_journal()
        if journal is None:
            return None
        meta = await read_orphan_rendezvous(conn, self.remote_cache)
        if not meta:
            return None
        if int(meta.get("epoch") or 0) >= journal.epoch:
            app_log.warning("worker %s: orphan rendezvous carries epoch %s >= ours (%s); "
                            "not adopting", conn.address, meta.get("epoch"), journal.epoch)
            return None
        try:
            client = await attach_pool_server(
                conn, self.remote_cache, self.python_path, str(meta.get("sock") or ""),
                journal.epoch, frames_enabled=self.agent_frames,
            )
        except (AgentError, TransportError, asyncio.TimeoutError) as err:
            app_log.info("worker %s: orphan adoption failed (%s); starting fresh",
                         conn.address, err)
            return None
        app_log.info("worker %s: adopted the orphaned pool server pid=%s with %d surviving "
                     "session(s)", conn.address, meta.get("pid"),
                     len(client._banner.get("sessions") or ()))
        obs_events.emit("agent.adopted", address=conn.address, pid=meta.get("pid"),
                        epoch=journal.epoch)
        return client

    async def recover(self, timeout_s: float = 120.0) -> dict:
        """Crash recovery: re-adopt what survived the previous dispatcher.

        Replays the journal's picture of the dead dispatcher's world,
        re-dials the worker (adopting its orphaned pool server and fencing
        the channel with this incarnation's epoch on the way), and
        re-attaches the surviving sessions and their in-flight streams.
        Returns a ``recovered=False`` report, touching nothing, when
        journaling is off or the journal held nothing.  See
        :mod:`.fleet.recovery`.
        """
        from .fleet import recovery as recovery_mod

        return await recovery_mod.recover(self, timeout_s=timeout_s)

    async def _discard_workers(self, conns: list[Transport] | None = None) -> None:
        """Drop the pooled channels (``None``: all of them), their pool
        servers and what the executor knew of them (the artifacts the
        worker holds, the functions its runtime registered) after a
        control-plane failure, so the next lease starts fresh ones."""
        for address, conn in list(self._transports.items()):
            if conns is not None and not any(conn is c for c in conns):
                continue
            self._transports.pop(address, None)
            client = self._agents.pop(address, None)
            if client is not None:
                await client.close()
            self._cas.forget(self._pool_key(address))
            self._fn_registry.forget(self._pool_key(address))
            await conn.close()

    async def close(self) -> None:
        """Shut every pool server down and release the channels."""
        await self._discard_workers()

    async def _resident_client(self, dialed: list[Transport]) -> AgentClient | None:
        """The worker's live pool server (None without one), inside the
        ``connect`` stage: the server's start on first use, a ping after."""
        with Span("executor.connect"):
            lease = await self.lease_gang(dialed=dialed)
        client = self._agents.get(lease.conns[0].address)
        return client if client is not None and client.alive else None

    @staticmethod
    def _task_id(staged: StagedTask, process: int) -> str:
        """The pool's id of one process of the task (process 0: the operation id)."""
        return staged.operation_id if process == 0 else f"{staged.operation_id}.{process}"

    async def _submit_via_agent(self, client: AgentClient, conn: Transport,
                                staged: StagedTask, process: int = 0) -> int:
        """Start one process's staged harness as a fork of the pool's zygote;
        returns its pid.  The task's files are those of a nohup launch, so
        every probe (pid liveness, result file, kill by pid) still works if
        the channel dies later."""
        files = staged.rank(process)
        try:
            return await client.run_task(self._task_id(staged, process),
                                         spec=files["remote_spec"], log=files["log"])
        except AgentError as err:
            if not getattr(err, "maybe_started", False):
                raise
            # The run command reached the worker before the channel failed:
            # the task may be alive there, and a second launch would run it
            # twice.  Kill it by the pid file it writes first thing, over a
            # short grace window, and fail this launch.
            pid_file = shlex.quote(files["pid"])
            reap = (f"if [ -s {pid_file} ]; then kill -s TERM -- -$(cat {pid_file}) "
                    f"2>/dev/null || kill -s TERM $(cat {pid_file}) 2>/dev/null; "
                    "echo KILLED; fi")
            for _ in range(4):
                if "KILLED" in (await conn.run(reap)).stdout:
                    break
                await asyncio.sleep(0.5)
            raise TransportError(
                f"pool submit on {conn.address} failed after the run command was sent: {err}"
            ) from err

    async def _await_agent_exit(self, client: AgentClient, conn: Transport,
                                staged: StagedTask, pid: int) -> TaskStatus:
        """Wait for the pushed ``exit`` event instead of polling.

        The exit resolves the task through the result file (the polling
        road's READY); a task whose exit the server could not see (its
        zygote died) or a channel that died meanwhile falls back to the
        status probes, which the task's own files answer.
        """
        waiter = asyncio.ensure_future(client.wait_exit(staged.operation_id))
        try:
            done, _ = await asyncio.wait({waiter}, timeout=self.task_timeout or None)
            if not done:
                return TaskStatus.TIMEOUT
            try:
                waiter.result()
            except AgentError as err:
                app_log.info("task %s: pool channel died (%s); polling its files",
                             staged.operation_id, err)
                return (await self._poll_task(conn, staged, [pid]))[0]
        finally:
            waiter.cancel()
            try:
                await waiter
            except (asyncio.CancelledError, AgentError):
                pass
        status = await self.get_status(conn, staged, pid)
        if status in (TaskStatus.RUNNING, TaskStatus.STARTING):
            return (await self._poll_task(conn, staged, [pid]))[0]
        return status

    # ------------------------------------------------------------------ #
    # Orchestration                                                       #
    # ------------------------------------------------------------------ #

    def _resolve_dispatch_mode(self, task_metadata: dict) -> str:
        """An electron's mode: its metadata's ``dispatch_mode``, else the
        executor's.  An invalid metadata value keeps the executor's mode,
        with a warning."""
        raw = task_metadata.get("dispatch_mode")
        if raw is not None:
            mode = str(raw).strip().lower()
            if mode in _DISPATCH_MODES:
                return mode
            app_log.warning('ignoring invalid electron dispatch_mode %r (expected "launch", '
                            '"auto" or "rpc"); using %r', raw, self.dispatch_mode)
        return self.dispatch_mode

    def _rpc_preselect(self, task_metadata: dict) -> bool:
        """Whether an electron takes the RPC road, decided before it starts.

        RPC runs the electron inside the shared resident process, so it is
        kept to what that process can serve faithfully: an agent policy
        that allows the pool runtime, no pip installs (they change the
        process), and no ``profile_dir``.  The reference profiles an RPC
        electron inside its runtime with ``profile_start``/``profile_stop``;
        in the port those verbs come with ROADMAP item 2c.5, so a profiled
        electron launches.  The worker's lack of a live runtime is found
        later and falls back through :class:`_RpcUnavailable`.
        """
        if self._resolve_dispatch_mode(task_metadata) == "launch":
            return False
        if self._num_processes() > 1:
            return False  # a gang's bootstrap is the launch harness's
        if self.use_agent not in (True, "auto", "pool"):
            return False
        return not (task_metadata.get("pip_deps") or self.profile_dir)

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
        # Write-ahead intent: an electron in flight when the dispatcher dies
        # shows in the successor's recovery report; the terminal clears it.
        journal_mod.record("task", op=operation_id, dispatch_id=dispatch_id, node=node_id,
                           t_dispatch=time.time())
        self._active_ops.add(operation_id)
        _ACTIVE_ELECTRONS.inc()
        obs_events.emit("task.state", operation_id=operation_id, state="starting",
                        trace_id=root.trace_id)
        outcome = "failed"
        try:
            await self._validate_credentials()
            args, kwargs = tuple(args or ()), dict(kwargs or {})
            ran = None
            if self._rpc_preselect(task_metadata):
                self.last_dispatch_mode = self._op_modes[operation_id] = "rpc"
                journal_mod.record("task", op=operation_id, operation_id=operation_id,
                                   attempt=1, mode="rpc")
                try:
                    ran = await self._run_rpc(root, operation_id, function, args, kwargs)
                except _RpcUnavailable as unavailable:
                    obs_events.emit("task.rpc_fallback", operation_id=operation_id,
                                    reason=str(unavailable))
                    app_log.info("task %s: RPC dispatch unavailable (%s); using the "
                                 "launch road", operation_id, unavailable)
            if ran is None:
                self.last_dispatch_mode = self._op_modes[operation_id] = "launch"
                journal_mod.record("task", op=operation_id, operation_id=operation_id,
                                   attempt=1, mode="launch")
                with Span("executor.stage"):
                    staged = await asyncio.to_thread(
                        self._write_function_files, operation_id, function, args, kwargs,
                        workdir, task_metadata.get("pip_deps", ()),
                    )
                ran = await self._run_staged(root, staged)
            result, exception = ran
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
            journal_mod.record("task_terminal", op=operation_id, outcome=(
                "ok" if outcome == "completed" else
                "cancelled" if outcome == "cancelled" else "error"), sync=True)
            self._active_ops.discard(operation_id)
            self._cancelled_ops.discard(operation_id)
            self._op_modes.pop(operation_id, None)
            client = self._op_agents.pop(operation_id, None)
            if client is not None:
                # whatever the channel kept for this task, on every exit path
                client.forget(operation_id)
            self._epilogue(root, outcome, operation_id)

    @staticmethod
    def _record_execute(root: Span, times: dict | None) -> None:
        """The electron's own runtime, as the harness measured it, becomes
        the ``execute`` stage.  The poll span waited for it too: what the
        poll adds beyond it (a worker's start and imports, the result's
        write and the wait's wake-ups) stays the poll stage's."""
        if not times:
            return
        execute = max(0.0, times["end"] - times["start"])
        record_span("executor.execute", trace_id=root.trace_id, parent_id=root.span_id,
                    start_ts=times["start"], duration_s=execute)
        stages = root.stage_durations
        stages["execute"] = execute
        stages["poll"] = max(0.0, stages.get("poll", 0.0) - execute)

    async def _run_staged(self, root: Span, staged: StagedTask):
        """Upload, launch, wait for, fetch and clean up one staged task (every
        process of a gang): ``(result, exception)``."""
        operation_id = staged.operation_id
        conn = LocalTransport()
        client = None
        try:
            with Span("executor.upload"):
                await self._upload_task(conn, staged)
            client = await self._resident_client([]) if self.use_agent else None
            if operation_id in self._cancelled_ops:
                raise asyncio.CancelledError(f"task {operation_id} cancelled")
            with Span("executor.submit"):
                pids: list = []
                self._pids[operation_id] = pids
                for process in range(staged.processes):
                    pid = None
                    if client is not None:
                        try:
                            pid = await self._submit_via_agent(client, conn, staged, process)
                            self._op_agents[operation_id] = client
                        except AgentError as err:
                            if classify_error(err)[0] is FaultClass.PERMANENT:
                                raise
                            # rejected before it started: launch it detached instead
                            app_log.warning("task %s: pool run refused (%s); launching with "
                                            "nohup", operation_id, err)
                            obs_events.emit("task.agent_fallback", operation_id=operation_id,
                                            reason=str(err))
                            client = None
                    if pid is None:
                        pid = await self.submit_task(conn, staged, process)
                    pids.append(pid)
            try:
                with Span("executor.poll"):
                    if client is not None and staged.processes == 1:
                        status, blamed = await self._await_agent_exit(
                            client, conn, staged, pids[0]), 0
                    else:
                        status, blamed = await self._poll_task(conn, staged, pids)
            except asyncio.CancelledError:
                await self._kill(conn, staged)
                raise
            if status is not TaskStatus.READY:
                if operation_id in self._cancelled_ops:
                    raise asyncio.CancelledError(f"task {operation_id} cancelled")
                if status is TaskStatus.TIMEOUT or staged.processes > 1:
                    # a gang's other processes may wait in the rendezvous
                    await self._kill(conn, staged)
                log_tail = await self._remote_log_tail(conn, staged, blamed)
                who = (f" process {blamed} (worker {self.workers[blamed]!r})"
                       if staged.processes > 1 else "")
                raise RuntimeError(
                    f"remote task {operation_id} failed on {conn.address}{who} "
                    f"({status.value}); log tail:\n{log_tail}"
                )
            with Span("executor.fetch"):
                result, exception, times = await self.query_result(conn, staged)
            self._record_execute(root, times)
            if times and "rendezvous" in times:
                # the gang's process group opening: dispatch overhead the
                # poll span waited through, reported as its own stage
                stages = root.stage_durations
                stages["rendezvous"] = times["rendezvous"]
                stages["poll"] = max(0.0, stages.get("poll", 0.0) - times["rendezvous"])
            return result, exception
        finally:
            self._pids.pop(operation_id, None)
            if client is not None:
                for process in range(1, staged.processes):
                    client.forget(self._task_id(staged, process))
            if self.do_cleanup:
                with Span("executor.cleanup"):
                    await self.cleanup(conn, staged)
            await conn.close()

    # ------------------------------------------------------------------ #
    # RPC dispatch: execute by digest in the warm pool server             #
    # (reference: tpu.py _run_attempt_rpc, 4785-5290)                     #
    # ------------------------------------------------------------------ #

    @staticmethod
    def _write_payload_file(path: str, payload: bytes) -> None:
        """Atomic write of a digest-named payload (immutable: skipped when
        present; concurrent electrons share function payloads)."""
        if os.path.exists(path):
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{os.urandom(4).hex()}"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)

    @staticmethod
    def _decode_rpc_result(event: dict) -> tuple:
        """``(result, exception, times)`` from an inline ``result`` event (a
        frame body, or base64 in a JSON line): the layout launch mode
        fetches from the result file."""
        if event.get("torn"):
            # PERMANENT: the same torn bytes cannot decode on a retry
            raise FrameIntegrityError(f"RPC result frame arrived torn: {event['torn']}")
        data = event.get("data_bytes")
        if data is None:
            data = base64.b64decode(str(event.get("data") or ""))
        result, exception, *times = pickle.loads(data)
        return result, exception, (times[0] if times else None)

    async def _fetch_staged_rpc_result(self, conn: Transport, event: dict,
                                       operation_id: str) -> tuple:
        """Fetch a result the worker staged instead of inlining (over
        ``rpc_inline_args_max``), verify its digest, and remove both copies."""
        remote = str(event["data_path"])
        local = os.path.join(self.cache_dir, f"result_rpc_{os.urandom(8).hex()}.pkl")
        try:
            await conn.get(remote, local)
            data = await asyncio.to_thread(Path(local).read_bytes)
            expected = str(event.get("data_digest") or "")
            if expected and hashlib.sha256(data).hexdigest() != expected:
                raise RuntimeError(f"staged RPC result for {operation_id} does not match "
                                   "its announced digest (torn artifact)")
            obs_events.emit("task.rpc_result_staged", operation_id=operation_id,
                            bytes=len(data))
            result, exception, *times = await asyncio.to_thread(pickle.loads, data)
            return result, exception, (times[0] if times else None)
        finally:
            try:
                os.remove(local)
            except OSError:
                pass
            try:
                await conn.remove([remote])
            except (OSError, TransportError):
                pass

    async def _await_rpc_result(self, client: AgentClient, operation_id: str) -> tuple:
        """Wait for an invocation's pushed result: ``("result", event)``,
        ``("timeout", None)`` once ``task_timeout`` is spent, or
        ``("channel", AgentError)`` when the channel died (a dead resident
        worker looks the same).  Wakes every ``RPC_WAKE_S`` to notice a
        cancel."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.task_timeout if self.task_timeout else None
        waiter = asyncio.ensure_future(client.wait_result(operation_id))
        try:
            while True:
                wake = self.RPC_WAKE_S
                if deadline is not None:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        return "timeout", None
                    wake = min(wake, remaining)
                done, _ = await asyncio.wait({waiter}, timeout=wake)
                if done:
                    try:
                        return "result", waiter.result()
                    except AgentError as err:
                        return "channel", err
                if operation_id in self._cancelled_ops:
                    raise asyncio.CancelledError(f"task {operation_id} cancelled")
        finally:
            waiter.cancel()
            try:
                await waiter
            except (asyncio.CancelledError, AgentError):
                pass

    async def _run_rpc(self, root: Span, operation_id: str, function: Callable,
                       args: tuple, kwargs: dict):
        """One electron by digest in the warm pool server: ``(result,
        exception)``, under the launch road's stage spans.

        Per electron (warm): one ``invoke`` line with the args inline and
        one pushed ``result``.  Per connection: the function's CAS ship and
        its ``register_fn``.  A dead resident worker or dropped channel
        fails the electron as transient (``rpc_channel``); a digest
        mismatch is permanent.  A timeout or cancel tears the resident
        runtime down: an invocation inside a shared process cannot be
        killed any other way.  No live runtime raises
        :class:`_RpcUnavailable`.
        """
        conns: list[Transport] = []
        local_args = None
        try:
            with Span("executor.stage"):
                # The function and the args pickle apart: the function's
                # digest is the registry key electrons share; args vary.
                fn_payload, args_payload = await asyncio.to_thread(
                    lambda: (cloudpickle.dumps(function), cloudpickle.dumps((args, kwargs))))
                fn_digest, args_digest = bytes_digest(fn_payload), bytes_digest(args_payload)
                inline = len(args_payload) <= self.rpc_inline_args_max
                local_fn = os.path.join(self.cache_dir, f"fn_rpc_{fn_digest}.pkl")
                await asyncio.to_thread(self._write_payload_file, local_fn, fn_payload)
                if not inline:
                    # private to this electron: its cleanup must not race
                    # another's upload of the same args
                    local_args = os.path.join(
                        self.cache_dir, f"args_rpc_{args_digest}.{os.urandom(6).hex()}.pkl")
                    await asyncio.to_thread(self._write_payload_file, local_args, args_payload)
            client = await self._resident_client(conns)
            if client is None:
                raise _RpcUnavailable("no live pool runtime on "
                                      f"{self._worker_addresses()[0]}")
            conn, address = conns[0], self._worker_addresses()[0]
            key = self._pool_key(address)
            remote_fn = cas_path(self.remote_cache, fn_digest, ".pkl")
            spec: dict[str, Any] = {"operation_id": operation_id}
            if self.task_env:
                spec["env"] = dict(self.task_env)
            self._op_agents[operation_id] = client
            invoke_kwargs: dict[str, Any] = {}
            try:
                with Span("executor.upload"):
                    await self._cas.ensure_probed(key, conn, [(fn_digest, remote_fn)])
                    await self._cas.ensure(key, conn, fn_digest, local_fn, remote_fn)
                    await self._fn_registry.ensure(key, client, fn_digest, remote_fn)
                    if inline:
                        invoke_kwargs["args_bytes"] = args_payload
                    else:
                        remote_args = cas_path(self.remote_cache, args_digest, ".pkl")
                        await self._cas.ensure(key, conn, args_digest, local_args, remote_args)
                        invoke_kwargs.update(args_path=remote_args, args_digest=args_digest)
                        obs_events.emit("task.rpc_args_staged", operation_id=operation_id,
                                        bytes=len(args_payload))
                if operation_id in self._cancelled_ops:
                    raise asyncio.CancelledError(f"task {operation_id} cancelled")
                with Span("executor.submit"):
                    await client.invoke(
                        operation_id, fn_digest, spec=spec, path=remote_fn,
                        result_path=f"{self.remote_cache}/result_rpc_{os.urandom(8).hex()}.pkl",
                        result_max_inline=self.rpc_inline_args_max, **invoke_kwargs,
                    )
            except AgentError as err:
                if classify_error(err)[0] is FaultClass.PERMANENT:
                    raise  # a torn payload: no road can make its bytes match
                await self._discard_workers(conns)
                raise tag_fault(err, "rpc_channel", transient=True)
            with Span("executor.poll"):
                verdict, payload = await self._await_rpc_result(client, operation_id)
            if verdict != "result":
                await self._discard_workers(conns)
                if verdict == "timeout":
                    raise RuntimeError(f"RPC task {operation_id} timed out after "
                                       f"{self.task_timeout:.1f}s on {address}; resident "
                                       "runtime torn down")
                raise tag_fault(AgentError(f"resident worker died mid-invoke on {address}: "
                                           f"{payload}"), "rpc_channel", transient=True)
            with Span("executor.fetch"):
                if payload.get("data_path"):
                    result, exception, times = await self._fetch_staged_rpc_result(
                        conn, payload, operation_id)
                else:
                    result, exception, times = await asyncio.to_thread(
                        self._decode_rpc_result, payload)
            self._record_execute(root, times)
            return result, exception
        except asyncio.CancelledError:
            if conns:
                # shielded: a second cancel must not leave the teardown half done
                try:
                    await asyncio.shield(self._discard_workers(conns))
                except (Exception, asyncio.CancelledError):  # noqa: BLE001
                    pass
            raise
        finally:
            if local_args is not None:
                try:
                    os.remove(local_args)
                except OSError:
                    pass

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
