"""``GPUExecutor``: dispatch an electron to a GPU worker and bring back its result.

Counterpart of ``covalent_tpu_plugin/tpu.py``'s ``TPUExecutor``.  The
control plane (``transport``) is ``"local"`` (subprocesses on this
machine, the default), ``"ssh"`` (the ``auto`` backend ladder: asyncssh,
then the OpenSSH binaries, then the pure-Python minissh stack) or
``"minissh"`` (that stack pinned).  An SSH worker is ``hostname``
(``user@host:port``) or each entry of ``workers``; channels are pooled per
``{transport}:{address}`` behind a circuit breaker per address, and each
pooled channel runs one batched pre-flight (cache and CAS ``mkdir``, the
conda check, the codec probe, the ``python3`` check) before its first
electron.  Staged files travel through the worker's content-addressed
store (:mod:`.cache`): the harness ships once per connection under its
digest, and what an electron stages (its function pickle and task specs)
travels as one bundle, compressed with the negotiated codec when that pays
(``compress``, ``bundle``).  A worker that cannot be reached, a launch that
fails or a harness that dies emits ``task.dispatch_failed`` and raises,
unless ``run_local_on_dispatch_fail`` runs the electron on the dispatcher
instead (off by default) or a retry budget allows another attempt (below).

Each electron takes one of two roads (``dispatch_mode``):

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
  larger than ``rpc_inline_args_max``) and one pushed ``result``.  On the
  native agent each invoke forks a fresh ``harness.py --rpc-child``.
  With ``profile_dir`` set, the electron is traced inside the runtime
  (``profile_start`` after the invoke's ack, ``profile_stop`` after its
  result); the digest-checked ``.profile.tgz`` lands under
  ``{cache_dir}/profiles/`` and in ``last_timings["profile_trace"]``.

The resident runtime (``use_agent``): ``True`` or ``"auto"`` try the pool
server, then the native C++ agent (``native/agent.cc``, compiled on the
worker once per content hash); ``"pool"`` and ``"native"`` pin one;
``False`` neither.  A worker on which no runtime starts is remembered as
having none (its electrons launch with nohup, its sessions are refused),
except under ``"native"``, where an agent that does not build or start is
an error.  :meth:`GPUExecutor.capture_profile` traces a live resident runtime
on demand: pool servers first, then native agents with a session.

Each ``run`` is one root span (``executor.task``) with a child per stage:
``stage``, ``connect`` (the dial, then the pool server's start or its
ping), ``preflight``, ``upload``, ``submit``, ``poll``, ``fetch`` and
``cleanup``, plus ``execute``, the
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
picks a free port per electron).  Under SSH each worker is an address, one
process each, and the rendezvous goes to worker 0's host (``user@`` and
``:port`` stripped; ``coordinator_port=0`` picks a free port here, so only
when worker 0 is this machine).  One spec is staged per process, each
with its ``distributed`` block; all of them start (pool forks or nohup
launches), and the watcher waits on process 0's result while it watches
every process: one that dies first (a failed pip install, a torn file, a
crash before the rendezvous) fails the task at once with its index and
worker blamed, and the others are killed.  A gang always takes the launch
road.

Fault tolerance (the reference's ``tpu.py:3446-4160``):

* **Retries.** ``run`` is a retry driver.  An attempt that fails
  transiently (a refused dial, a channel that dies, a launch refused, a
  worker that dies without a result, a timeout, a stall, a preemption, an
  RPC electron whose resident worker dies) is run again as ``{base}.r{n}``
  after a jittered backoff, within ``max_task_retries`` and
  ``retry_wall_budget`` (:class:`~.resilience.RetryPolicy`); the channels
  are redialed after the first retry and after a channel death or a
  preemption.  A permanent fault (the electron's own exception, a torn
  artifact, a cancel) is never retried, and ``run_local_on_dispatch_fail``
  applies only once the budget is spent.  One ``executor.task`` span
  covers every attempt; ``covalent_tpu_task_retries_total{reason}``,
  ``task.retry`` and :meth:`GPUExecutor.attempts_of` count them.
* **Liveness.** With ``heartbeat_interval`` the harness beats into the
  task's telemetry file; the poll reads its new lines on every status
  probe, a pool-launched task's file is tailed over the pool channel, and
  a worker silent past ``stall_threshold`` (default three intervals) ends
  its attempt with :class:`~.resilience.WorkerStalledError`.  A checkpoint
  save or restore the worker announced holds its stall clock (at most
  :attr:`GPUExecutor.SAVE_HOLD_S`).
* **Timeouts.** A timed-out or stalled gang is escalated: TERM to every
  process group, a grace (none for a stopped process, which cannot act on
  TERM), KILL, and the survivors counted.
* **Checkpoints.** With ``checkpoint_interval_s`` the harness snapshots
  the electron's registered train state (``utils.checkpoint``) on the
  interval and on SIGTERM.  The executor records each
  ``worker.checkpoint_saved``, mirrors the bundle into
  ``{cache_dir}/cas/``, and before a retry finds the lineage's newest
  bundle whose digest checks (a torn one is skipped with
  ``task.resume_skipped_torn``), which the next attempt ships and the
  electron restores with ``utils.checkpoint.resume_state``.  A worker
  that announced ``worker.preempt_notice`` and then died is retried as
  ``worker_preempted``.  The lineage is ``{dispatch_id}_{node_id}``; the
  worker's manifest holds one run's saves (a node dispatched again never
  resumes from an earlier run).
* **Chaos.** ``chaos`` (a :class:`~.transport.chaos.ChaosPlan`, a spec
  string, or ``COVALENT_TPU_CHAOS``) wraps every channel in a
  :class:`~.transport.chaos.ChaosTransport`.

Crash recovery: with ``COVALENT_TPU_JOURNAL_DIR`` set, each electron's
intent, placement and outcome go to the control-plane journal
(``fleet/journal.py``), every pool channel is fenced with the journal's
epoch, and a pool server that a dead dispatcher orphaned is adopted
(``pool_orphan.json`` and the ``--attach`` relay) before a fresh one is
started; :meth:`GPUExecutor.recover` then re-adopts its sessions and
streams (``fleet/recovery.py``).  A journaled electron that was in flight
is reported, not run again.

The gang's lifecycle (``tpu.py:1289-1407, 2604-2690``): ``prewarm`` (on by
default) lets the workflow runner dial a node's workers while the node
waits on its upstream nodes (:meth:`GPUExecutor.prewarm`);
:meth:`GPUExecutor.teardown_gang` releases a warm gang;
:meth:`GPUExecutor.health_canary` pings a worker's resident runtime.  A
gang process that finishes more than ``COVALENT_TPU_STRAGGLER_BUDGET_S``
(default 5 s) after the gang's median is flagged to the health monitor
(``fleet/health.py``) and, with ``COVALENT_TPU_STRAGGLER_REDIAL``, its
channel is dialed afresh for the next electron.

Caches (``covalent_tpu_plugin_torch/cache.py``): with ``cache_results`` (or
``COVALENT_TPU_RESULT_CACHE=1``) a repeat of an identical electron returns
the stored result from ``{cache_dir}/results`` ahead of the connect, on
either road (each its own key); the worker's CAS is pruned by age
(``cas_ttl_hours``, at pre-flight and after each launched electron) and
by bytes (``cas_max_bytes``, after each launched electron).

Not ported: the fleet scheduler and the ops endpoint (ROADMAP Queue 1).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import os
import pickle
import re
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
    AgentTimeoutError,
    _in_conda,
    attach_pool_server,
    ensure_agent_binary,
    read_orphan_rendezvous,
    start_pool_server,
)
from .cache import (
    CAS_EVICTIONS_TOTAL,
    RESULT_CACHE_TOTAL,
    CASIndex,
    FnRegistry,
    ResultCache,
    bytes_digest,
    cas_bytes_prune_command,
    cas_path,
    file_digest,
    harness_digest,
)
from .executor_base import RemoteExecutor
from .fleet import journal as journal_mod
from .fleet.health import HEALTH
from .obs import events as obs_events
from .obs.heartbeat import MONITOR, STALLS_TOTAL
from .obs.metrics import REGISTRY
from .obs.trace import Span, context_of, record_span
from .resilience import (
    TASK_RETRIES_TOTAL,
    CircuitBreakerRegistry,
    Deadline,
    FaultClass,
    RetryPolicy,
    WorkerPreemptedError,
    WorkerStalledError,
    classify_error,
    tag_fault,
)
from .transport import (
    LocalTransport,
    SSHTransport,
    Transport,
    TransportError,
    TransportPool,
    connect_with_retries,
)
from .transport import codec as codec_mod
from .transport.chaos import ChaosPlan, ChaosTransport, plan_from_spec
from .transport.frames import FrameIntegrityError
from .utils.checkpoint import verify_bundle_file
from .utils.config import get_config, update_config
from .utils.log import app_log
from .utils.serialize import dump_task, load_result

# Plugin identity: the hook Covalent's loader keys on (pattern: ssh.py:34).
EXECUTOR_PLUGIN_NAME = "GPUExecutor"

# Defaults merged into the config under [executors.gpu]
# (pattern: _EXECUTOR_PLUGIN_DEFAULTS, ssh.py:39-50).
_EXECUTOR_PLUGIN_DEFAULTS = {
    # "local" runs workers on this machine; "ssh" picks an SSH backend
    # (asyncssh > OpenSSH binaries > minissh); "minissh" pins the
    # pure-Python stack.  The reference defaults to "ssh"; the port keeps
    # "local", since its callers and the "gpu" alias build executors with
    # no host.
    "transport": "local",
    # The SSH worker: "host", "user@host" or "user@host:port" (ssh.py:77);
    # `workers` overrides it with one address per process.
    "hostname": "",
    "username": "",
    "ssh_key_file": os.path.join("~", ".ssh", "id_rsa"),
    # minissh's host-key pin: the server's public key file (asyncssh and
    # OpenSSH pin through ~/.ssh/known_hosts).
    "known_host_key_file": "",
    "strict_host_keys": True,
    "conda_env": "",
    "max_connection_attempts": 5,
    "retry_wait_time": 5.0,
    # Run an electron on the dispatcher when its dispatch fails
    # (ssh.py:181-208); off, so a failure is never hidden.
    "run_local_on_dispatch_fail": False,
    # Wire codec for staged files: "auto" negotiates zstd > zlib > raw at
    # pre-flight, "off" ships raw, "zlib"/"zstd" pin one (and compress
    # fetched results too).
    "compress": "auto",
    # Missing staged artifacts of one electron travel as one tar: one put
    # and one unpack exec instead of a pair each.
    "bundle": True,
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
    # this machine named by these labels; SSH workers are addresses.
    "workers": [],
    # The gang's rendezvous port on the coordinator (tpu.py:155); 0 picks
    # a free one on this machine per electron.
    "coordinator_port": 8476,
    # Retries (tpu.py:223-237): max_task_retries counts re-submissions of
    # the whole electron (0: one attempt, the default, as in the
    # reference); the wall budget bounds when a new attempt may start
    # (0: none).  COVALENT_TPU_TASK_RETRIES overrides the count.
    "max_task_retries": 0,
    "retry_base_delay": 0.25,
    "retry_max_delay": 10.0,
    "retry_wall_budget": 0.0,
    # The per-address breaker: open after this many consecutive dial or
    # pre-flight failures, half-open after the cooldown.
    "circuit_threshold": 3,
    "circuit_cooldown": 30.0,
    # A chaos spec ("key=value,..."; COVALENT_TPU_CHAOS overrides): every
    # channel is wrapped in a ChaosTransport.  "" injects nothing.
    "chaos": "",
    # Seconds between a launch-mode worker's heartbeats (0: none).  The
    # reference beats every 5 s by default; the port leaves liveness off
    # until a caller asks for it.  COVALENT_TPU_HEARTBEAT_S overrides.
    "heartbeat_interval": 0.0,
    # Seconds of heartbeat silence that end an attempt as worker_stalled
    # (0: three intervals).  COVALENT_TPU_STALL_S overrides.
    "stall_threshold": 0.0,
    # Cooperative checkpoints (0: off): the harness snapshots the
    # electron's registered train state this often and on SIGTERM, and
    # keeps the newest checkpoint_keep_n bundles a lineage.
    # COVALENT_TPU_CHECKPOINT_INTERVAL_S / _KEEP override.
    "checkpoint_interval_s": 0.0,
    "checkpoint_keep_n": 3,
    # Result memoization (tpu.py:174-180, cache.ResultCache): a repeat of an
    # identical electron returns the stored result without touching the
    # transport.  Sound only for side-effect-free electrons, hence off;
    # COVALENT_TPU_RESULT_CACHE=1 turns it on for the process.
    "cache_results": False,
    "result_cache_max_entries": 512,
    "result_cache_max_bytes": 256 * 1024 * 1024,
    # Age bound on {remote_cache}/cas/ (tpu.py:185): pruned at each
    # channel's pre-flight and after each launched electron; 0 disables.
    "cas_ttl_hours": 168.0,
    # Byte budget on the same directory, oldest first, after each launched
    # electron (its own artifacts touched first, so they go last); 0
    # disables.  COVALENT_TPU_CAS_MAX_BYTES overrides.
    "cas_max_bytes": 0,
    # The workflow runner pre-dials this executor (lease_gang) while a node
    # waits on its upstream nodes (tpu.py:221); never under a chaos plan.
    "prewarm": True,
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
_PREWARM_TOTAL = REGISTRY.counter(
    "covalent_tpu_prewarm_total",
    "DAG-driven connection prewarm attempts by result",
    ("result",),
)
#: How long a whole gang's prewarm (dial, pre-flight, pool server) takes,
#: by fleet pool ("" for an executor outside one).
_PREWARM_SECONDS = REGISTRY.histogram(
    "covalent_tpu_prewarm_seconds",
    "Gang prewarm (cold-start) duration per fleet pool",
    ("pool",),
)

CHECKPOINT_SAVES_TOTAL = REGISTRY.counter(
    "covalent_tpu_checkpoint_saves_total",
    "Cooperative train-state checkpoint bundles published by workers",
    ("trigger",),
)
CHECKPOINT_RESTORES_TOTAL = REGISTRY.counter(
    "covalent_tpu_checkpoint_restores_total",
    "Retry attempts dispatched with a verified resume checkpoint",
)
_CHECKPOINT_RESUMED_STEP = REGISTRY.gauge(
    "covalent_tpu_checkpoint_resumed_step",
    "Step of the most recent checkpoint shipped as a resume reference",
)

#: Stages that are the electron's own work, not dispatch overhead.
_NOT_OVERHEAD = ("execute", "profile")

_DISPATCH_MODES = ("launch", "auto", "rpc")


class _DispatchFailed(Exception):
    """Internal control flow: the electron could not be dispatched (no
    worker reached, a launch refused, a harness that died, a timeout or a
    stall).  ``reason`` is the retry label of where it failed, ``error``
    the fault to classify (None: transient) and ``conns`` the attempt's
    channels.  The retry driver plans another attempt when the budget
    allows; otherwise ``run`` hands it to
    :meth:`GPUExecutor._on_dispatch_fail`."""

    def __init__(self, message: str, log_tail: str = "", reason: str = "",
                 error: BaseException | None = None, conns=None) -> None:
        super().__init__(message)
        self.log_tail = log_tail
        self.reason = reason
        self.error = error
        self.conns = list(conns or ())


class _RetryDispatch(Exception):
    """Internal control flow: an attempt failed transiently and the budget
    allows another.  Raised inside an attempt, caught only by ``run``."""

    def __init__(self, reason: str, message: str, redial: bool, conns=None) -> None:
        super().__init__(message)
        self.reason = reason
        self.message = message
        #: drop the pooled channels before the next attempt
        self.redial = redial
        #: the failed attempt's channels: the only ones a redial may drop
        self.conns = list(conns or ())


def _sanitize_lineage(lineage: str) -> str:
    """A lineage as a file name (the harness's ``_sanitize_lineage``: the
    worker writes the manifest this resolves)."""
    return re.sub(r"[^A-Za-z0-9._-]", "_", str(lineage))


def _ckpt_manifest_remote(remote_cache: str, lineage: str) -> str:
    """The remote path of a lineage's checkpoint manifest."""
    return cas_path(remote_cache, f"ckpt_{_sanitize_lineage(lineage)}", ".json")


#: Separates a status probe's telemetry bytes from its status token.
_FEED_MARK = "--covalent-gpu-status--"


class _TelemetryFeed:
    """The poll road's side-band: each status probe also reads the new
    bytes of the process's telemetry file (heartbeats and worker events),
    and hands every whole line to ``handler(worker, record)``; a partial
    last line is read again on the next probe."""

    def __init__(self, handler: Callable[[str, dict], None], workers: list[str]) -> None:
        self.handler = handler
        self.workers = workers
        self.offsets = [0] * len(workers)

    def clause(self, path: str, process: int) -> str:
        return (f"tail -c +{self.offsets[process] + 1} {shlex.quote(path)} 2>/dev/null; "
                f"printf '\\n%s\\n' {_FEED_MARK}; ")

    def consume(self, process: int, stdout: str) -> str:
        """Feed the telemetry part of a probe's output; returns the rest."""
        head, sep, rest = stdout.partition(f"\n{_FEED_MARK}\n")
        if not sep:
            return stdout
        whole = head[: head.rfind("\n") + 1]
        self.offsets[process] += len(whole.encode())
        for line in whole.splitlines():
            if not line.startswith("{"):
                continue
            try:
                record = json.loads(line)
            except ValueError:
                continue
            if isinstance(record, dict):
                self.handler(self.workers[process], record)
        return rest


_TRANSPORTS = ("local", "ssh", "minissh")
_COMPRESS = ("auto", "off", "zlib", "zstd")
_LOOPBACK = ("127.0.0.1", "localhost", "::1")


def _split_host_port(hostport: str) -> tuple[str, int | None]:
    """Split a ``host[:port]`` worker address (tpu.py:330).  Only a single
    all-digit suffix counts as a port: IPv6 literals pass through whole."""
    host, sep, port = hostport.rpartition(":")
    if sep and port.isdigit() and ":" not in host:
        return host, int(port)
    return hostport, None


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
    STALLED = "STALLED"      # a heartbeating worker fell silent past its
    #                          stall threshold while its process looks alive


class StagedTask:
    """Paths produced by staging one task (reference: ``ssh.py:173-179``,
    ``tpu.py:354-425``).

    The harness and the function pickle are content-addressed
    (``{remote_cache}/cas/{digest}.py`` and ``.pkl``): each ships once per
    connection and stays, aged out by the CAS's prunes.  Everything else is
    the operation's own and is cleaned up after it: the specs (they name the
    operation, so they never dedupe), the result, the logs, the pid files,
    the telemetry files and heartbeat snapshots, and a resume bundle
    shipped to a retry attempt.
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
        self.harness_digest = harness_digest()
        self.remote_harness_file = cas_path(remote_cache, self.harness_digest, ".py")
        self.remote_spec_file = f"{remote_cache}/spec_{operation_id}.json"
        self.remote_result_file = f"{remote_cache}/result_{operation_id}.pkl"
        self.remote_log_file = f"{remote_cache}/log_{operation_id}.txt"
        self.remote_pid_file = f"{remote_cache}/pid_{operation_id}"
        #: sha256 of the function pickle and of each process's spec, set by
        #: staging: the bundle's unpack checks each member against its own
        self.function_digest = ""
        self.spec_digests: list[str] = [""] * processes
        #: ``(local, remote, digest)`` of the resume bundle a retry attempt
        #: ships, under a name of this operation's own (not the CAS: a
        #: preempted attempt's checkpointer prunes digest-named bundles
        #: there, and must not unlink the one this attempt restores from)
        self.resume_artifact: tuple[str, str, str] | None = None
        self._remote_cache = remote_cache

    @property
    def remote_function_file(self) -> str:
        return cas_path(self._remote_cache, self.function_digest, ".pkl")

    def rank(self, i: int) -> dict[str, str]:
        """Process ``i``'s files: ``spec`` (local), ``remote_spec``, ``log``,
        ``pid``, ``done`` (what the watcher waits on: the result file for
        process 0, ``{result}.done.{i}`` for the others), ``telemetry``
        (its worker events and heartbeats) and ``hb`` (its latest
        heartbeat)."""
        telemetry = f"{self._remote_cache}/telemetry_{self.operation_id}.{i}.jsonl"
        if self.processes == 1:
            return {"spec": self.spec_file, "remote_spec": self.remote_spec_file,
                    "log": self.remote_log_file, "pid": self.remote_pid_file,
                    "done": self.remote_result_file, "telemetry": telemetry,
                    "hb": f"{self.remote_pid_file}.hb"}
        return {
            "spec": self.spec_file.replace(".json", f"_{i}.json"),
            "remote_spec": self.remote_spec_file.replace(".json", f"_{i}.json"),
            "log": self.remote_log_file.replace(".txt", f"_{i}.txt"),
            "pid": f"{self.remote_pid_file}.{i}",
            "done": self.remote_result_file if i == 0 else f"{self.remote_result_file}.done.{i}",
            "telemetry": telemetry, "hb": f"{self.remote_pid_file}.{i}.hb",
        }

    def harness_artifact(self) -> tuple[str, str, str]:
        """``(local, remote, digest)`` of the harness, a CAS artifact."""
        return _harness_module.__file__, self.remote_harness_file, self.harness_digest

    def function_artifact(self) -> tuple[str, str, str]:
        """``(local, remote, digest)`` of the function pickle, a CAS artifact."""
        return self.function_file, self.remote_function_file, self.function_digest

    def artifacts(self, i: int) -> list[tuple[str, str, str]]:
        """``(local, remote, digest)`` of the files process ``i``'s worker
        gets that are the operation's own: its spec."""
        files = self.rank(i)
        return [(files["spec"], files["remote_spec"], self.spec_digests[i])]

    def local_files(self) -> list[str]:
        return [self.function_file, self.local_result_file] + [
            self.rank(i)["spec"] for i in range(self.processes)]

    def remote_files(self, i: int | None = None) -> list[str]:
        """The operation's files on process ``i``'s worker (on every
        process's when None); the CAS artifacts are not among them."""
        files = [self.remote_result_file]
        if self.resume_artifact is not None:
            files.append(self.resume_artifact[1])
        for r in (self.rank(p) for p in (range(self.processes) if i is None else (i,))):
            files += [r["remote_spec"], r["log"], r["pid"], r["done"], r["telemetry"],
                      r["hb"], f"{r['pid']}.metrics"]
        return list(dict.fromkeys(files))


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

    ``use_agent`` (True, "auto", "pool", "native", False or "off") and
    ``dispatch_mode`` ("launch", "auto" or "rpc") choose the road (module
    docstring); ``rpc_inline_args_max`` is the inline size limit of RPC args
    and results, ``pool_preload`` the pool server's and zygote's preloads,
    ``agent_frames`` whether its channel negotiates binary frames.

    ``transport`` ("local", "ssh" or "minissh") with ``hostname`` or
    ``workers``, ``username``, ``ssh_key_file``, ``known_host_key_file``
    (minissh's host-key pin), ``strict_host_keys``, ``conda_env``,
    ``max_connection_attempts`` and ``retry_wait_time`` (the dial's retry
    envelope), ``compress`` and ``bundle`` (the staging wire) and
    ``run_local_on_dispatch_fail`` are the SSH settings of the reference
    (``tpu.py:119-150``).

    Fault tolerance (module docstring): ``max_task_retries``,
    ``retry_base_delay``, ``retry_max_delay`` and ``retry_wall_budget``
    (the retry policy), ``circuit_threshold`` and ``circuit_cooldown``
    (the per-address breaker), ``chaos`` (a ``ChaosPlan`` or its spec),
    ``heartbeat_interval`` and ``stall_threshold`` (liveness),
    ``checkpoint_interval_s`` and ``checkpoint_keep_n`` (cooperative
    checkpoints).  The environment variables ``COVALENT_TPU_TASK_RETRIES``,
    ``COVALENT_TPU_CHAOS``, ``COVALENT_TPU_HEARTBEAT_S``,
    ``COVALENT_TPU_STALL_S``, ``COVALENT_TPU_CHECKPOINT_INTERVAL_S`` and
    ``COVALENT_TPU_CHECKPOINT_KEEP`` stand in for an argument left at None.

    The lifecycle and caches (module docstring): ``prewarm``,
    ``cache_results`` with ``result_cache_max_entries`` and
    ``result_cache_max_bytes``, ``cas_ttl_hours`` and ``cas_max_bytes``;
    ``COVALENT_TPU_RESULT_CACHE`` and ``COVALENT_TPU_CAS_MAX_BYTES`` stand in
    for an argument left at None.

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

    #: Seconds an escalation waits between TERM and KILL for the gang's
    #: cleanup handlers (not for a stopped process, which cannot act on TERM).
    TIMEOUT_KILL_GRACE_S = 1.0

    #: The longest a worker's stall clock stays held for a checkpoint save
    #: or restore it announced (``worker.checkpoint_started``,
    #: ``worker.restore_started``): the save pickles the train state and
    #: the restore unpickles it with the GIL held (seconds for the 125M
    #: LM's 1.6 GB), which can silence the beat thread.  One that runs
    #: longer counts as a stall.
    SAVE_HOLD_S = 120.0

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
        hostname: str | None = None,
        username: str | None = None,
        ssh_key_file: str | None = None,
        known_host_key_file: str | None = None,
        strict_host_keys: bool | None = None,
        conda_env: str | None = None,
        max_connection_attempts: int | None = None,
        retry_wait_time: float | None = None,
        run_local_on_dispatch_fail: bool | None = None,
        compress: str | None = None,
        bundle: bool | None = None,
        chaos: "str | ChaosPlan | None" = None,
        max_task_retries: int | None = None,
        retry_base_delay: float | None = None,
        retry_max_delay: float | None = None,
        retry_wall_budget: float | None = None,
        circuit_threshold: int | None = None,
        circuit_cooldown: float | None = None,
        heartbeat_interval: float | None = None,
        stall_threshold: float | None = None,
        checkpoint_interval_s: float | None = None,
        checkpoint_keep_n: int | None = None,
        prewarm: bool | None = None,
        cache_results: bool | None = None,
        result_cache_max_entries: int | None = None,
        result_cache_max_bytes: int | None = None,
        cas_ttl_hours: float | None = None,
        cas_max_bytes: int | None = None,
    ) -> None:
        def resolve(value, key):
            if value is not None:
                return value
            return get_config(f"executors.gpu.{key}", _EXECUTOR_PLUGIN_DEFAULTS[key])

        transport = resolve(transport, "transport")
        use_agent = resolve(use_agent, "use_agent")
        if transport not in _TRANSPORTS:
            raise ValueError(f'transport must be "local", "ssh" or "minissh", got {transport!r}')
        compress = str(resolve(compress, "compress")).lower()
        if compress in ("0", "false", "no", "none", "raw"):
            compress = "off"
        elif compress in ("1", "true", "yes", "on"):
            compress = "auto"
        if compress not in _COMPRESS:
            raise ValueError(f'compress must be "auto"/"off"/"zlib"/"zstd", got {compress!r}')
        if use_agent not in (True, False, "auto", "pool", "native", "off"):
            raise ValueError(
                f"use_agent must be True/False/'auto'/'pool'/'native'/'off', got {use_agent!r}"
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
        #: the control plane (module docstring) and its SSH settings
        self.transport_kind = transport
        self.hostname = str(resolve(hostname, "hostname") or "")
        self.username = str(resolve(username, "username") or "")
        self.ssh_key_file = str(Path(resolve(ssh_key_file, "ssh_key_file")).expanduser().resolve())
        self.known_host_key_file = str(resolve(known_host_key_file, "known_host_key_file") or "")
        self.strict_host_keys = bool(resolve(strict_host_keys, "strict_host_keys"))
        self.conda_env = str(resolve(conda_env, "conda_env") or "")
        self.max_connection_attempts = int(resolve(max_connection_attempts,
                                                   "max_connection_attempts"))
        self.retry_wait_time = float(resolve(retry_wait_time, "retry_wait_time"))
        self.run_local_on_dispatch_fail = bool(
            resolve(run_local_on_dispatch_fail, "run_local_on_dispatch_fail"))
        self.compress = compress
        self.bundle = bool(resolve(bundle, "bundle"))

        def from_env(value, env_name: str, cast):
            """``value``, else the environment variable's (cast), else None."""
            raw = os.environ.get(env_name)
            if value is None and raw is not None:
                try:
                    return cast(raw)
                except ValueError:
                    app_log.warning("ignoring %s=%r (not a number)", env_name, raw)
            return value

        #: the retry policy (tpu.py:690-716): argument > environment > config
        self.max_task_retries = max(0, int(resolve(
            from_env(max_task_retries, "COVALENT_TPU_TASK_RETRIES", int), "max_task_retries")))
        self._retry_policy = RetryPolicy(
            max_retries=self.max_task_retries,
            base_delay=float(resolve(retry_base_delay, "retry_base_delay")),
            max_delay=float(resolve(retry_max_delay, "retry_max_delay")),
            wall_budget=float(resolve(retry_wall_budget, "retry_wall_budget")),
        )
        #: the fault plan every channel this executor dials is wrapped in
        if isinstance(chaos, ChaosPlan):
            self._chaos: ChaosPlan | None = chaos
        else:
            if chaos is None:
                chaos = os.environ.get("COVALENT_TPU_CHAOS")
            self._chaos = plan_from_spec(str(resolve(chaos, "chaos") or ""))
        #: liveness: the beat's cadence and the silence that is a stall
        self.heartbeat_interval = max(0.0, float(resolve(
            from_env(heartbeat_interval, "COVALENT_TPU_HEARTBEAT_S", float),
            "heartbeat_interval")))
        self.stall_threshold = max(0.0, float(resolve(
            from_env(stall_threshold, "COVALENT_TPU_STALL_S", float), "stall_threshold")))
        #: cooperative checkpoints: the harness's interval and how many a
        #: lineage keeps
        self.checkpoint_interval_s = max(0.0, float(resolve(
            from_env(checkpoint_interval_s, "COVALENT_TPU_CHECKPOINT_INTERVAL_S", float),
            "checkpoint_interval_s")))
        self.checkpoint_keep_n = max(1, int(resolve(
            from_env(checkpoint_keep_n, "COVALENT_TPU_CHECKPOINT_KEEP", int),
            "checkpoint_keep_n")))
        #: whether the workflow runner may pre-dial this executor, and
        #: whether a prewarm already warmed it (reset when workers are
        #: discarded); the fleet pool it serves, for the prewarm histogram
        self.prewarm_enabled = bool(resolve(prewarm, "prewarm"))
        self._prewarmed = False
        self.pool_label = ""
        #: result memoization (tpu.py:666-671, 817): argument >
        #: COVALENT_TPU_RESULT_CACHE > config; the store lives under
        #: ``{cache_dir}/results`` and is shared by executors on that dir
        env_cache = os.environ.get("COVALENT_TPU_RESULT_CACHE")
        if cache_results is None and env_cache is not None:
            cache_results = env_cache.strip().lower() not in ("", "0", "false", "no", "off")
        self.cache_results = bool(resolve(cache_results, "cache_results"))
        self._result_cache: ResultCache | None = ResultCache(
            os.path.join(self.cache_dir, "results"),
            max_entries=int(resolve(result_cache_max_entries, "result_cache_max_entries")),
            max_bytes=int(resolve(result_cache_max_bytes, "result_cache_max_bytes")),
        ) if self.cache_results else None
        #: attempt ids served from the result cache (their run's outcome is
        #: "cached")
        self._cache_hits: set[str] = set()
        #: the worker CAS's prunes (tpu.py:672-687): the TTL at pre-flight and
        #: after each launched electron, the byte budget after each
        self.cas_ttl_hours = float(resolve(cas_ttl_hours, "cas_ttl_hours"))
        self.cas_max_bytes = max(0, int(resolve(
            from_env(cas_max_bytes, "COVALENT_TPU_CAS_MAX_BYTES", int), "cas_max_bytes")))
        #: attempts of the latest ``run``, and per lineage (``attempts_of``)
        self.last_attempts = 0
        self._op_attempts: dict[str, int] = {}
        #: attempt operation id -> its run's base operation id (a cancel of
        #: the base reaches whichever attempt is in flight)
        self._attempt_base: dict[str, str] = {}
        #: lineage -> newest-first checkpoint records {"step", "digest",
        #: "file", "worker", "local"?} learned from worker.checkpoint_saved
        self._ckpt_records: dict[str, list[dict[str, Any]]] = {}
        #: (lineage, step, digest) already counted and mirrored
        self._ckpt_seen: set[tuple[str, int, str]] = set()
        #: lineage -> the resume plan the next attempt ships
        #: ({"step", "digest", "local"}), from _discover_resume
        self._resume_plans: dict[str, dict[str, Any]] = {}
        #: attempt ids whose worker announced worker.preempt_notice
        self._preempt_notices: set[str] = set()
        #: (attempt id, worker) -> the marks of the records already handled
        #: (the roads overlap: see _handle_backhaul)
        self._backhaul_seen: dict[tuple[str, str], set] = {}
        #: attempt id -> its channels, when a channel died under it
        self._failed_conns: dict[str, list[Transport]] = {}
        #: the road the most recent electron took ("rpc" or "launch")
        self.last_dispatch_mode = ""
        #: the stage timings of the last ``run`` (module docstring).
        self.last_timings: dict[str, float] = {}
        #: operation ids inside ``run``, the PIDs of their running harnesses
        #: (process 0's, and every process's of a gang) and the channel each
        #: process runs behind.
        self._active_ops: set[str] = set()
        self._pids: dict[str, list] = {}
        self._op_conns: dict[str, list[Transport]] = {}
        #: operation id -> its road, and the pool client it ran through
        self._op_modes: dict[str, str] = {}
        self._op_agents: dict[str, AgentClient] = {}
        #: operation ids a caller cancelled: their runs end in CancelledError.
        self._cancelled_ops: set[str] = set()
        #: pooled channels (pool key -> transport) behind a breaker per
        #: address; pool keys that passed pre-flight, and the codec names
        #: each worker advertised there
        self._pool = TransportPool()
        self._transports: dict[str, Transport] = self._pool._transports
        self._breakers = CircuitBreakerRegistry(
            failure_threshold=int(resolve(circuit_threshold, "circuit_threshold")),
            cooldown=float(resolve(circuit_cooldown, "circuit_cooldown")))
        self._preflighted: set[str] = set()
        self._wire_codecs: dict[str, list[str]] = {}
        #: channel address -> its resident pool server (None: the server
        #: could not start; the worker launches with nohup).
        self._agents: dict[str, AgentClient | None] = {}
        self._agent_locks: dict[str, asyncio.Lock] = {}
        #: per-connection artifacts the worker holds, and functions its
        #: resident runtime registered
        self._cas = CASIndex()
        self._fn_registry = FnRegistry()
        #: sid -> live serving-session supervisor (``serve_sessions``).
        self._serve_handles: dict[str, Any] = {}
        #: the LoRA adapter registry, built at first use (adapter_registry)
        self._adapter_registry = None
        #: seconds the last native agent took to build (0 when it was cached)
        self.agent_build_s = 0.0
        #: operation id -> fetched, digest-checked profile artifact
        #: (``last_timings["profile_trace"]``)
        self._profile_artifacts: dict[str, str] = {}
        #: detached compensating profile stops, held so they are not
        #: collected mid-await
        self._cleanup_tasks: set = set()

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
        """Reference: ``_validate_credentials`` (ssh.py:317-335)."""
        if self.transport_kind == "local":
            return True
        if not Path(self.ssh_key_file).is_file():
            raise RuntimeError(f"no SSH key file found at {self.ssh_key_file}; set "
                               "`ssh_key_file` or [executors.gpu].ssh_key_file")
        return True

    def _num_processes(self) -> int:
        return max(1, len(self.workers))

    def _worker_addresses(self) -> list[str]:
        """Every worker's control-plane address (tpu.py:1003-1028): the
        ``workers`` list, else ``hostname``, else (local transport only)
        this machine."""
        if self.workers:
            if len(set(self.workers)) != len(self.workers):
                # pids and pool keys are keyed by address: duplicates would alias
                raise ValueError(f"duplicate worker addresses: {self.workers}")
            return list(self.workers)
        if self.hostname:
            return [self.hostname]
        if self.transport_kind == "local":
            return ["localhost"]
        raise ValueError("GPUExecutor needs `hostname` or `workers` (or transport='local')")

    def _coordinator_address(self) -> str:
        """The gang's rendezvous (tpu.py:1065-1082).  Local-transport
        workers are processes on this machine, their labels bookkeeping
        names; an SSH gang meets on worker 0's host, ``user@`` and the SSH
        ``:port`` stripped (the process group dials its own port)."""
        host = "127.0.0.1"
        if self.transport_kind != "local":
            host, _ = _split_host_port(self._worker_addresses()[0].split("@", 1)[-1])
        port = self.coordinator_port
        if port == 0:
            if host not in _LOOPBACK:
                raise ValueError(f"coordinator_port=0 picks a free port on this machine, but "
                                 f"worker 0 ({host}) is another host; set coordinator_port")
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
        return f"{host}:{port}"

    def _make_transport(self, address: str) -> Transport:
        """A fresh, unopened channel to one worker (tpu.py:1096-1109),
        wrapped in the chaos plan's faults when there is one."""
        if self.transport_kind == "local":
            conn: Transport = LocalTransport()
        else:
            username = address.split("@", 1)[0] if "@" in address else self.username
            host, port = _split_host_port(address.split("@", 1)[-1])
            conn = SSHTransport(
                hostname=host, username=username, ssh_key_file=self.ssh_key_file,
                port=port or 22, strict_host_keys=self.strict_host_keys,
                backend="minissh" if self.transport_kind == "minissh" else "auto",
                known_host_key=self.known_host_key_file or None,
            )
        return ChaosTransport(conn, self._chaos) if self._chaos is not None else conn

    # -- the gang's lifecycle (reference: tpu.py:1289-1407, 2604-2690) ------

    @property
    def is_warm(self) -> bool:
        """Whether at least one pooled channel has passed pre-flight: the
        next electron skips the dial and the pre-flight."""
        return bool(self._preflighted)

    def gang_state(self) -> dict[str, Any]:
        """Placement's view: warmth and each worker's breaker state (an
        address never dialed reports ``closed``)."""
        try:
            addresses = self._worker_addresses()
        except ValueError:
            addresses = []
        states = self._breakers.states()
        return {"warm": self.is_warm, "workers": addresses,
                "breakers": ({a: states.get(a, "closed") for a in addresses}
                             if addresses else dict(states))}

    async def prewarm(self) -> bool:
        """Best-effort pre-dial of every worker (:meth:`lease_gang`: the
        dial, the pre-flight, the pool server's start) under an
        ``executor.prewarm`` span, so a node blocked on its upstream nodes
        pays none of it on its own critical path.  Single-flight; nothing
        when ``prewarm`` is off, under a chaos plan (its faults are for real
        dispatches) or when a prewarm already warmed the gang.  A failure is
        swallowed (``executor.prewarm_failed``): the dispatch meets it again
        with its retry envelope.  True when this call warmed the gang."""
        if not self.prewarm_enabled or self._chaos is not None or self._prewarmed:
            return False
        self._prewarmed = True  # concurrent callers skip
        started = time.monotonic()
        try:
            with Span("executor.prewarm", {"transport": self.transport_kind}):
                lease = await self.lease_gang()
        except asyncio.CancelledError:
            self._prewarmed = False
            raise
        except Exception as err:  # noqa: BLE001 - warming is advisory
            self._prewarmed = False  # a later node tries again
            _PREWARM_TOTAL.labels(result="failed").inc()
            obs_events.emit("executor.prewarm_failed", transport=self.transport_kind,
                            error=repr(err))
            app_log.debug("prewarm failed (the dispatch will retry): %s", err)
            return False
        _PREWARM_TOTAL.labels(result="warmed").inc()
        _PREWARM_SECONDS.labels(pool=self.pool_label).observe(time.monotonic() - started)
        obs_events.emit("executor.prewarm", transport=self.transport_kind,
                        workers=len(lease.conns))
        return True

    async def teardown_gang(self) -> bool:
        """Release the warm gang: its channels, pool servers and what was
        known under each key.  Refused (False) while an electron is in
        flight or a serving session is live, and when nothing is warm; the
        next dispatch or prewarm dials from cold."""
        if self._active_ops or self._serve_handles or not self.is_warm:
            return False
        await self._discard_workers()
        obs_events.emit("executor.gang_teardown", transport=self.transport_kind,
                        **({"pool": self.pool_label} if self.pool_label else {}))
        return True

    def _agent_of(self, address: str) -> AgentClient | None:
        """The resident runtime of a worker address (its pooled channel's
        address keys :attr:`_agents`) or of a channel address."""
        conn = self._transports.get(self._pool_key(address))
        client = self._agents.get(conn.address) if conn is not None else None
        return client if client is not None else self._agents.get(address)

    async def health_canary(self, address: str) -> bool:
        """One ping round trip to a worker's resident runtime: True when it
        answers.  The readmission probe for a worker health quarantined."""
        client = self._agent_of(address)
        if client is None or not client.alive:
            return False
        try:
            await client.ping(timeout=10.0)
            return True
        except (AgentError, TransportError, asyncio.TimeoutError, OSError):
            return False

    def _note_gang_stragglers(self, operation_id: str, addresses: list[str],
                              exit_at: dict[int, float]) -> None:
        """Flag a finished gang's straggler (tpu.py:2604-2652): a process
        whose exit lags the gang's median (``sorted(times)[n // 2]``) by
        more than ``COVALENT_TPU_STRAGGLER_BUDGET_S`` (default 5 s; 0
        disables) is gray-failing.  It is flagged to :data:`HEALTH`, and
        with ``COVALENT_TPU_STRAGGLER_REDIAL`` its channel is dropped, so
        the next electron dials fresh.  The median is the upper middle, as
        in the reference, so a gang of two is never flagged."""
        if len(exit_at) < 2:
            return
        try:
            budget = float(os.environ.get("COVALENT_TPU_STRAGGLER_BUDGET_S", "5") or 5)
        except ValueError:
            budget = 5.0
        if budget <= 0:
            return
        times = sorted(exit_at.values())
        median = times[len(times) // 2]
        slowest = max(exit_at, key=lambda i: exit_at[i])
        differential = exit_at[slowest] - median
        if differential <= budget:
            return
        worker = addresses[slowest] if slowest < len(addresses) else f"worker-{slowest}"
        HEALTH.flag_straggler(worker, differential, operation_id=operation_id,
                              gang_size=len(exit_at))
        if os.environ.get("COVALENT_TPU_STRAGGLER_REDIAL", "").strip().lower() in (
                "1", "on", "true", "yes"):
            task = asyncio.ensure_future(self._redial_straggler(worker))
            self._cleanup_tasks.add(task)
            task.add_done_callback(self._cleanup_tasks.discard)

    async def _redial_straggler(self, address: str) -> None:
        """Drop one straggler's pooled channel, its pool server and what was
        known under its key (tpu.py:2669-2690): the next electron dials,
        pre-flights and probes afresh."""
        conn = self._transports.get(self._pool_key(address))
        if conn is not None:
            await self._discard_workers([conn])
        obs_events.emit("fleet.straggler_redial", worker=address, discarded=conn is not None)

    def _status_snapshot(self) -> dict[str, Any]:
        """This executor's state for an operator (tpu.py:906-935): workers,
        liveness settings, the electrons in flight with their heartbeats,
        breakers, health and resident runtimes."""
        try:
            addresses = self._worker_addresses()
        except ValueError:
            addresses = []
        return {
            "transport": self.transport_kind, "workers": addresses,
            "heartbeat_interval_s": self.heartbeat_interval,
            "stall_after_s": self._stall_after(), "dispatch_mode": self.dispatch_mode,
            "rpc_registered": self._fn_registry.counts(), "serving": self.serve_sessions(),
            "in_flight": {op: {"mode": self._op_modes.get(op, ""),
                               "pids": list(self._pids.get(op, ())),
                               "heartbeats": MONITOR.last(op)}
                          for op in sorted(self._active_ops)},
            "circuit_breakers": self._breakers.states(), "health": HEALTH.snapshot(),
            "warm": self.is_warm,
            "agents": {address: (client.mode if client is not None else None)
                       for address, client in self._agents.items()},
        }

    def _pool_key(self, address: str) -> str:
        return f"{self.transport_kind}:{address}"

    async def _client_connect(self, address: str) -> Transport:
        """Open (or reuse) the channel to one worker (reference:
        ``_client_connect``, ssh.py:210-282): pooled, with the dial's retry
        envelope, behind the address's breaker, so a quarantined host fails
        fast instead of paying the envelope on every electron."""

        async def factory() -> Transport:
            return await connect_with_retries(
                self._make_transport(address), max_attempts=self.max_connection_attempts,
                retry_wait_time=self.retry_wait_time)

        return await self._pool.acquire(self._pool_key(address), factory,
                                        gate=self._breakers.get(address))

    async def _connect_all(self) -> list[Transport]:
        """Channels to every worker, dialed together, all or nothing."""
        addresses = self._worker_addresses()
        results = await asyncio.gather(*(self._client_connect(a) for a in addresses),
                                       return_exceptions=True)
        errors = [r for r in results if isinstance(r, BaseException)]
        if errors:
            raise TransportError(f"failed to connect to {len(errors)}/{len(addresses)} "
                                 f"workers: {errors[0]}") from errors[0]
        return list(results)  # type: ignore[arg-type]

    def _preflight_command(self) -> str:
        """One compound pre-flight (tpu.py:1652-1693): the reference's three
        round trips (conda check, python3 check, cache mkdir; ssh.py:508-532),
        the CAS's TTL prune (before the channel's first existence probe, so
        its present set never names a pruned file) and the codec probe in
        one exec.  ``-E -S`` keeps site hooks out of the version check."""
        cas_dir = shlex.quote(cas_path(self.remote_cache, "").rstrip("/"))
        checks = [f"mkdir -p {shlex.quote(self.remote_cache)} {cas_dir}"]
        prune = self._cas_prune_clause()
        if prune:
            checks.append(f"({prune} || true)")
        if self.conda_env:
            checks.append(f'eval "$(conda shell.bash hook)" && conda activate '
                          f"{shlex.quote(self.conda_env)}")
        probe = codec_mod.probe_clause(self.python_path, self.compress)
        if probe:
            checks.append(probe)
        checks.append(f"{self.python_path} -E -S -c 'import sys; print(sys.version_info[0])'")
        return " && ".join(checks)

    def _cas_prune_clause(self) -> str | None:
        """The CAS's age prune as a shell clause (tpu.py:1720-1729); None
        when ``cas_ttl_hours`` is 0."""
        if self.cas_ttl_hours <= 0:
            return None
        cas_dir = shlex.quote(cas_path(self.remote_cache, "").rstrip("/"))
        minutes = max(1, int(self.cas_ttl_hours * 60))
        return f"find {cas_dir} -type f -mmin +{minutes} -exec rm -f {{}} + 2>/dev/null"

    def _cas_maintenance_command(self, staged: StagedTask) -> str:
        """The CAS's upkeep after one launched electron, one round trip
        (tpu.py:1731-1762): ``touch -c`` of its hot artifacts (the function
        pickle and the harness), then the TTL prune, then the byte budget,
        which prints ``CAS_EVICTED=<n>``.  The touch comes first, so the
        electron's own artifacts are the newest and go last."""
        hot = " ".join(shlex.quote(p)
                       for p in (staged.remote_function_file, staged.remote_harness_file))
        parts = [f"touch -c {hot} 2>/dev/null"]
        prune = self._cas_prune_clause()
        if prune:
            parts.append(prune)
        if self.cas_max_bytes > 0:
            parts.append(cas_bytes_prune_command(
                self.python_path, cas_path(self.remote_cache, "").rstrip("/"),
                self.cas_max_bytes))
        return "; ".join(parts) + "; true"

    async def _preflight(self, conn: Transport, key: str) -> None:
        """The environment checks, once per pooled connection (the reference
        runs them on every electron).  A host that fails them counts against
        its breaker as a refused dial does."""
        if key in self._preflighted:
            return
        breaker = self._breakers.get(key.split(":", 1)[1])
        try:
            result = await conn.run(self._preflight_command())
            if result.exit_status != 0:
                raise TransportError(f"pre-flight failed on {conn.address}: "
                                     f"{result.stderr.strip()}")
            lines = result.stdout.strip().splitlines()
            if not lines or lines[-1] != "3":
                raise TransportError(f"{self.python_path} on {conn.address} is not python3 "
                                     f"(reported major version {result.stdout.strip()!r})")
        except (TransportError, OSError):
            breaker.record_failure()
            raise
        breaker.record_success()
        self._wire_codecs[key] = codec_mod.parse_probe(result.stdout)
        self._preflighted.add(key)

    def _codec_for(self, key: str, conn: Transport) -> "codec_mod.Codec | None":
        """The connection's wire codec (None: raw), tpu.py:1695-1718.  A
        zero-wire transport ships raw; a pinned codec the worker did not
        advertise degrades to raw with a warning."""
        if self.compress == "off" or getattr(conn, "zero_wire", False):
            return None
        remote = self._wire_codecs.get(key, ())
        if self.compress in ("zlib", "zstd"):
            if self.compress in remote and self.compress in codec_mod.available_codecs():
                return codec_mod.get_codec(self.compress)
            app_log.warning("compress=%r pinned but %s did not negotiate it; shipping raw",
                            self.compress, conn.address)
            return None
        return codec_mod.pick_codec(remote)

    def _write_function_files(
        self, operation_id: str, fn: Callable, args: tuple, kwargs: dict,
        workdir: str, pip_deps=(), lineage: str = "", resume: dict | None = None,
        trace: dict | None = None, run: str = "", payload: bytes | None = None,
    ) -> StagedTask:
        """Stage the function pickle and one task spec per process locally
        (reference: ``ssh.py:126-179``, ``tpu.py:1494-1566``).

        ``lineage`` names the checkpoints (``checkpoint_interval_s``) and
        ``run`` the run they belong to (its base operation id: the worker's
        manifest keeps one run's), ``resume`` a checked bundle the attempt
        ships to every process, and ``trace`` the trace context stamped on
        the workers' events.  ``payload`` is the ``(fn, args, kwargs)``
        cloudpickle when the result cache already made it (one pass serves
        both).
        """
        from .parallel.distributed import coordinator_spec

        Path(self.cache_dir).mkdir(parents=True, exist_ok=True)
        processes = self._num_processes()
        staged = StagedTask(operation_id, Path(self.cache_dir), self.remote_cache, processes)
        if payload is None:
            dump_task(fn, args, kwargs, staged.function_file)
            with open(staged.function_file, "rb") as f:
                payload = f.read()
        else:
            with open(staged.function_file, "wb") as f:
                f.write(payload)
        function_digest = staged.function_digest = bytes_digest(payload)
        blocks = (coordinator_spec(coordinator_address=self._coordinator_address(),
                                   num_processes=processes) if processes > 1 else None)
        checkpoint_block = None
        if self.checkpoint_interval_s > 0:
            checkpoint_block = {"dir": cas_path(self.remote_cache, "").rstrip("/"),
                                "lineage": lineage or operation_id, "run": run,
                                "interval_s": self.checkpoint_interval_s,
                                "keep_n": self.checkpoint_keep_n}
        resume_block = None
        if resume and resume.get("local") and resume.get("digest"):
            remote_bundle = f"{self.remote_cache}/resume_{operation_id}.ckpt"
            staged.resume_artifact = (resume["local"], remote_bundle, resume["digest"])
            resume_block = {"file": remote_bundle, "step": int(resume.get("step", 0)),
                            "digest": resume["digest"]}
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
            if trace:
                spec["trace"] = trace
            if self.heartbeat_interval > 0:
                spec["heartbeat_s"] = self.heartbeat_interval
            if self.heartbeat_interval > 0 or checkpoint_block is not None:
                # the worker's events and beats; the poll and the pool
                # channel read it back
                spec["telemetry_file"] = files["telemetry"]
            if checkpoint_block is not None:
                spec["checkpoint"] = checkpoint_block
            if resume_block is not None:
                spec["resume"] = resume_block
            encoded = json.dumps(spec).encode()
            with open(files["spec"], "wb") as f:
                f.write(encoded)
            staged.spec_digests[i] = bytes_digest(encoded)
        return staged

    async def _upload_task(self, conn: Transport, staged: StagedTask, process: int,
                           key: str) -> None:
        """Ship process ``process``'s files to its worker (reference:
        ``ssh.py:337-361``, ``tpu.py:1802-1850``).

        The harness and the function pickle go through the CAS: skipped when
        the worker holds their digests (one probe per connection).  The
        operation's own file (this process's spec) ships every time.  With
        ``bundle`` whatever ships goes as one tar (one put, one unpack
        exec, each member checked against its digest); either road
        compresses with the connection's codec when that pays.
        """
        shared = [staged.harness_artifact(), staged.function_artifact()]
        await self._cas.ensure_probed(key, conn, [(digest, remote) for _, remote, digest in shared])
        codec = self._codec_for(key, conn)
        if self.bundle:
            await self._cas.ensure_bundle(key, conn, shared, op_files=staged.artifacts(process),
                                          codec=codec, python_path=self.python_path)
        else:
            for local, remote, digest in shared:
                await self._cas.ensure(key, conn, digest, local, remote, codec=codec,
                                       python_path=self.python_path)
            for local, remote, file_digest in staged.artifacts(process):
                await codec_mod.put_file(conn, local, remote, codec=codec,
                                         python_path=self.python_path, digest=file_digest)
        if staged.resume_artifact is not None:
            # Outside the bundle and the CAS (StagedTask.resume_artifact),
            # published by rename; the electron checks its digest before it
            # restores.
            local, remote, _ = staged.resume_artifact
            tmp = f"{remote}.tmp.{os.getpid()}.{process}"
            await conn.put(local, tmp)
            await conn.rename(tmp, remote)

    def _task_command(self, staged: StagedTask, process: int = 0) -> str:
        # `exec` makes the harness replace the wrapper shell, so the PID
        # captured at launch is the python process itself, conda or not.
        return _in_conda(
            f"exec {self.python_path} {shlex.quote(staged.remote_harness_file)} "
            f"{shlex.quote(staged.rank(process)['remote_spec'])}", self.conda_env)

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
                         pid: int | None, process: int = 0,
                         feed: _TelemetryFeed | None = None) -> TaskStatus:
        """Combined result-exists + process-alive probe, one round trip.

        Zombie-aware: ``kill -0`` answers true for a zombie, and a
        nohup-launched harness can stay one on hosts without a reaping
        init, so the probe reads the process state first.  A process found
        gone is checked for its result once more: it may have written it and
        exited between the first check and the liveness test, and once it is
        gone the second check cannot miss it.  With ``feed`` the same round
        trip first reads the new lines of the process's telemetry file
        (the poll road's heartbeats and worker events).
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
            (feed.clause(files["telemetry"], process) if feed is not None else "")
            + f"if test -f {result_file}; then {found}; "
            + liveness + f"else {gone}; fi"
        )
        result = await conn.run(probe)
        stdout = feed.consume(process, result.stdout) if feed is not None else result.stdout
        lines = stdout.strip().splitlines()
        try:
            return TaskStatus(lines[-1] if lines else "")
        except ValueError:
            raise TransportError(
                f"status probe on {conn.address} failed: {result.stderr.strip()!r}"
            )

    #: How long a gang's processes 1.. may take to leave once process 0 wrote
    #: the result (they leave the process group and write their markers).
    GANG_EXIT_GRACE_S = 60.0

    async def _poll_task(self, conns: list[Transport], staged: StagedTask,
                         pids: list[int | None], feed: _TelemetryFeed | None = None,
                         exit_at: dict[int, float] | None = None) -> tuple[TaskStatus, int]:
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
        late marker; what is left after it is killed.  ``conns[i]`` is the
        channel process ``i`` runs behind.  With heartbeats on (``feed``
        reads them) a running worker silent past its stall threshold ends
        the wait as STALLED, before ``task_timeout`` would.  ``exit_at``
        receives, for each process, the loop time of the first probe that
        found it finished (the straggler bookkeeping of tpu.py:2560-2600).
        """
        interval, waited, starting_for, ready_for = 0.05, 0.0, 0.0, 0.0
        loop = asyncio.get_running_loop()
        watch_stalls = feed is not None and self._stall_after() > 0
        while True:
            statuses = await asyncio.gather(*(
                self.get_status(conns[i], staged, pid, i, feed) for i, pid in enumerate(pids)))
            for i, status in enumerate(statuses[1:], start=1):
                if status is TaskStatus.DEAD:
                    return TaskStatus.DEAD, i
            live = [i for i, st in enumerate(statuses)
                    if st in (TaskStatus.RUNNING, TaskStatus.STARTING)]
            if exit_at is not None:
                now = loop.time()
                for i, st in enumerate(statuses):
                    if st is TaskStatus.READY:
                        exit_at.setdefault(i, now)
            if 0 not in live and (statuses[0] is not TaskStatus.READY or not live):
                return statuses[0], 0
            if 0 not in live:
                if ready_for >= self.GANG_EXIT_GRACE_S:
                    app_log.warning("task %s: gang processes %s still running %.0f s after "
                                    "process 0 finished; killing them", staged.operation_id,
                                    live, self.GANG_EXIT_GRACE_S)
                    await self._kill(conns, staged)
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
                if watch_stalls:
                    stalled = await self._stall_verdict(staged.operation_id, conns, staged, feed)
                    if stalled:
                        return TaskStatus.STALLED, feed.workers.index(stalled[0][0])
            await asyncio.sleep(interval)
            waited += interval
            interval = min(interval * 2, float(self.poll_freq))

    async def query_result(self, conn: Transport, staged: StagedTask, key: str | None = None):
        """Fetch and unpickle ``(result, exception, times)`` (reference:
        ``ssh.py:434-458``).  Under a pinned codec (``compress="zlib"`` or
        ``"zstd"``) the result rides the wire compressed, at the cost of one
        pack exec (tpu.py:2976-2995); ``auto`` never pays that."""
        codec = (self._codec_for(key, conn)
                 if key is not None and self.compress in ("zlib", "zstd") else None)
        await codec_mod.get_file(conn, staged.remote_result_file, staged.local_result_file,
                                 codec=codec, python_path=self.python_path)
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

    async def _kill(self, conns: list[Transport], staged: StagedTask) -> None:
        """``run``'s own teardown of its harnesses (cancellation, a gang
        whose process failed), each behind its own channel.  A channel that
        is gone leaves its process to the worker (logged)."""
        for conn, pid in zip(conns, self._pids.get(staged.operation_id, ())):
            if pid is not None:
                try:
                    await self._kill_group(conn, pid)
                except (TransportError, OSError) as err:
                    app_log.warning("task %s: could not signal pid %s on %s (%s)",
                                    staged.operation_id, pid, conn.address, err)

    async def _escalate_timeout(self, operation_id: str, conns: list[Transport],
                                reason: str = "timeout") -> int:
        """Reap a timed-out or stalled attempt (tpu.py:3100-3175): TERM every
        process group, a grace of ``TIMEOUT_KILL_GRACE_S`` for the gang's
        cleanup handlers, KILL whatever is left, then count the survivors
        (logged; returned).  A stopped process cannot act on TERM, so it
        is KILLed at once instead of costing the grace; and a process of
        the group left on the card would keep its context and its memory.
        Not :meth:`cancel`: this is a failure classified for a retry, never
        a user's cancel."""
        pids = list(self._pids.get(operation_id, ()))
        obs_events.emit("task.timeout_escalated" if reason == "timeout"
                        else "task.stall_escalated", operation_id=operation_id,
                        timeout_s=self.task_timeout, pids=pids,
                        **({} if reason == "timeout" else {"stall_after_s": self._stall_after()}))
        app_log.warning("task %s %s; killing its processes %s", operation_id,
                        f"exceeded task_timeout={self.task_timeout:.1f}s" if reason == "timeout"
                        else f"stalled (no heartbeat for {self._stall_after():.1f}s)", pids)
        started = time.monotonic()

        def group(pid: int, sig: str) -> str:
            # group and pid: the pid alone covers the window before setsid
            return f"kill -s {sig} -- -{pid} 2>/dev/null; kill -s {sig} {pid} 2>/dev/null"

        def members(pid: int) -> str:
            # the session's processes that are neither zombies nor gone
            return f"ps -o stat= -s {pid} 2>/dev/null | grep -vc '^Z'"

        async def run(conn: Transport, command: str) -> str:
            try:
                return (await conn.run(command)).stdout.strip()
            except (TransportError, OSError) as err:
                app_log.warning("task %s: escalation on %s failed (%s)", operation_id,
                                conn.address, err)
                return ""

        live = [(c, p) for c, p in zip(conns, pids) if p is not None]
        # TERM, then KILL at once what is stopped (state T): TERM waits on it
        stopped = await asyncio.gather(*(run(c, (
            f"{group(p, 'TERM')}; if ps -o stat= -s {p} 2>/dev/null | grep -q '^T'; "
            f"then {group(p, 'KILL')}; echo STOPPED; fi; true")) for c, p in live))
        waited = 0.0
        while waited < self.TIMEOUT_KILL_GRACE_S and not all(s == "STOPPED" for s in stopped):
            counts = await asyncio.gather(*(run(c, members(p)) for c, p in live))
            if all(count in ("", "0") for count in counts):
                break
            await asyncio.sleep(0.1)
            waited += 0.1
        await asyncio.gather(*(run(c, f"{group(p, 'KILL')}; true") for c, p in live))
        survivors = 0
        for _ in range(20):  # a KILLed process is gone once the kernel reaps it
            counts = await asyncio.gather(*(run(c, members(p)) for c, p in live))
            survivors = sum(int(count) for count in counts if count.isdigit())
            if not survivors:
                break
            await asyncio.sleep(0.05)
        seconds = time.monotonic() - started
        obs_events.emit("task.escalated", operation_id=operation_id, reason=reason,
                        survivors=survivors, seconds=round(seconds, 6),
                        stopped=sum(s == "STOPPED" for s in stopped))
        (app_log.error if survivors else app_log.info)(
            "task %s: escalation took %.2fs, %d process(es) survived", operation_id,
            seconds, survivors)
        return survivors

    def _stall_after(self) -> float:
        """Seconds of heartbeat silence that declare a worker stalled
        (tpu.py:899): ``stall_threshold``, else three intervals; 0 without
        heartbeats."""
        if self.heartbeat_interval <= 0:
            return 0.0
        if self.stall_threshold > 0:
            return self.stall_threshold
        return 3.0 * self.heartbeat_interval

    async def cancel(self, operation_id: str | None = None, mark: bool = True) -> None:
        """Kill the harness of every run whose operation id is
        ``operation_id`` or starts with ``f"{operation_id}_"`` (every run
        when None); the reference's signature (``tpu.py:3046``).

        The workflow runner cancels a node as ``f"{dispatch_id}_{node_id}"``,
        which prefixes that node's uuid-suffixed operation ids.  ``mark``
        records the cancel first, so the killed run ends in
        ``asyncio.CancelledError`` and not in a task failure, and a run that
        has not launched its harness yet stops before it does.  A retry
        attempt (``{base}.r{n}``) is reached through its run's base id, also
        between two attempts.
        """
        targets = [op for op in self._active_ops
                   if operation_id is None or op == operation_id
                   or op.startswith(f"{operation_id}_")
                   or self._attempt_base.get(op) == operation_id]
        if mark:
            self._cancelled_ops.update(targets)
        for op in targets:
            for conn, pid in zip(self._op_conns.get(op, ()), list(self._pids.get(op, ()))):
                if pid is not None:
                    try:
                        await self._kill_group(conn, pid)
                    except (TransportError, OSError) as err:
                        app_log.warning("cancel: could not signal pid %s on %s (%s)", pid,
                                        conn.address, err)

    def _is_cancelled(self, operation_id: str) -> bool:
        """Whether this attempt, or its run, was cancelled."""
        return (operation_id in self._cancelled_ops
                or self._attempt_base.get(operation_id) in self._cancelled_ops)

    def attempts_of(self, operation_id: str) -> int:
        """Attempts the lineage ``{dispatch_id}_{node_id}`` took in its
        latest run (1 when unknown); the record is popped.  The workflow
        runner stamps it on its node events."""
        return self._op_attempts.pop(operation_id, 1)

    async def cleanup(self, conns: list[Transport], staged: StagedTask) -> None:
        """Delete the operation's staged files locally and on each worker
        (reference: ``ssh.py:284-315``, ``tpu.py:3189-3270``); the CAS
        artifacts stay, and each worker's CAS gets its upkeep
        (:meth:`_cas_maintenance_command`, best-effort).  What the byte
        budget evicted is counted, and the channel's present set is
        forgotten, so the next electron probes again instead of trusting a
        digest whose file is gone."""
        for path in staged.local_files():
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
        for i, conn in enumerate(conns):
            result = await conn.remove(staged.remote_files(i))
            if result.exit_status != 0:
                app_log.warning("cleanup on %s: %s", conn.address, result.stderr.strip())
            try:
                maintained = await conn.run(self._cas_maintenance_command(staged))
            except (TransportError, OSError) as err:
                app_log.debug("CAS maintenance on %s skipped: %s", conn.address, err)
                continue
            evicted = 0
            for token in (maintained.stdout or "").split():
                if token.startswith("CAS_EVICTED="):
                    try:
                        evicted = int(token.split("=", 1)[1])
                    except ValueError:
                        pass
                    break
            if evicted > 0:
                CAS_EVICTIONS_TOTAL.labels(site="remote").inc(evicted)
                obs_events.emit("cas.bytes_pruned", root=cas_path(self.remote_cache, ""),
                                evicted=evicted, budget=self.cas_max_bytes, site="remote",
                                worker=conn.address)
                for key, pooled in list(self._transports.items()):
                    if pooled is conn:
                        self._cas.forget(key)

    # ------------------------------------------------------------------ #
    # Resident pool servers (reference: tpu.py lease_gang, _agent_for,   #
    # _submit_via_agent, _discard_workers, close)                         #
    # ------------------------------------------------------------------ #

    def serve_sessions(self) -> dict[str, dict[str, Any]]:
        """sid -> live serving-session view (state, slots, queue depth,
        tokens/s)."""
        return {sid: handle.status() for sid, handle in list(self._serve_handles.items())}

    def adapter_registry(self):
        """This executor's LoRA adapter registry over ``{cache_dir}/cas``
        (reference ``tpu.py:963-972``), built at first use: register bundles
        here (``put``) and the sessions opened on this executor attach them
        by name."""
        if self._adapter_registry is None:
            from .serving.registry import AdapterRegistry

            self._adapter_registry = AdapterRegistry(self.cache_dir)
        return self._adapter_registry

    async def lease_gang(self, dialed: list[Transport] | None = None) -> GangLease:
        """Connect to every worker, pre-flight each new channel and warm
        its pool server (tpu.py:1234-1280).

        The dial and the pool server's start or ping are the ``connect``
        stage, the pre-flight the ``preflight`` stage.  ``dialed`` receives
        the channels as soon as they exist, before pre-flight or the
        warm-up can fail, so a caller that discards a failed attempt's
        channels holds them either way.
        """
        with Span("executor.connect"):
            conns = await self._connect_all()
        if dialed is not None:
            dialed.extend(conns)
        addresses = self._worker_addresses()
        keys = [self._pool_key(a) for a in addresses]
        with Span("executor.preflight"):
            await asyncio.gather(*(self._preflight(c, k) for c, k in zip(conns, keys)))
        with Span("executor.connect"):
            await asyncio.gather(*(self._agent_for(c, k) for c, k in zip(conns, keys)))
        return GangLease(conns, addresses)

    async def _stage_harness(self, conn: Transport, key: str) -> str:
        """The harness in the worker's CAS (shipped once per connection);
        returns its remote path, which the pool server runs."""
        staged_path = cas_path(self.remote_cache, harness_digest(), ".py")
        await self._cas.ensure_probed(key, conn, [(harness_digest(), staged_path)])
        await self._cas.ensure(key, conn, harness_digest(), _harness_module.__file__,
                               staged_path, codec=self._codec_for(key, conn),
                               python_path=self.python_path)
        return staged_path

    async def _agent_for(self, conn: Transport, key: str) -> AgentClient | None:
        """A live resident runtime for this worker, or None (``use_agent``
        off, or no runtime could start: the worker is then remembered as
        having none, and electrons launch with nohup + poll).

        The ladder (tpu.py:1903-1990): ``True``/``"auto"`` try the pool
        server, then the native agent; ``"pool"`` and ``"native"`` try only
        that one.  Under ``"native"`` an agent that does not build or start
        raises :class:`AgentError` (the reference falls back to nohup).  A
        cached runtime is proved by a ping before it is handed out; one that
        fails it is replaced.  One start at a time per worker.
        """
        if not self.use_agent:
            return None
        modes = (["pool", "native"] if self.use_agent in (True, "auto")
                 else [str(self.use_agent)])
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
            errors: dict[str, str] = {}
            for mode in modes:
                try:
                    if mode == "pool":
                        harness_path = await self._stage_harness(conn, key)
                        client = await self._try_adopt_orphan(conn, harness_path)
                        if client is None:
                            client = await start_pool_server(
                                conn, self.remote_cache, self.python_path, env=self.task_env,
                                preload=self.pool_preload, frames_enabled=self.agent_frames,
                                harness_path=harness_path, conda_env=self.conda_env,
                            )
                    else:
                        t0 = time.perf_counter()
                        binary = await ensure_agent_binary(conn, self.remote_cache)
                        self.agent_build_s = time.perf_counter() - t0
                        client = await AgentClient.start(
                            conn, binary, frames_enabled=self.agent_frames, env=self.task_env,
                            conda_env=self.conda_env)
                except (AgentError, TransportError, OSError) as err:
                    errors[mode] = repr(err)
                    app_log.info("worker %s: no %s runtime (%s)", conn.address, mode, err)
                    continue
                self._agents[conn.address] = client
                await self._declare_epoch(client)
                obs_events.emit("agent.started", address=conn.address, mode=client.mode)
                return client
            error = "; ".join(f"{m}: {e}" for m, e in errors.items())
            obs_events.emit("agent.unavailable", address=conn.address, tried=modes,
                            error=error)
            if self.use_agent == "native":
                # pinned: no other road may hide the agent's absence
                raise AgentError(f"worker {conn.address}: the native agent did not start "
                                 f"({error})")
            app_log.info("worker %s: no resident runtime; using nohup + poll", conn.address)
            self._agents[conn.address] = None
            return None

    async def _runner(self, conn: Transport, key: str, mode: str) -> list[str]:
        """The argv the native agent forks for an RPC invocation
        (``--rpc-child``) or a serving session (``--serve-child``): the
        harness in the worker's CAS, its stderr appended to
        ``{remote_cache}/agent_child.log``."""
        harness_path = await self._stage_harness(conn, key)
        return [self.python_path, harness_path, mode, "--log",
                f"{self.remote_cache}/agent_child.log"]

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

    async def _try_adopt_orphan(self, conn: Transport, harness_path: str) -> AgentClient | None:
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
                journal.epoch, frames_enabled=self.agent_frames, harness_path=harness_path,
                conda_env=self.conda_env,
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
        """Drop the pooled channels (``None``: all of them) after a
        control-plane failure, so the next lease redials (tpu.py:1161-1214).

        ``conns`` scopes the discard to the channels the caller saw fail: a
        fresh channel another electron redialed under the same key stays.
        A pool server lives and dies with its channel (an SSH server kills
        the command when the channel closes), so a discarded channel's
        server is closed too, and what the executor knew under that key is
        forgotten: the pre-flight, the codec, the artifacts the worker
        holds and the functions its runtime registered.
        """
        for key, conn in list(self._transports.items()):
            if conns is not None and not any(conn is c for c in conns):
                continue
            client = self._agents.pop(conn.address, None)
            if client is not None:
                await client.close()  # while its channel still carries the EOF
            await self._pool.discard(key)
            self._preflighted.discard(key)
            self._wire_codecs.pop(key, None)
            self._cas.forget(key)
            self._fn_registry.forget(key)
        # a worker recreated behind a discarded channel is dialed again by
        # the next prewarm too
        self._prewarmed = False

    async def close(self) -> None:
        """Shut every pool server down and release the channels."""
        await self._discard_workers()
        await self._pool.close_all()

    async def _resident_client(self, dialed: list[Transport]) -> AgentClient | None:
        """Worker 0's live pool server (None without one): its start on
        first use, a ping after."""
        lease = await self._lease(dialed)
        client = self._agents.get(lease.conns[0].address)
        return client if client is not None and client.alive else None

    @staticmethod
    def _task_id(staged: StagedTask, process: int) -> str:
        """The pool's id of one process of the task (process 0: the operation id)."""
        return staged.operation_id if process == 0 else f"{staged.operation_id}.{process}"

    async def _submit_via_agent(self, client: AgentClient, conn: Transport,
                                staged: StagedTask, process: int = 0) -> int:
        """Start one process's staged harness through the resident runtime
        (a fork of the pool's zygote, or the native agent's exec of the
        command line :meth:`submit_task` runs); returns its pid.  The task's
        files are those of a nohup launch, so every probe (pid liveness,
        result file, kill by pid) still works if the channel dies later."""
        files = staged.rank(process)
        try:
            if client.mode != "pool":
                return await client.run_task(
                    self._task_id(staged, process), log=files["log"],
                    argv=["/bin/sh", "-c", self._task_command(staged, process)])
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
                                staged: StagedTask, pid: int,
                                feed: _TelemetryFeed | None = None) -> TaskStatus:
        """Wait for the pushed ``exit`` event instead of polling.

        The exit resolves the task through the result file (the polling
        road's READY); a task whose exit the server could not see (its
        zygote died) or a channel that died meanwhile falls back to the
        status probes, which the task's own files answer.  With heartbeats
        on (the pool channel tails them back) the wait wakes on a short
        tick to consult the stall detector; a suspected stall is confirmed
        against the worker's telemetry and heartbeat snapshot, read up to
        now, before it ends the wait (:meth:`_stall_verdict`).
        """
        operation_id = staged.operation_id
        stall_after = self._stall_after() if feed is not None else 0.0
        wake = min(1.0, max(0.25, stall_after / 4.0)) if stall_after else None
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.task_timeout if self.task_timeout else None
        waiter = asyncio.ensure_future(client.wait_exit(operation_id))
        try:
            while True:
                remaining = None if deadline is None else deadline - loop.time()
                if remaining is not None and remaining <= 0:
                    return TaskStatus.TIMEOUT
                timeout = wake if remaining is None else (
                    remaining if wake is None else min(wake, remaining))
                done, _ = await asyncio.wait({waiter}, timeout=timeout)
                if done:
                    break
                if wake is not None and await self._stall_verdict(operation_id, [conn], staged,
                                                                  feed):
                    return TaskStatus.STALLED
            try:
                waiter.result()
            except AgentError as err:
                app_log.info("task %s: pool channel died (%s); polling its files",
                             operation_id, err)
                return (await self._poll_task([conn], staged, [pid], feed))[0]
        finally:
            waiter.cancel()
            try:
                await waiter
            except (asyncio.CancelledError, AgentError):
                pass
        # the side-band delivered the telemetry: no second read of it here
        status = await self.get_status(conn, staged, pid)
        if status in (TaskStatus.RUNNING, TaskStatus.STARTING):
            return (await self._poll_task([conn], staged, [pid], feed))[0]
        return status

    # ------------------------------------------------------------------ #
    # Liveness and checkpoints (reference: tpu.py:2093-2480)              #
    # ------------------------------------------------------------------ #

    def _record_heartbeat(self, operation_id: str, worker: str, heartbeat: dict) -> None:
        """File one heartbeat in the liveness monitor; a fresh one (a new
        ``seq``: the roads re-read) is re-emitted as ``worker.heartbeat``."""
        if not MONITOR.record(operation_id, worker, heartbeat):
            return
        # the health monitor's passive feed: the cadence of the same fresh
        # beats (an erratic one loses score before a beat is missed)
        HEALTH.record_heartbeat(worker)
        body = {k: v for k, v in heartbeat.items() if k not in ("type", "pid", "ts")}
        worker_ts = heartbeat.get("ts")
        obs_events.emit("worker.heartbeat", worker=worker,
                        **({"worker_ts": worker_ts} if worker_ts else {}), **body)

    def _handle_backhaul(self, operation_id: str, worker: str, data: dict) -> None:
        """One worker record from either road (the poll's telemetry read,
        the pool channel's side-band, a stall verdict's read of the file).
        A record already delivered (the same ``seq``, or for a record
        without one the same type and time) is dropped.  Heartbeats feed
        the monitor; the start of a save or a restore holds the worker's
        stall clock and its end (saved, failed, restored) releases it; a
        checkpoint is recorded and mirrored; a preemption notice relabels
        the coming death; every other record is re-emitted into the
        dispatcher's stream (``backhaul=True``)."""
        seq = data.get("seq")
        mark = seq if isinstance(seq, int) else (data.get("type"), data.get("ts"))
        seen = self._backhaul_seen.setdefault((operation_id, worker), set())
        if mark in seen:
            return
        seen.add(mark)
        kind = data.get("type")
        if kind == "worker.heartbeat":
            self._record_heartbeat(operation_id, worker, data)
            return
        if kind in ("worker.checkpoint_started", "worker.restore_started"):
            MONITOR.hold(operation_id, worker, self.SAVE_HOLD_S)
        elif kind in ("worker.checkpoint_saved", "worker.checkpoint_error",
                      "worker.restore_done"):
            MONITOR.release(operation_id, worker)
        if kind == "worker.checkpoint_saved":
            self._record_checkpoint(operation_id, worker, data)
        elif kind == "worker.preempt_notice":
            self._preempt_notices.add(operation_id)
        body = {k: v for k, v in data.items() if k not in ("type", "ts")}
        worker_ts = data.get("ts")
        obs_events.emit(str(kind or "worker.event"), worker=worker, backhaul=True,
                        **({"worker_ts": worker_ts} if worker_ts else {}), **body)

    def _local_bundle_path(self, digest: str) -> str:
        return os.path.join(self.cache_dir, "cas", f"{digest}.ckpt")

    def _record_checkpoint(self, operation_id: str, worker: str, data: dict) -> None:
        """File one ``worker.checkpoint_saved`` (tpu.py:2185): counted once
        per (lineage, step, digest), kept newest first, and its bundle
        mirrored into the local CAS off the critical path, so a resume
        survives the worker that wrote it."""
        lineage, digest = str(data.get("lineage") or ""), str(data.get("digest") or "")
        try:
            step = int(data.get("step"))
        except (TypeError, ValueError):
            return
        if not lineage or not digest or (lineage, step, digest) in self._ckpt_seen:
            return
        self._ckpt_seen.add((lineage, step, digest))
        CHECKPOINT_SAVES_TOTAL.labels(trigger=str(data.get("trigger") or "interval")).inc()
        entry = {"step": step, "digest": digest, "file": str(data.get("path") or ""),
                 "worker": worker}
        records = self._ckpt_records.setdefault(lineage, [])
        records[:] = [r for r in records if r["step"] != step]
        records.append(entry)
        records.sort(key=lambda r: r["step"], reverse=True)
        for dropped in records[max(2, self.checkpoint_keep_n):]:
            self._drop_mirror(dropped)
        del records[max(2, self.checkpoint_keep_n):]
        conns = self._op_conns.get(operation_id) or []
        try:
            index = self._worker_addresses().index(worker)
        except ValueError:
            index = 0
        if index < len(conns):
            task = asyncio.ensure_future(self._mirror_checkpoint(conns[index], entry))
            self._cleanup_tasks.add(task)
            task.add_done_callback(self._cleanup_tasks.discard)

    def _drop_mirror(self, entry: dict) -> None:
        """Forget a record's local mirror (it fell out of keep_n, or its
        lineage's run ended)."""
        local = entry.pop("local", None)
        if local:
            try:
                os.remove(local)
            except OSError:
                pass

    async def _mirror_checkpoint(self, conn: Transport, entry: dict) -> None:
        """Copy one bundle into the local CAS, digest-checked; best-effort
        (tpu.py:2239)."""
        digest = entry["digest"]
        local = self._local_bundle_path(digest)
        if os.path.exists(local):
            entry["local"] = local
            return
        remote = entry.get("file") or cas_path(self.remote_cache, digest, ".ckpt")
        tmp = f"{local}.tmp.{os.getpid()}.{os.urandom(4).hex()}"
        try:
            os.makedirs(os.path.dirname(local), exist_ok=True)
            await conn.get(remote, tmp)
            if await asyncio.to_thread(verify_bundle_file, tmp, digest):
                os.replace(tmp, local)
                entry["local"] = local
        except (TransportError, OSError) as err:
            app_log.debug("checkpoint mirror of %s failed: %s", digest[:12], err)
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass

    async def _discover_resume(self, lineage: str, conns: list[Transport] | None,
                               run: str = "") -> dict[str, Any] | None:
        """The lineage's newest complete checkpoint, checked and mirrored:
        the resume plan the next attempt ships (tpu.py:2270-2400).

        Candidates, highest step first: the records the telemetry brought
        (mirrored when the copy won its race with the worker's death) and
        the worker's manifest, read over the failed attempt's channels (a
        preempted worker's channel still answers inside its grace) or, when
        none answers and nothing usable was mirrored, over one fresh dial
        per address.  A manifest of another ``run`` (an earlier dispatch of
        the node) is not read.  Every candidate's bytes are sha256-checked;
        a torn bundle is skipped with ``task.resume_skipped_torn`` and the
        previous complete step wins.
        """
        if self.checkpoint_interval_s <= 0:
            return self._resume_plans.get(lineage)
        usable = [c for c in (conns or []) if c is not None]
        probe_cmd = f"cat {shlex.quote(_ckpt_manifest_remote(self.remote_cache, lineage))}"

        async def probe(conn: Transport) -> list | None:
            result = await asyncio.wait_for(conn.run(f"{probe_cmd} 2>/dev/null"), timeout=10.0)
            if result.exit_status != 0 or not result.stdout.strip():
                return None
            manifest = json.loads(result.stdout)
            history = manifest.get("history")
            if manifest.get("run", "") != run or not isinstance(history, list):
                return None
            return history

        history: list = []
        reader: Transport | None = None
        for conn in usable:
            try:
                found = await probe(conn)
            except (Exception, asyncio.TimeoutError):  # noqa: BLE001 - a dead channel
                continue
            if found:
                history, reader = found, conn
                break
        mirrored = False
        for record in self._ckpt_records.get(lineage, ()):
            if record.get("local") and await asyncio.to_thread(
                    verify_bundle_file, record["local"], record["digest"]):
                mirrored = True
                break
        if reader is None and not mirrored:
            for address in self._worker_addresses():
                try:
                    conn = await asyncio.wait_for(self._client_connect(address), timeout=15.0)
                    found = await probe(conn)
                except (Exception, asyncio.TimeoutError):  # noqa: BLE001
                    continue
                usable.append(conn)
                if found:
                    history, reader = found, conn
                break
        merged: dict[tuple[int, str], dict] = {}
        for entry in list(self._ckpt_records.get(lineage, ())) + [
                h for h in history if isinstance(h, dict)]:
            try:
                step = int(entry.get("step"))
            except (TypeError, ValueError):
                continue
            digest = str(entry.get("digest") or "")
            if digest:
                merged.setdefault((step, digest), dict(entry))
        best = self._resume_plans.get(lineage)
        fetch_order = ([reader] if reader is not None else []) + [
            c for c in usable if c is not reader]
        for (step, digest), entry in sorted(merged.items(), reverse=True):
            if best is not None and step <= int(best.get("step", -1)):
                break  # nothing newer than the plan already checked
            local = entry.get("local") or self._local_bundle_path(digest)
            verified = os.path.exists(local) and await asyncio.to_thread(
                verify_bundle_file, local, digest)
            if not verified:
                remote = entry.get("file") or cas_path(self.remote_cache, digest, ".ckpt")
                for conn in fetch_order:
                    tmp = f"{local}.tmp.{os.getpid()}.{os.urandom(4).hex()}"
                    try:
                        os.makedirs(os.path.dirname(local), exist_ok=True)
                        await asyncio.wait_for(conn.get(remote, tmp), timeout=120.0)
                    except (Exception, asyncio.TimeoutError):  # noqa: BLE001
                        try:
                            os.remove(tmp)
                        except OSError:
                            pass
                        continue  # a channel's problem: try another worker
                    if await asyncio.to_thread(verify_bundle_file, tmp, digest):
                        os.replace(tmp, local)
                        verified = True
                    else:
                        # the bundle itself is torn: no channel fetches it whole
                        os.remove(tmp)
                        obs_events.emit("task.resume_skipped_torn", lineage=lineage,
                                        step=step, digest=digest)
                    break
            if verified:
                plan = {"step": step, "digest": digest, "local": local}
                self._resume_plans[lineage] = plan
                obs_events.emit("task.resume_planned", lineage=lineage, step=step,
                                digest=digest)
                return plan
        return best

    async def _start_backhaul(self, client: AgentClient, staged: StagedTask,
                              worker: str) -> None:
        """Tail a pool-launched task's telemetry file over its pool channel
        (tpu.py:2402); the records arrive under the task's id, its
        operation id.  Best-effort: a watch that fails leaves the worker to
        the snapshot the stall check confirms against."""
        client.on_telemetry = (
            lambda task_id, data: self._handle_backhaul(task_id, worker, data))
        try:
            await client.watch(staged.operation_id, staged.rank(0)["telemetry"])
        except AgentError:
            pass

    async def _stall_verdict(self, operation_id: str, conns: list[Transport],
                             staged: StagedTask,
                             feed: _TelemetryFeed | None) -> list[tuple[str, float]]:
        """The workers of one attempt that are stalled now: ``(worker,
        silence)``.  The monitor's answer is a suspicion only: before it
        becomes a verdict, each suspect's telemetry file is read up to now
        and its heartbeat snapshot confirmed (tpu.py:2435).  A record the
        worker wrote before it fell silent (the ``worker.checkpoint_started``
        of a save that holds its clock) may still be on its way, behind a
        status probe that read the file before it was written or a pool
        channel's side-band that has not forwarded it yet; the verdict must
        not be given without it."""
        if not MONITOR.stalled(operation_id):
            return []
        await self._confirm_heartbeats(operation_id, conns, staged, feed)
        return MONITOR.stalled(operation_id)

    async def _confirm_heartbeats(self, operation_id: str, conns: list[Transport],
                                  staged: StagedTask, feed: _TelemetryFeed | None) -> None:
        """Read each suspect's new telemetry lines and its heartbeat
        snapshot over the control channel (``conns[i]`` is process ``i``'s):
        a healthy worker whose side-band failed refreshes its liveness
        here.  Best-effort."""
        workers = feed.workers if feed is not None else ["localhost"]
        suspects = {worker for worker, _ in MONITOR.stalled(operation_id)}
        for i, worker in enumerate(workers):
            if worker not in suspects or i >= len(conns):
                continue
            conn, files = conns[i], staged.rank(i)
            try:
                if feed is not None:
                    read = await conn.run(feed.clause(files["telemetry"], i) + "true")
                    feed.consume(i, read.stdout)
                result = await conn.run(f"cat {shlex.quote(files['hb'])} 2>/dev/null")
                beat = json.loads(result.stdout) if result.stdout.strip() else None
            except (TransportError, OSError, ValueError):
                continue
            if isinstance(beat, dict):
                self._record_heartbeat(operation_id, worker, beat)

    # ------------------------------------------------------------------ #
    # Orchestration                                                       #
    # ------------------------------------------------------------------ #

    # ------------------------------------------------------------------ #
    # Result memoization (reference: tpu.py:1577-1650, 3763-3800, 4750)  #
    # ------------------------------------------------------------------ #

    @staticmethod
    def _fn_code_digest(fn: Callable) -> str:
        """Digest of the electron's own bytecode, or "" when it has none.

        cloudpickle pickles an importable function by reference (module and
        qualified name), so the payload alone would not change when its
        body is edited; the marshalled code object covers the electron
        itself (not the helpers it imports)."""
        import marshal

        code = getattr(fn, "__code__", None)
        if code is None:
            code = getattr(getattr(fn, "__call__", None), "__code__", None)
        if code is None:
            return ""
        try:
            return bytes_digest(marshal.dumps(code))
        except (TypeError, ValueError):
            return ""

    def _cache_fingerprint(self, task_metadata: dict, **extra: str) -> str:
        """Everything outside the payload that could change what the
        electron computes: the transport, interpreter, conda env, task env,
        pip deps, workers and workdir (tpu.py:1628-1642).  The reference's
        ``workers`` falls back to its ``tpu_name`` before the hostname; the
        port has no TPU name, so it is the hostname, else ``"local"``."""
        return json.dumps({
            "transport": self.transport_kind,
            "python_path": self.python_path,
            "conda_env": self.conda_env,
            "task_env": self.task_env,
            "pip_deps": list(task_metadata.get("pip_deps", ()) or ()),
            "workers": self.workers or [self.hostname or "local"],
            "workdir": self.remote_workdir,
            **extra,
        }, sort_keys=True, default=str)

    def _result_cache_key(self, fn: Callable, args: tuple, kwargs: dict, task_metadata: dict,
                          payload: bytes | None = None) -> str | None:
        """The launch road's memoization key (tpu.py:1600-1650), or None
        when the electron does not pickle (counted, never fatal): the
        digest of the staged ``(fn, args, kwargs)`` payload, the function's
        code digest and the fingerprint's."""
        if payload is None:
            try:
                payload = cloudpickle.dumps((fn, tuple(args), dict(kwargs)))
            except Exception as err:  # noqa: BLE001 - arbitrary payloads
                RESULT_CACHE_TOTAL.labels(result="unpicklable").inc()
                app_log.debug("result cache: electron not picklable (%s)", err)
                return None
        return ResultCache.make_key(
            bytes_digest(payload), self._fn_code_digest(fn),
            bytes_digest(self._cache_fingerprint(task_metadata).encode()))

    def _rpc_result_cache_key(self, fn: Callable, fn_digest: str, args_digest: str,
                              task_metadata: dict) -> str:
        """The RPC road's key (tpu.py:4750-4785): the function and the args
        pickle apart there, and ``"mode": "rpc"`` in the fingerprint keeps
        the two roads from serving each other's entries."""
        return ResultCache.make_key(
            bytes_digest(f"{fn_digest}:{args_digest}".encode()), self._fn_code_digest(fn),
            bytes_digest(self._cache_fingerprint(task_metadata, mode="rpc").encode()))

    async def _cache_lookup(self, root: Span, operation_id: str, key: str | None) -> tuple:
        """``(hit, value)`` of one key; a hit emits ``task.result_cached``
        and marks the attempt as served from the cache."""
        if key is None:
            return False, None
        hit, value = await asyncio.to_thread(self._result_cache.get, key)
        if hit:
            self._cache_hits.add(operation_id)
            obs_events.emit("task.result_cached", operation_id=operation_id,
                            trace_id=root.trace_id)
        return hit, value

    async def _cache_store(self, key: str | None, result: Any, exception) -> None:
        """Store a clean completion; a remote exception is never memoised."""
        if key is not None and exception is None:
            with Span("executor.cache_store"):
                await asyncio.to_thread(self._result_cache.put, key, result)

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

        RPC runs the electron inside a resident runtime, so it is kept to
        what that runtime can serve faithfully: a resident runtime on
        (``use_agent``) and no pip installs (they change the process).
        ``profile_dir`` does not disqualify: the runtime traces the
        invocation itself (``profile_start``/``profile_stop``).  On the
        native agent each invoke forks a fresh ``--rpc-child``; the
        reference sends a native-agent worker's electrons down the launch
        road instead (tpu.py:5002-5010), the port runs them by digest there
        too.  Under a chaos plan or with checkpoints on, ``auto`` takes the
        launch road (the plan's faults target its round trips; the
        checkpointer and its SIGTERM handler are a task process's), while
        an explicit ``rpc`` pin keeps the fast path: the electron is then
        neither preempted by the plan nor checkpointed (tpu.py:3430-3439).
        The worker's lack of a live runtime is found later and falls back
        through :class:`_RpcUnavailable`.
        """
        mode = self._resolve_dispatch_mode(task_metadata)
        if mode == "launch":
            return False
        if self._num_processes() > 1:
            return False  # a gang's bootstrap is the launch harness's
        if not self.use_agent:
            return False
        if (self._chaos is not None or self.checkpoint_interval_s > 0) and mode != "rpc":
            return False
        return not task_metadata.get("pip_deps")

    async def run(
        self,
        function: Callable,
        args: list | tuple,
        kwargs: dict,
        task_metadata: dict,
    ) -> Any:
        """Full electron lifecycle (reference orchestrator: ``ssh.py:466-591``)
        under the retry driver (``tpu.py:3488-3681``), one span per stage
        (module docstring).

        Each attempt stages, dispatches and waits (:meth:`_run_attempt`).  A
        transient failure is planned into another attempt
        (:meth:`_plan_retry`) while the budget allows: the backoff's sleep
        (capped to the wall budget), resume discovery when checkpoints are
        on, a redial when the plan says so, then a fresh operation id
        ``{base}.r{n}``.  A cancel ends the run at once, between attempts
        too; a permanent fault or a spent budget takes the degraded-mode
        policy (:meth:`_on_dispatch_fail`) or raises the attempt's error.
        """
        dispatch_id = task_metadata.get("dispatch_id", "dispatch")
        node_id = task_metadata.get("node_id", 0)
        lineage = f"{dispatch_id}_{node_id}"
        base_id = f"{lineage}_{uuid.uuid4().hex[:8]}"
        workdir = self.remote_workdir
        if self.create_unique_workdir:
            workdir = os.path.join(self.remote_workdir, dispatch_id, f"node_{node_id}")
        policy = self._retry_policy
        deadline = Deadline(policy.wall_budget)

        root = Span("executor.task", {"operation_id": base_id, "lineage": lineage,
                                      "dispatch_id": dispatch_id, "node_id": node_id,
                                      "max_retries": policy.max_retries})
        root.__enter__()
        # Write-ahead intent: an electron in flight when the dispatcher dies
        # shows in the successor's recovery report; the terminal clears it.
        journal_mod.record("task", op=base_id, dispatch_id=dispatch_id, node=node_id,
                           t_dispatch=time.time())
        self._active_ops.add(base_id)
        _ACTIVE_ELECTRONS.inc()
        obs_events.emit("task.state", operation_id=base_id, state="starting",
                        trace_id=root.trace_id)
        outcome = "failed"
        attempt = 0
        try:
            await self._validate_credentials()
            args, kwargs = tuple(args or ()), dict(kwargs or {})
            while True:
                operation_id = base_id if attempt == 0 else f"{base_id}.r{attempt}"
                self._attempt_base[operation_id] = base_id
                self.last_attempts = attempt + 1
                if len(self._op_attempts) > 1024:  # lineages nobody read
                    self._op_attempts.pop(next(iter(self._op_attempts)))
                self._op_attempts[lineage] = attempt + 1
                root.set_attribute("attempt", attempt)
                try:
                    result, exception = await self._run_attempt(
                        root, function, args, kwargs, task_metadata, operation_id, lineage,
                        attempt, deadline, workdir)
                    if operation_id in self._cache_hits:
                        self._cache_hits.discard(operation_id)
                        outcome = "cached"
                        return result
                    break
                except _RetryDispatch as retry:
                    await self._prepare_retry(retry, base_id, lineage, operation_id, attempt,
                                              deadline)
                    attempt += 1
                finally:
                    self._attempt_base.pop(operation_id, None)
            if exception is not None:
                # Re-raise the remote exception locally (ssh.py:581-583).
                outcome = "remote_exception"
                raise exception
            outcome = "completed"
            return result
        except _DispatchFailed as failed:
            result = await self._on_dispatch_fail(function, args, kwargs, str(failed),
                                                  base_id, failed.log_tail)
            outcome = "fallback_local"
            return result
        except asyncio.CancelledError:
            outcome = "cancelled"
            raise
        finally:
            root.set_attribute("attempts", attempt + 1)
            journal_mod.record("task_terminal", op=base_id, outcome=(
                "ok" if outcome in ("completed", "cached") else
                "cancelled" if outcome == "cancelled" else "error"), sync=True)
            self._active_ops.discard(base_id)
            self._cancelled_ops.discard(base_id)
            # The lineage's checkpoint state dies with the run: a later
            # dispatch of the same node is new work, never a resume.
            self._resume_plans.pop(lineage, None)
            for record in self._ckpt_records.pop(lineage, ()):
                self._drop_mirror(record)
            self._ckpt_seen = {k for k in self._ckpt_seen if k[0] != lineage}
            self._epilogue(root, outcome, base_id)

    async def _prepare_retry(self, retry: _RetryDispatch, base_id: str, lineage: str,
                             operation_id: str, attempt: int, deadline: Deadline) -> None:
        """Between two attempts: count the retry, find the resume plan (before
        the redial: a preempted worker's channel still answers inside its
        grace), drop the failed channels when the plan redials, sleep the
        backoff (never past the wall budget), and stop if a cancel came."""
        policy = self._retry_policy
        TASK_RETRIES_TOTAL.labels(reason=retry.reason).inc()
        delay = policy.delay(attempt)
        remaining = deadline.remaining()
        if remaining is not None:
            delay = min(delay, remaining)
        app_log.warning("task %s attempt %d/%d failed (%s: %s); retrying in %.2fs%s",
                        base_id, attempt + 1, policy.max_retries + 1, retry.reason,
                        retry.message, delay, " after a redial" if retry.redial else "")
        obs_events.emit("task.retry", operation_id=operation_id, lineage=lineage,
                        attempt=attempt + 1, max_retries=policy.max_retries,
                        reason=retry.reason, delay_s=round(delay, 3), redial=retry.redial,
                        error=retry.message)
        if self.checkpoint_interval_s > 0:
            try:
                await self._discover_resume(lineage, retry.conns, base_id)
            except Exception as err:  # noqa: BLE001 - a cold restart is always correct
                app_log.warning("resume discovery for %s failed: %s", lineage, err)
        if retry.redial and retry.conns:
            await self._discard_workers(retry.conns)
        if delay:
            await asyncio.sleep(delay)
        if self._is_cancelled(base_id):
            raise asyncio.CancelledError(f"task {base_id} cancelled between retries")

    def _plan_retry(self, attempt: int, deadline: Deadline, reason: str = "",
                    error: BaseException | None = None, message: str = "",
                    conns: list[Transport] | None = None) -> _RetryDispatch | None:
        """A :class:`_RetryDispatch` when the budget allows another attempt,
        else None (tpu.py:3446).  ``error`` is classified first: a
        permanent fault is never retried.  The label is the failure site's
        (``reason``), but an open circuit keeps its own, and so does a
        classified stall or preemption.  The first retry reuses the pooled
        channels; a later one, a channel death and a preemption redial."""
        fault, label = FaultClass.TRANSIENT, reason
        if error is not None:
            fault, classified = classify_error(error)
            if not reason or classified in ("circuit_open", "worker_stalled",
                                            "worker_preempted"):
                label = classified
        if not self._retry_policy.should_retry(attempt, fault, deadline):
            return None
        label = label or "transient"
        redial = attempt >= 1 or label in ("channel", "worker_preempted", "rpc_channel")
        return _RetryDispatch(label, message or str(error or "transient failure"), redial,
                              conns=conns)

    def _retry_or_raise(self, failed: _DispatchFailed, attempt: int,
                        deadline: Deadline) -> None:
        """Turn an attempt's dispatch failure into a retry when the budget
        allows; otherwise let it through to the degraded-mode policy."""
        retry = self._plan_retry(attempt, deadline, reason=failed.reason, error=failed.error,
                                 message=str(failed), conns=failed.conns)
        if retry is not None:
            raise retry from failed
        raise failed

    async def _run_attempt(self, root: Span, function: Callable, args: tuple, kwargs: dict,
                           task_metadata: dict, operation_id: str, lineage: str, attempt: int,
                           deadline: Deadline, workdir: str):
        """One attempt: ``(result, exception)``, or :class:`_RetryDispatch`
        for a transient failure the budget covers."""
        self._active_ops.add(operation_id)
        try:
            if self._rpc_preselect(task_metadata):
                self.last_dispatch_mode = self._op_modes[operation_id] = "rpc"
                journal_mod.record("task", op=self._attempt_base[operation_id],
                                   operation_id=operation_id, attempt=attempt + 1, mode="rpc")
                try:
                    return await self._run_rpc(root, operation_id, function, args, kwargs,
                                               task_metadata)
                except _RpcUnavailable as unavailable:
                    obs_events.emit("task.rpc_fallback", operation_id=operation_id,
                                    reason=str(unavailable))
                    app_log.info("task %s: RPC dispatch unavailable (%s); using the "
                                 "launch road", operation_id, unavailable)
                except _DispatchFailed as failed:
                    self._retry_or_raise(failed, attempt, deadline)
                except (AgentError, RuntimeError) as err:
                    # a resident worker that died (rpc_channel) or an
                    # invocation that timed out: the runtime is torn down
                    retry = self._plan_retry(attempt, deadline, error=err, message=str(err))
                    if retry is not None:
                        raise retry from err
                    raise
            self.last_dispatch_mode = self._op_modes[operation_id] = "launch"
            cache_key, payload = None, None
            if self._result_cache is not None:
                # ahead of connect: a hit touches no transport, and a miss
                # stages the same pickle
                with Span("executor.cache_lookup"):
                    try:
                        payload = await asyncio.to_thread(
                            cloudpickle.dumps, (function, args, kwargs))
                    except Exception as err:  # noqa: BLE001 - user payloads
                        RESULT_CACHE_TOTAL.labels(result="unpicklable").inc()
                        app_log.debug("result cache: electron not picklable (%s)", err)
                    else:
                        cache_key = self._result_cache_key(function, args, kwargs,
                                                           task_metadata, payload=payload)
                    hit, cached = await self._cache_lookup(root, operation_id, cache_key)
                if hit:
                    return cached, None
            journal_mod.record("task", op=self._attempt_base[operation_id],
                               operation_id=operation_id, attempt=attempt + 1, mode="launch")
            resume = self._resume_plans.get(lineage)
            trace = context_of(root, attempt=attempt)
            with Span("executor.stage"):
                staged = await asyncio.to_thread(
                    self._write_function_files, operation_id, function, args, kwargs,
                    workdir, task_metadata.get("pip_deps", ()), lineage, resume, trace,
                    self._attempt_base[operation_id], payload)
            if staged.resume_artifact is not None:
                # this attempt restores instead of recomputing
                CHECKPOINT_RESTORES_TOTAL.inc()
                _CHECKPOINT_RESUMED_STEP.set(float(resume.get("step", 0)))
                obs_events.emit("task.resumed", operation_id=operation_id, lineage=lineage,
                                attempt=attempt, step=resume.get("step"),
                                digest=resume.get("digest"), trace_id=root.trace_id)
            try:
                result, exception = await self._run_staged(root, staged)
                await self._cache_store(cache_key, result, exception)
                return result, exception
            except _DispatchFailed as failed:
                self._retry_or_raise(failed, attempt, deadline)
            except (TransportError, OSError) as err:
                # A channel that died mid-task (or mid-upload, already
                # discarded): the same transient either way.  A channel
                # dying after its worker announced the preemption notice IS
                # the preemption: its grace ran out.
                conns = list(self._failed_conns.pop(operation_id, ()))
                await self._discard_workers(conns)
                preempted = operation_id in self._preempt_notices
                retry = self._plan_retry(
                    attempt, deadline, reason="worker_preempted" if preempted else "channel",
                    error=WorkerPreemptedError(str(err)) if preempted else err,
                    message=f"control-plane channel died mid-task: {err}", conns=conns)
                if retry is not None:
                    raise retry from err
                raise
        finally:
            self._failed_conns.pop(operation_id, None)
            if operation_id != self._attempt_base.get(operation_id):
                # attempt 0 runs under the base id, whose marks outlive it
                self._active_ops.discard(operation_id)
                self._cancelled_ops.discard(operation_id)
            self._op_modes.pop(operation_id, None)
            self._preempt_notices.discard(operation_id)
            MONITOR.forget(operation_id)
            for key in [k for k in self._backhaul_seen if k[0] == operation_id]:
                del self._backhaul_seen[key]
            client = self._op_agents.pop(operation_id, None)
            if client is not None:
                # whatever the channel kept for this task, on every exit path
                client.forget(operation_id)

    async def _on_dispatch_fail(self, fn: Callable, args: tuple, kwargs: dict, message: str,
                                operation_id: str, log_tail: str = "") -> Any:
        """The degraded-mode policy (reference: ``_on_ssh_fail``,
        ssh.py:181-208; tpu.py:1407-1440): emit ``task.dispatch_failed``,
        then raise ``RuntimeError(message)``, or, with
        ``run_local_on_dispatch_fail``, run the electron here on a worker
        thread (the event loop keeps serving every other dispatch)."""
        obs_events.emit("task.dispatch_failed", operation_id=operation_id, message=message,
                        fallback_local=self.run_local_on_dispatch_fail,
                        **({"log_tail": log_tail} if log_tail else {}))
        if self.run_local_on_dispatch_fail:
            app_log.warning("GPU dispatch failed (%s); running the electron locally on the "
                            "dispatcher", message)
            return await asyncio.to_thread(fn, *args, **kwargs)
        app_log.error(message)
        raise RuntimeError(message)

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

    async def _lease(self, conns: list[Transport]) -> GangLease:
        """``lease_gang`` with its failure as a dispatch failure (retry
        label ``connect``): the channels that were dialed are discarded (a
        redial must not reuse what pre-flight proved broken)."""
        try:
            return await self.lease_gang(dialed=conns)
        except (TransportError, OSError, ValueError) as err:
            if conns:
                await self._discard_workers(conns)
            raise _DispatchFailed(f"could not reach GPU workers: {err}", reason="connect",
                                  error=err, conns=conns) from err

    async def _run_staged(self, root: Span, staged: StagedTask):
        """Connect, upload, launch, wait for, fetch and clean up one staged
        task (every process of a gang, process ``i`` behind worker ``i``'s
        channel): ``(result, exception)``.

        A failure to dispatch raises :class:`_DispatchFailed` with its retry
        label: ``connect``, ``launch``, ``timeout`` and ``worker_stalled``
        (both escalated first), ``worker_preempted`` (a worker that died
        after its preemption notice) or ``worker_dead``.  A channel that
        dies raises its own error, the attempt's channels kept in
        ``_failed_conns`` for the retry's redial.
        """
        operation_id = staged.operation_id
        conns: list[Transport] = []
        staged_on: list[Transport] = []  # the channels whose workers got files
        clients: list[AgentClient | None] = []
        #: each gang process's exit, for the straggler check after cleanup
        exit_at: dict[int, float] = {}
        addresses: list[str] = []
        finished = False  # every process finished: a gang whose stragglers count
        try:
            lease = await self._lease(conns)
            addresses = lease.addresses
            keys = [self._pool_key(a) for a in lease.addresses]
            self._op_conns[operation_id] = conns
            staged_on.extend(conns)
            with Span("executor.upload"):
                try:
                    await asyncio.gather(*(self._upload_task(conn, staged, i, key)
                                           for i, (conn, key) in enumerate(zip(conns, keys))))
                except TransportError:
                    await self._discard_workers(conns)
                    raise
            for conn in conns:
                client = self._agents.get(conn.address) if self.use_agent else None
                clients.append(client if client is not None and client.alive else None)
            if self._is_cancelled(operation_id):
                raise asyncio.CancelledError(f"task {operation_id} cancelled")
            with Span("executor.submit"):
                pids: list = []
                self._pids[operation_id] = pids
                for process, conn in enumerate(conns):
                    pid = None
                    if clients[process] is not None:
                        try:
                            pid = await self._submit_via_agent(clients[process], conn, staged,
                                                               process)
                            if process == 0:
                                self._op_agents[operation_id] = clients[0]
                        except AgentError as err:
                            if classify_error(err)[0] is FaultClass.PERMANENT:
                                raise
                            # rejected before it started: launch it detached instead
                            app_log.warning("task %s: pool run refused (%s); launching with "
                                            "nohup", operation_id, err)
                            obs_events.emit("task.agent_fallback", operation_id=operation_id,
                                            reason=str(err))
                            clients[process] = None
                    if pid is None:
                        try:
                            pid = await self.submit_task(conn, staged, process)
                        except TransportError as err:
                            if self._is_cancelled(operation_id):
                                raise asyncio.CancelledError(
                                    f"task {operation_id} cancelled during launch") from err
                            await self._kill(conns, staged)
                            raise _DispatchFailed(f"task launch failed: {err}", reason="launch",
                                                  error=err, conns=conns) from err
                    pids.append(pid)
                    # a preemption fault's SIGTERM goes to this process group
                    notify = getattr(conn, "chaos_notify_pid", None)
                    if notify is not None:
                        notify(pid)
            feed = None
            if self.heartbeat_interval > 0 or self.checkpoint_interval_s > 0:
                feed = _TelemetryFeed(
                    lambda worker, record: self._handle_backhaul(operation_id, worker, record),
                    lease.addresses)
                if self.heartbeat_interval > 0:
                    MONITOR.watch(operation_id, self._stall_after(), workers=lease.addresses,
                                  interval=self.heartbeat_interval)
            try:
                with Span("executor.poll"):
                    if clients[0] is not None and staged.processes == 1:
                        if feed is not None:
                            await self._start_backhaul(clients[0], staged, lease.addresses[0])
                        status, blamed = await self._await_agent_exit(
                            clients[0], conns[0], staged, pids[0], feed), 0
                    else:
                        status, blamed = await self._poll_task(conns, staged, pids, feed,
                                                               exit_at)
            except asyncio.CancelledError:
                await self._kill(conns, staged)
                raise
            if status is not TaskStatus.READY:
                await self._failed_attempt(conns, staged, status, blamed, feed)
            finished = True
            with Span("executor.fetch"):
                result, exception, times = await self.query_result(conns[0], staged, keys[0])
            self._record_execute(root, times)
            if times and "rendezvous" in times:
                # the gang's process group opening: dispatch overhead the
                # poll span waited through, reported as its own stage
                stages = root.stage_durations
                stages["rendezvous"] = times["rendezvous"]
                stages["poll"] = max(0.0, stages.get("poll", 0.0) - times["rendezvous"])
            return result, exception
        except (TransportError, OSError):
            self._failed_conns[operation_id] = list(conns)
            await self._kill(conns, staged)
            raise
        finally:
            self._pids.pop(operation_id, None)
            self._op_conns.pop(operation_id, None)
            for process, client in enumerate(clients):
                if client is not None:
                    client.forget(self._task_id(staged, process))
            if self.do_cleanup:
                with Span("executor.cleanup"):
                    await self._cleanup_quietly(staged_on, staged)
            if finished:
                # after the cleanup: a straggler's redial closes its channel
                self._note_gang_stragglers(operation_id, addresses, exit_at)

    async def _failed_attempt(self, conns: list[Transport], staged: StagedTask,
                              status: TaskStatus, blamed: int,
                              feed: _TelemetryFeed | None) -> None:
        """An attempt that ended without a result: tear it down and raise
        its :class:`_DispatchFailed` (tpu.py:3995-4130).  A timeout or a
        stall is escalated (TERM, grace, KILL); a gang's other processes,
        which may wait in the rendezvous, are killed.  A death after the
        worker's preemption notice (read from the telemetry, once more
        here) is a preemption, not a crash."""
        operation_id = staged.operation_id
        if self._is_cancelled(operation_id):
            raise asyncio.CancelledError(f"task {operation_id} cancelled")
        if status is TaskStatus.STALLED:
            STALLS_TOTAL.labels(worker=feed.workers[blamed]).inc()
        if status in (TaskStatus.TIMEOUT, TaskStatus.STALLED):
            await self._escalate_timeout(
                operation_id, conns, "timeout" if status is TaskStatus.TIMEOUT else "stall")
        elif staged.processes > 1:
            await self._kill(conns, staged)
        if feed is not None and any(feed.offsets):
            try:  # the poll road's last read: the lines the worker wrote as it died
                await self.get_status(conns[blamed], staged, None, blamed, feed)
            except (TransportError, OSError):
                pass
        try:
            log_tail = await self._remote_log_tail(conns[blamed], staged, blamed)
        except (TransportError, OSError) as err:
            log_tail = f"(log unreachable: {err})"
        where = conns[blamed].address + (
            f" process {blamed} (worker {self.workers[blamed]!r})" if staged.processes > 1
            else "")
        last_beats = MONITOR.last(operation_id)
        obs_events.emit("task.failed", operation_id=operation_id, status=status.value,
                        worker=where, log_tail=log_tail,
                        **({"last_heartbeats": last_beats} if last_beats else {}))
        if status is TaskStatus.STALLED:
            silence = last_beats.get(feed.workers[blamed], {}).get("age_s")
            message = (f"remote task {operation_id} stalled on {where}: alive but no heartbeat "
                       f"for {silence if silence is not None else '?'}s (threshold "
                       f"{self._stall_after():.1f}s); processes killed; log tail:\n{log_tail}")
            error: BaseException | None = WorkerStalledError(message)
            reason = "worker_stalled"
        elif status is TaskStatus.TIMEOUT:
            message = (f"remote task {operation_id} timed out after {self.task_timeout:.1f}s "
                       f"on {where}; processes killed; log tail:\n{log_tail}")
            error, reason = None, "timeout"
        else:
            message = (f"remote task {operation_id} failed on {where} ({status.value}); "
                       f"log tail:\n{log_tail}")
            error, reason = None, "worker_dead"
            if operation_id in self._preempt_notices:
                error, reason = WorkerPreemptedError(message), "worker_preempted"
        raise _DispatchFailed(message, log_tail, reason=reason, error=error, conns=conns)

    async def _cleanup_quietly(self, conns: list[Transport], staged: StagedTask) -> None:
        """``cleanup`` that never masks the task's own outcome: a channel
        that died meanwhile leaves the worker's files (logged)."""
        try:
            await self.cleanup(conns, staged)
        except (TransportError, OSError) as err:
            app_log.warning("task %s: cleanup failed (%s); staged files may remain on the "
                            "worker", staged.operation_id, err)

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
                if self._is_cancelled(operation_id):
                    raise asyncio.CancelledError(f"task {operation_id} cancelled")
        finally:
            waiter.cancel()
            try:
                await waiter
            except (asyncio.CancelledError, AgentError):
                pass

    async def _run_rpc(self, root: Span, operation_id: str, function: Callable,
                       args: tuple, kwargs: dict, task_metadata: dict):
        """One electron by digest in the warm pool server: ``(result,
        exception)``, under the launch road's stage spans.

        Per electron (warm): one ``invoke`` line with the args inline and
        one pushed ``result``.  Per connection: the function's CAS ship and
        its ``register_fn``.  A dead resident worker or dropped channel
        fails the electron as transient (``rpc_channel``); a digest
        mismatch is permanent.  A timeout or cancel tears the resident
        runtime down: an invocation inside a shared process cannot be
        killed any other way.  No live runtime raises
        :class:`_RpcUnavailable`.  With ``cache_results`` the RPC road's own
        key is looked up ahead of the connect, and a clean result stored.
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
            cache_key = None
            if self._result_cache is not None:
                with Span("executor.cache_lookup"):
                    cache_key = self._rpc_result_cache_key(function, fn_digest, args_digest,
                                                           task_metadata)
                    hit, cached = await self._cache_lookup(root, operation_id, cache_key)
                if hit:
                    return cached, None
            client = await self._resident_client(conns)
            if client is None:
                raise _RpcUnavailable("no live resident runtime on "
                                      f"{self._worker_addresses()[0]}")
            conn, address = conns[0], self._worker_addresses()[0]
            key = self._pool_key(address)
            codec = self._codec_for(key, conn)
            remote_fn = cas_path(self.remote_cache, fn_digest, ".pkl")
            spec: dict[str, Any] = {"operation_id": operation_id}
            if self.task_env:
                spec["env"] = dict(self.task_env)
            self._op_agents[operation_id] = client
            invoke_kwargs: dict[str, Any] = {}
            try:
                with Span("executor.upload"):
                    await self._cas.ensure_probed(key, conn, [(fn_digest, remote_fn)])
                    await self._cas.ensure(key, conn, fn_digest, local_fn, remote_fn,
                                           codec=codec, python_path=self.python_path)
                    runner = (None if client.mode == "pool"
                              else await self._runner(conn, key, "--rpc-child"))
                    await self._fn_registry.ensure(key, client, fn_digest, remote_fn,
                                                   runner=runner)
                    if inline:
                        invoke_kwargs["args_bytes"] = args_payload
                    else:
                        remote_args = cas_path(self.remote_cache, args_digest, ".pkl")
                        await self._cas.ensure(key, conn, args_digest, local_args, remote_args,
                                               codec=codec, python_path=self.python_path)
                        invoke_kwargs.update(args_path=remote_args, args_digest=args_digest)
                        obs_events.emit("task.rpc_args_staged", operation_id=operation_id,
                                        bytes=len(args_payload))
                if self._is_cancelled(operation_id):
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
            # Traced inside the runtime that runs it: started after the
            # invoke's ack (a refused start, ``busy`` or no profiler, is an
            # event, never a failed electron); the failure roads below tear
            # the runtime down, and the trace with it.
            profiling = bool(self.profile_dir) and await self._start_resident_profile(
                client, operation_id)
            with Span("executor.poll"):
                verdict, payload = await self._await_rpc_result(client, operation_id)
            if verdict != "result":
                await self._discard_workers(conns)
                if verdict == "timeout":
                    raise tag_fault(RuntimeError(
                        f"RPC task {operation_id} timed out after {self.task_timeout:.1f}s on "
                        f"{address}; resident runtime torn down"), "timeout", transient=True)
                raise tag_fault(AgentError(f"resident worker died mid-invoke on {address}: "
                                           f"{payload}"), "rpc_channel", transient=True)
            if profiling:
                with Span("executor.profile"):
                    await self._finish_resident_profile(client, conn, operation_id,
                                                        operation_id)
            with Span("executor.fetch"):
                if payload.get("data_path"):
                    result, exception, times = await self._fetch_staged_rpc_result(
                        conn, payload, operation_id)
                else:
                    result, exception, times = await asyncio.to_thread(
                        self._decode_rpc_result, payload)
            self._record_execute(root, times)
            await self._cache_store(cache_key, result, exception)
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

    # ------------------------------------------------------------------ #
    # Resident profiling (reference: tpu.py:4384-4720)                   #
    # ------------------------------------------------------------------ #

    async def _start_resident_profile(self, client: AgentClient, profile_id: str,
                                      sid: str = "") -> bool:
        """Start a ``torch.profiler`` trace inside a resident runtime.

        Best-effort: profiling observes the dispatch, so a refused start
        (``busy``: one trace per process; ``unavailable``) is an event and
        False, never a failed electron."""
        try:
            await client.profile_start(profile_id, f"{self.remote_cache}/profile_{profile_id}",
                                       sid=sid)
        except AgentError as err:
            if isinstance(err, AgentTimeoutError):
                # the trace may have started and only the ack been lost:
                # free the runtime's one profiler slot
                self._detach_profile_abort(client, profile_id, sid)
            obs_events.emit("task.profile_error", operation_id=profile_id, stage="start",
                            error=str(err))
            app_log.warning("resident profile start for %s failed: %s", profile_id, err)
            return False
        return True

    def _detach_profile_abort(self, client: AgentClient, profile_id: str, sid: str) -> None:
        """A compensating stop, detached from the caller, for a capture that
        lost track of a possibly active trace: the artifact is dropped and
        the runtime's profiler slot freed (a stop of a trace that never
        started answers ``not_running``, harmlessly)."""
        async def abort() -> None:
            try:
                await client.profile_stop(profile_id, sid=sid, timeout=30.0, discard=True)
            except (AgentError, OSError):
                pass

        task = asyncio.ensure_future(abort())
        self._cleanup_tasks.add(task)
        task.add_done_callback(self._cleanup_tasks.discard)

    def _profile_stop_failed(self, operation_id: str, profile_id: str, err: Exception) -> None:
        obs_events.emit("task.profile_error", operation_id=operation_id, stage="stop",
                        error=str(err))
        app_log.warning("resident profile stop for %s failed: %s", profile_id, err)
        return None

    async def _finish_resident_profile(self, client: AgentClient, conn: Transport,
                                       profile_id: str, operation_id: str,
                                       sid: str = "") -> dict[str, Any] | None:
        """Stop the trace, fetch the packed artifact and check its digest.

        A stop that outlives its waiter is still packing on the worker: its
        answer is awaited again, not the command resent (a second stop would
        be refused and the artifact left unclaimed).  A failed stop
        (``stop_failed``) keeps the trace running, so it is sent once more.
        """
        artifact_dir = cas_path(self.remote_cache, "").rstrip("/")
        try:
            event = await client.profile_stop(profile_id, artifact_dir=artifact_dir, sid=sid)
        except AgentTimeoutError:
            try:
                event = await client.profile_wait_stopped(profile_id)
            except AgentError as err:
                return self._profile_stop_failed(operation_id, profile_id, err)
        except AgentError:
            await asyncio.sleep(0.5)
            try:
                event = await client.profile_stop(profile_id, artifact_dir=artifact_dir,
                                                  sid=sid)
            except AgentError as err:
                return self._profile_stop_failed(operation_id, profile_id, err)
        return await self._retrieve_profile_artifact(
            conn, str(event.get("path") or ""), str(event.get("digest") or ""), operation_id)

    async def _retrieve_profile_artifact(self, conn: Transport, remote_path: str, digest: str,
                                         operation_id: str) -> dict[str, Any] | None:
        """Fetch one announced trace artifact into ``{cache_dir}/profiles/``,
        check its sha256 against the announced digest, record it, and remove
        the worker's copy."""
        if not remote_path or not digest:
            return None
        profiles_dir = os.path.join(self.cache_dir, "profiles")
        local = os.path.join(profiles_dir, f"{operation_id}_{digest[:12]}.profile.tgz")
        tmp = f"{local}.tmp.{os.getpid()}.{os.urandom(4).hex()}"
        try:
            os.makedirs(profiles_dir, exist_ok=True)
            await conn.get(remote_path, tmp)
            if file_digest(tmp) != digest:
                raise RuntimeError(f"profile artifact for {operation_id} does not match its "
                                   "announced digest (torn artifact)")
            size = os.path.getsize(tmp)
            os.replace(tmp, local)
        except (TransportError, OSError, RuntimeError) as err:
            obs_events.emit("task.profile_error", operation_id=operation_id, stage="fetch",
                            error=str(err))
            app_log.warning("profile artifact fetch for %s failed: %s", operation_id, err)
            return None
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass
            try:
                await conn.remove([remote_path])
            except (TransportError, OSError):
                pass
        self._profile_artifacts[operation_id] = local
        obs_events.emit("task.profile_captured", operation_id=operation_id, path=local,
                        digest=digest, bytes=size, worker=conn.address)
        return {"path": local, "digest": digest, "bytes": size}

    def _profile_targets(self, sid: str) -> tuple[str, list[tuple[str, AgentClient]]]:
        """A capture's ``(remote sid, candidate runtimes)``: pool servers
        first (they run RPC invocations and pool-mode sessions in-process),
        then native agents.  A sid naming one of this executor's sessions
        becomes its current generation's remote id and pins the candidates
        to the runtime hosting it."""
        handle = self._serve_handles.get(sid)
        pinned = None
        if handle is not None:
            sid = getattr(handle, "_sid_g", sid)
            pinned = getattr(handle, "_client", None)
        targets = [(address, client) for address, client in list(self._agents.items())
                   if client is not None and client.alive]
        targets.sort(key=lambda t: t[1].mode != "pool")
        if pinned is not None:
            hosted = [t for t in targets if t[1] is pinned]
            if hosted:
                targets = hosted
        return sid, targets

    async def capture_profile(self, duration_s: float = 2.0,
                              sid: str = "") -> dict[str, Any] | None:
        """Trace a live resident runtime for ``duration_s`` and bring the
        trace back: ``{worker, duration_s, path, digest, bytes}``, the
        artifact digest-checked under ``{cache_dir}/profiles/``.

        Pool servers first, then native agents, which forward the capture
        into a ``--serve-child`` (a native agent with no session has nothing
        to trace).  ``sid`` pins a serving session (a handle's sid or a
        remote session id).  None when no resident runtime could be traced.
        """
        sid, targets = self._profile_targets(sid)
        profile_id = f"prof-{os.urandom(4).hex()}"
        for address, client in targets:
            if client.mode != "pool" and not sid and not self._serve_handles:
                continue
            conn = next((c for c in self._transports.values() if c.address == address), None)
            if conn is None:
                continue
            if not await self._start_resident_profile(client, profile_id, sid=sid):
                continue
            info = await self._finish_capture(client, conn, profile_id, duration_s, sid=sid)
            if info:
                return {"worker": address, "duration_s": float(duration_s), **info}
        return None

    async def _finish_capture(self, client: AgentClient, conn: Transport, profile_id: str,
                              duration_s: float, sid: str = "") -> dict[str, Any] | None:
        """The on-demand capture's tail: record for ``duration_s``, stop,
        fetch.  A cancel mid-capture detaches a compensating stop, so the
        runtime's profiler slot is freed."""
        try:
            await asyncio.sleep(max(0.0, float(duration_s)))
            return await self._finish_resident_profile(client, conn, profile_id, profile_id,
                                                       sid=sid)
        except asyncio.CancelledError:
            self._detach_profile_abort(client, profile_id, sid)
            raise
        finally:
            self._profile_artifacts.pop(profile_id, None)

    def _epilogue(self, root: Span, outcome: str, operation_id: str) -> None:
        """Terminal accounting on every exit path (``tpu.py:4211-4243``)."""
        root.set_attribute("outcome", outcome)
        if outcome not in ("completed", "cached"):
            root.record_error(outcome)
        root.end()
        overhead = root.overhead(exclude=_NOT_OVERHEAD)
        wall_overhead = max(0.0, root.total() - sum(
            root.stage_durations.get(stage, 0.0) for stage in _NOT_OVERHEAD))
        self.last_timings = root.summary()
        self.last_timings["overhead"] = overhead
        self.last_timings["wall_overhead"] = wall_overhead
        artifact = self._profile_artifacts.pop(operation_id, None)
        if artifact is not None:
            self.last_timings["profile_trace"] = artifact  # type: ignore[assignment]
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
