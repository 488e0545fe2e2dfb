"""Worker-side bootstrap: ``python harness.py <task_spec.json>``,
``python harness.py --serve``, ``--zygote``, ``--rpc-child``,
``--serve-child`` or ``--attach <socket>``.

Counterpart of ``covalent_tpu_plugin/harness.py``.  The executor ships this
one file to the worker (it imports nothing of the package).

* **Launch mode** (``harness.py <spec>``), run detached: it applies the
  task's environment, installs its pip dependencies, unpickles ``(fn, args,
  kwargs)``, runs the electron, moves tensors in the result to host memory,
  and writes ``(result, exception, times)`` back as a pickle, which the
  dispatcher fetches; ``times`` holds the electron's own ``start`` and
  ``end`` (unix seconds), which the dispatcher's ``execute`` stage reads.
  Optionally it traces the electron with ``torch.profiler``.  A gang
  electron's spec carries a ``distributed`` block (coordinator address,
  process count, this process's id): after the pip install and the
  function file's digest check it joins the gang's
  ``torch.distributed`` process group, runs the electron, and leaves the
  group; process 0 writes the result, the others a ``.done.<id>`` marker
  (``error`` and the exception, with the traceback in the log, where the
  electron raised there).  The fault-tolerance keys: ``heartbeat_s`` beats
  into ``telemetry_file`` (and a ``<pid_file>.hb`` snapshot) from the
  start; ``checkpoint`` snapshots the electron's registered train state
  on an interval and on SIGTERM (the preemption notice) into sha256-named
  bundles and a per-lineage manifest; ``resume`` hands a retry attempt
  the bundle it restores from; ``trace`` stamps the dispatcher's trace
  ids on every worker event.  An unknown key is refused: the electron
  does not run, and the error comes back as its exception.
* **Resident mode** (``harness.py --serve``): the pool server.  It speaks a
  JSON-lines protocol on stdin/stdout, switching to interleaved binary
  frames once the client negotiates them, hosts resident serving sessions
  and RPC invocations in its own process, and runs launch-mode specs
  (``run``) as forks of its zygote (see :func:`serve`).
* **Zygote** (``harness.py --zygote``): the pool server's fork helper, a
  single-threaded process that has imported the preloads but never
  initialised CUDA (see :func:`zygote`).
* **Attach relay** (``harness.py --attach <socket>``): pumps its stdio to
  and from an orphaned pool server's unix socket, so a successor
  dispatcher adopts the orphan over the road it starts servers on (see
  :func:`attach_relay`).
* **The native agent's runners** (``harness.py --rpc-child`` and
  ``harness.py --serve-child``): the C++ agent (``native/agent.cc``) forks
  and execs a fresh interpreter per RPC invocation, the invoke command on
  its stdin (:func:`rpc_child`), and one per serving session, the session's
  commands forwarded to its stdin for its life (:func:`serve_child`).  The
  agent itself never imports Python, so no CUDA context crosses its forks.

Resident profiling: ``profile_start``/``profile_stop`` trace the pool
server (or a ``--serve-child``) with ``torch.profiler`` while it serves,
and pack the trace into one content-addressed ``<sha256>.profile.tgz``
(see :func:`_profile_start`).
"""

from __future__ import annotations

import json
import os
import struct
import sys
import threading
import time
import zlib

#: spec keys this harness understands
_SPEC_KEYS = {
    "operation_id", "function_file", "function_digest", "result_file", "workdir",
    "pid_file", "env", "profile_dir", "pip_deps", "distributed",
    "heartbeat_s", "telemetry_file", "checkpoint", "resume", "trace",
}

#: Seconds the gang's process group waits on a collective (the rendezvous
#: included) before it fails.
DIST_TIMEOUT_S = 1800.0


def install_pip_deps(pip_deps: list) -> None:
    """Install an electron's pip dependencies; raise RuntimeError on failure.

    Shared by this worker harness and the in-process ``LocalExecutor``
    (reference ``ct.DepsPip``, ``svm_workflow.py:6,19``).  The command can be
    replaced through ``COVALENT_TPU_PIP_CMD`` (tests stub pip with it).
    """
    import shlex
    import subprocess

    pip_cmd = shlex.split(
        os.environ.get("COVALENT_TPU_PIP_CMD", "")
    ) or [sys.executable, "-m", "pip", "install"]
    proc = subprocess.run(
        pip_cmd + list(pip_deps), capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"pip dependency install failed "
            f"({' '.join(pip_deps)}): {proc.stderr.strip()}"
        )


def _fallback_result(result_file: str, error: BaseException) -> None:
    """Best-effort ``(None, error)`` write with stdlib pickle, mirroring the
    reference's cloudpickle-ImportError path (``exec.py:16-24``)."""
    import pickle

    tmp = result_file + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump((None, error), f)
    os.replace(tmp, result_file)


def _to_host(tree):
    """Detached CPU copies of every tensor in ``tree`` (containers rebuilt),
    so the result unpickles on a machine without the card."""
    # A task that never imported torch cannot return tensors: skip the import.
    if "torch" not in sys.modules:
        return tree
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return type(tree)((key, _to_host(value)) for key, value in tree.items())
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_to_host(value) for value in tree)
    return tree


def _apply_spec_env(spec: dict) -> None:
    """Apply the task's env contract to THIS process: os.environ entries,
    a sys.path mirror for PYTHONPATH, and the ``CUDA_VISIBLE_DEVICES`` pin.

    The pin only takes effect before CUDA initialises in this process;
    a pin that arrives later and changes it is refused rather than silently
    ignored (the pool server starts with the executor's ``task_env`` in its
    environment, so its sessions' pins are no change).
    """
    env = spec.get("env") or {}
    pin = env.get("CUDA_VISIBLE_DEVICES")
    if pin is not None and str(pin) != os.environ.get("CUDA_VISIBLE_DEVICES") \
            and "torch" in sys.modules:
        import torch

        if torch.cuda.is_initialized():
            raise RuntimeError(
                "CUDA_VISIBLE_DEVICES cannot change after CUDA initialised"
            )
    for key, value in env.items():
        os.environ[key] = str(value)
    if "PYTHONPATH" in env:
        # The interpreter already started; os.environ alone no longer affects
        # import resolution.  Mirror the entries into sys.path.
        for entry in reversed(str(env["PYTHONPATH"]).split(os.pathsep)):
            if entry and entry not in sys.path:
                sys.path.insert(0, entry)


def _start_profiler(profile_dir: str):
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str) -> None:
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


# ---------------------------------------------------------------------------
# Resident profiling: ``torch.profiler`` inside the resident runtime
# (reference: harness.py:1641-1820, on ``jax.profiler``).
#
#   -> {"cmd":"profile_start","id":"<pid>","dir":"/path/trace_dir"[,"sid"]}
#   <- {"event":"profile_started","id":"<pid>","pid":123}
#   <- {"event":"profile_error","id":"<pid>","code":"busy"|"unavailable"|
#       "bad_request"|"not_running"|"unknown_session"|"stop_failed"|
#       "package_failed","message":"..."}                    (on failure)
#   -> {"cmd":"profile_stop","id":"<pid>","artifact_dir":"/cache/cas"
#       [,"discard":true]}
#   <- {"event":"profile_stopped","id":"<pid>",
#       "path":"/cache/cas/<sha256>.profile.tgz","digest":"<sha256>","bytes":N}
#
# One trace at a time per process (Kineto allows one profiler), so a second
# start is refused ``busy``, and so is a launch-mode ``profile_dir`` in the
# same process while a resident trace runs.  The profiler is started and
# stopped on a thread of its own: ``torch.profiler`` must stop on the thread
# that started it, and the command loop must not wait on the stop, the
# Chrome-trace export or the packing (tens of MB for a decode trace).  Its
# CUDA activity (CUPTI) is process-wide, so the trace holds the device
# kernels every thread launched; its CPU operators are those of the
# profiler's own thread and of threads torch starts from it.  The stop
# packs the trace directory into ONE tar.gz named by its own sha256 under
# ``artifact_dir`` and announces path and digest; the dispatcher fetches
# the file and checks the digest before it trusts the bytes.
# ---------------------------------------------------------------------------

_PROFILE_LOCK = threading.Lock()
#: ``{"id", "dir", "requests"}`` while a trace runs (``stopping`` once a stop
#: was taken); empty otherwise.
_PROFILE_ACTIVE: dict = {}


def _claim_profiler(profile_id: str, trace_dir: str) -> bool:
    """Take this process's one profiler slot for a launch-mode trace;
    False (with a note on stderr) while a resident trace holds it."""
    with _PROFILE_LOCK:
        if _PROFILE_ACTIVE:
            print(f"profile_dir: trace {_PROFILE_ACTIVE.get('id')!r} is active in this "
                  "process (busy); the electron runs unprofiled", file=sys.stderr)
            return False
        _PROFILE_ACTIVE.update({"id": profile_id, "dir": trace_dir})
        return True


def _profile_start(command: dict, sessions: dict | None = None) -> None:
    import queue as queue_mod

    profile_id = str(command.get("id") or "")
    trace_dir = command.get("dir")
    if not profile_id or not trace_dir:
        _emit({"event": "profile_error", "id": profile_id, "code": "bad_request",
               "message": "profile_start requires id and dir"})
        return
    sid = str(command.get("sid") or "")
    if sid and sid not in (sessions or {}):
        # A capture pinned to a session must trace the process that hosts
        # it; the dispatcher moves on to the next runtime.
        _emit({"event": "profile_error", "id": profile_id, "code": "unknown_session",
               "message": f"no live serving session {sid!r} here"})
        return
    with _PROFILE_LOCK:
        if _PROFILE_ACTIVE:
            _emit({"event": "profile_error", "id": profile_id, "code": "busy",
                   "message": f"trace {_PROFILE_ACTIVE.get('id')!r} already active "
                              "(one profiler per process)"})
            return
        requests: "queue_mod.Queue" = queue_mod.Queue()
        _PROFILE_ACTIVE.update({"id": profile_id, "dir": str(trace_dir), "requests": requests})
    threading.Thread(target=_profile_thread, args=(profile_id, str(trace_dir), requests),
                     name="covalent-gpu-profiler", daemon=True).start()


def _profile_thread(profile_id: str, trace_dir: str, requests) -> None:
    """Start the profiler, answer, then serve stop requests until one
    stops it (a failed stop leaves the trace running, so it can be
    retried)."""
    try:
        os.makedirs(trace_dir, exist_ok=True)
        profiler = _start_profiler(trace_dir)
    except Exception as err:  # noqa: BLE001 - any profiler failure
        with _PROFILE_LOCK:
            _PROFILE_ACTIVE.clear()
        _emit({"event": "profile_error", "id": profile_id, "code": "unavailable",
               "message": repr(err)})
        return
    _emit({"event": "profile_started", "id": profile_id, "pid": os.getpid()})
    while True:
        artifact_dir, discard = requests.get()
        try:
            _stop_profiler(profiler, trace_dir)
        except Exception as err:  # noqa: BLE001
            with _PROFILE_LOCK:
                _PROFILE_ACTIVE.pop("stopping", None)
            _emit({"event": "profile_error", "id": profile_id, "code": "stop_failed",
                   "message": repr(err)})
            continue
        break
    with _PROFILE_LOCK:
        _PROFILE_ACTIVE.clear()
    if discard:
        # a compensating stop for an abandoned capture: nobody fetches it
        import shutil

        shutil.rmtree(trace_dir, ignore_errors=True)
        _emit({"event": "profile_stopped", "id": profile_id, "discarded": True})
        return
    try:
        path, digest, size = _package_trace(trace_dir, artifact_dir)
    except Exception as err:  # noqa: BLE001 - tar/disk failures
        _emit({"event": "profile_error", "id": profile_id, "code": "package_failed",
               "message": repr(err)})
        return
    _emit({"event": "profile_stopped", "id": profile_id, "path": path, "digest": digest,
           "bytes": size})


def _package_trace(trace_dir: str, artifact_dir: str) -> tuple:
    """``(path, digest, bytes)`` of the trace directory packed as one
    ``<sha256>.profile.tgz`` under ``artifact_dir`` (the digest is of the
    bytes shipped); the raw directory is removed."""
    import hashlib
    import shutil
    import tarfile

    os.makedirs(artifact_dir, exist_ok=True)
    tmp = os.path.join(artifact_dir, f".profile.tmp.{os.getpid()}.{time.time_ns()}.tgz")
    with tarfile.open(tmp, "w:gz") as tar:
        tar.add(trace_dir, arcname=".")
    sha = hashlib.sha256()
    with open(tmp, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha.update(chunk)
    digest = sha.hexdigest()
    final = os.path.join(artifact_dir, f"{digest}.profile.tgz")
    os.replace(tmp, final)
    shutil.rmtree(trace_dir, ignore_errors=True)
    return final, digest, os.path.getsize(final)


def _profile_stop(command: dict) -> None:
    """Hand the stop to the profiler's thread; the command loop never waits
    on the stop, the export or the packing."""
    profile_id = str(command.get("id") or "")
    with _PROFILE_LOCK:
        active = dict(_PROFILE_ACTIVE)
        if not active or "requests" not in active or (
                profile_id and active.get("id") != profile_id):
            _emit({"event": "profile_error", "id": profile_id, "code": "not_running",
                   "message": f"no active trace for {profile_id!r}"})
            return
        if active.get("stopping"):
            _emit({"event": "profile_error", "id": profile_id, "code": "not_running",
                   "message": f"trace {profile_id!r} is already stopping"})
            return
        _PROFILE_ACTIVE["stopping"] = True
    artifact_dir = command.get("artifact_dir") or os.path.dirname(
        str(active["dir"]).rstrip("/"))
    active["requests"].put((str(artifact_dir), bool(command.get("discard"))))


def _rank_env(distributed: dict) -> None:
    """``torch.distributed``'s own variables for a gang process (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), set
    before anything of the electron runs, its pip install included."""
    host, _, port = str(distributed["coordinator_address"]).rpartition(":")
    os.environ.update({
        "RANK": str(int(distributed["process_id"])),
        "WORLD_SIZE": str(int(distributed["num_processes"])),
        "LOCAL_RANK": str(int(distributed["process_id"])),
        "MASTER_ADDR": host,
        "MASTER_PORT": port,
    })


def _join_gang(distributed: dict) -> str:
    """Open the gang's process group; returns its backend.

    NCCL when this host has a card for every process, else gloo: gloo on
    CPU tensors, and on cards shared by several processes (NCCL refuses two
    ranks on one device; ``parallel/probe.py`` lists what gloo carries on
    tensors on the card).  With cards, process ``i`` takes card ``i % count``.
    """
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    world = int(distributed["num_processes"])
    rank = int(distributed["process_id"])
    backend = "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
        if torch.cuda.device_count() >= world:
            backend = "nccl"
    dist.init_process_group(
        backend, init_method=f"tcp://{distributed['coordinator_address']}",
        world_size=world, rank=rank, timeout=timedelta(seconds=DIST_TIMEOUT_S),
    )
    return backend


def _digest_ok(path: str, expected: str) -> bool:
    import hashlib

    sha = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha.update(chunk)
    return sha.hexdigest() == expected


# ---------------------------------------------------------------------------
# Launch mode's liveness and cooperative checkpointing (reference:
# harness.py:54-520).
#
# Worker events (``worker.task_started``, ``worker.checkpoint_saved``,
# ``worker.preempt_notice``, ...) and heartbeats are JSON lines appended to
# the spec's ``telemetry_file``; the dispatcher reads the file's new lines
# on each status probe, or the pool server tails it back over its channel.
# Every record draws its ``seq`` from one counter, so the dispatcher's
# dedup works whichever road a record arrives by.  Writes never raise: a
# full disk must not fail the electron it observes (the first failure
# leaves one line on stderr).
#
# A training electron registers a snapshot hook
# (``covalent_tpu_plugin_torch.utils.checkpoint.register_snapshot``, found
# through ``sys.modules``); the checkpointer calls it on its interval and
# the SIGTERM handler once more, and each snapshot becomes a bundle named
# by the sha256 of its bytes plus an atomically replaced manifest.  A kill
# mid-save never tears the newest entry: bundles publish by rename, the
# manifest names only whole files, and the dispatcher checks every
# candidate's digest before it resumes from it.
# ---------------------------------------------------------------------------

_worker_event_failures = 0

#: Where the electron's snapshot hook lives, if it registered one.
_CHECKPOINT_MODULE = "covalent_tpu_plugin_torch.utils.checkpoint"

#: Seconds the SIGTERM handler waits for an interval save still inside the
#: electron's hook before it gives up its own save.
PREEMPT_TAKE_WAIT_S = 2.0


def _append_event_line(event: dict, paths: list) -> None:
    """Append one event as a JSON line to every path; swallow and count
    failures."""
    global _worker_event_failures
    try:
        line = json.dumps(event, default=repr) + "\n"
    except (TypeError, ValueError):
        return
    for path in paths:
        try:
            with open(path, "a", encoding="utf-8") as f:
                f.write(line)
        except OSError as err:
            _worker_event_failures += 1
            if _worker_event_failures == 1:
                print(f"worker events unwritable ({path}: {err}); further failures "
                      "swallowed", file=sys.stderr)


def _emit_worker_event(spec: dict, type: str, **fields) -> None:
    """One worker event into the spec's ``telemetry_file`` (nothing
    without one)."""
    path = spec.get("telemetry_file")
    if path:
        _append_event_line(_build_worker_event(spec, type, **fields), [path])


def _heartbeat_payload(metrics_file: str) -> dict:
    """One beat's body: the process's vitals, the card's memory when the
    electron already initialised CUDA (``_device_mem`` never is the first
    CUDA call: a zygote fork must stay free of it), and the progress the
    electron published as a JSON object in
    ``$COVALENT_TPU_WORKER_METRICS_PATH`` (its ``step`` apart)."""
    payload: dict = {}
    try:
        import resource

        usage = resource.getrusage(resource.RUSAGE_SELF)
        payload["rss_bytes"] = int(usage.ru_maxrss) * (1 if sys.platform == "darwin" else 1024)
        payload["cpu_s"] = round(usage.ru_utime + usage.ru_stime, 3)
    except Exception:  # noqa: BLE001 - vitals are best-effort
        pass
    if metrics_file:
        try:
            with open(metrics_file, encoding="utf-8") as f:
                user = json.load(f)
            if isinstance(user, dict):
                step = user.pop("step", None)
                if isinstance(step, (int, float)):
                    payload["step"] = step
                if user:
                    payload["metrics"] = user
        except (OSError, ValueError):
            pass
    try:
        payload.update(_device_mem())
    except Exception:  # noqa: BLE001 - a torch without CUDA
        pass
    return payload


def _start_heartbeat(spec: dict):
    """Start the heartbeat thread; returns its stop event (None when
    ``heartbeat_s`` is unset).

    Each beat is ONE record with one seq, written twice: a line of the
    telemetry file and the atomically replaced ``<pid_file>.hb`` snapshot
    the status probe can read, so the dispatcher's dedup holds across the
    roads.  The first beat fires at once, so the stall detector has a
    baseline even for a short electron.
    """
    try:
        interval = float(spec.get("heartbeat_s") or 0)
    except (TypeError, ValueError):
        interval = 0.0
    if interval <= 0:
        return None
    pid_file = spec.get("pid_file")
    hb_file = os.path.abspath(f"{pid_file}.hb") if pid_file else None
    metrics_file = os.path.abspath(f"{pid_file}.metrics") if pid_file else ""
    if metrics_file:
        os.environ["COVALENT_TPU_WORKER_METRICS_PATH"] = metrics_file
    telemetry = [spec["telemetry_file"]] if spec.get("telemetry_file") else []
    stop = threading.Event()

    def beat_loop() -> None:
        hb_seq = 0
        while True:
            hb_seq += 1
            event = _build_worker_event(spec, "worker.heartbeat", hb_seq=hb_seq,
                                        interval_s=interval, **_heartbeat_payload(metrics_file))
            if telemetry:
                _append_event_line(event, telemetry)
            if hb_file:
                try:
                    tmp = f"{hb_file}.tmp.{os.getpid()}"
                    with open(tmp, "w", encoding="utf-8") as f:
                        f.write(json.dumps(event, default=repr))
                    os.replace(tmp, hb_file)
                except (OSError, TypeError, ValueError):
                    pass  # liveness reporting must never fail the task
            if stop.wait(interval):
                return

    threading.Thread(target=beat_loop, name="covalent-gpu-heartbeat", daemon=True).start()
    return stop


def _sanitize_lineage(lineage: str) -> str:
    import re

    return re.sub(r"[^A-Za-z0-9._-]", "_", str(lineage))


def _ckpt_manifest_path(directory: str, lineage: str) -> str:
    return os.path.join(directory, f"ckpt_{_sanitize_lineage(lineage)}.json")


def _write_checkpoint_bundle(directory: str, lineage: str, step: int, tree,
                             keep_n: int, run: str = "") -> tuple:
    """Publish one bundle atomically; returns ``(path, digest, bytes)``.

    A bundle is the cloudpickle of ``{"v", "lineage", "step", "tree",
    "meta"}``, its tensors on the host, named by the sha256 of its bytes.
    The manifest keeps the newest ``keep_n`` complete steps of the run
    ``run``, highest first (an earlier run of the same lineage, a node
    dispatched again, is new work: its entries are dropped, never resumed
    from); a bundle that falls off it is unlinked.  The manifest's
    read-modify-write runs under an flock: a preempted attempt still
    inside its grace window and the attempt that replaces it may both
    save on one filesystem, and an unlocked race would drop one's newest
    entry and leak its bundle.
    """
    import hashlib

    import cloudpickle

    payload = cloudpickle.dumps({
        "v": 1, "lineage": lineage, "step": int(step), "tree": _to_host(tree),
        "meta": {"saved_at": time.time(), "pid": os.getpid()},
    })
    digest = hashlib.sha256(payload).hexdigest()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{digest}.ckpt")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)

    manifest_path = _ckpt_manifest_path(directory, lineage)
    lock_fd = None
    try:
        import fcntl

        lock_fd = os.open(f"{manifest_path}.lock", os.O_CREAT | os.O_RDWR, 0o644)
        fcntl.flock(lock_fd, fcntl.LOCK_EX)
    except (ImportError, OSError):
        if lock_fd is not None:
            os.close(lock_fd)
        lock_fd = None
    try:
        return _publish_manifest(manifest_path, lineage, path, digest, len(payload), step,
                                 keep_n, run)
    finally:
        if lock_fd is not None:
            os.close(lock_fd)  # closing releases the flock


def _publish_manifest(manifest_path: str, lineage: str, path: str, digest: str,
                      nbytes: int, step: int, keep_n: int, run: str = "") -> tuple:
    """The manifest's read-modify-write and the bundles' GC (under the
    caller's flock)."""
    history, dropped = [], []
    try:
        with open(manifest_path, encoding="utf-8") as f:
            manifest = json.load(f)
        if isinstance(manifest, dict) and isinstance(manifest.get("history"), list):
            entries = [h for h in manifest["history"] if isinstance(h, dict)]
            if manifest.get("run", "") != run:
                dropped, entries = entries, []
            history = [h for h in entries if h.get("step") != int(step)]
    except (OSError, ValueError):
        pass  # missing or torn manifest: rebuilt from this save
    history.insert(0, {"step": int(step), "digest": digest, "file": path, "bytes": nbytes})
    # Highest step first, not newest first: two attempts' saves may
    # interleave, and resume discovery must see the furthest state first.
    history.sort(key=lambda h: h["step"] if isinstance(h.get("step"), int) else -1,
                 reverse=True)
    keep_n = max(1, int(keep_n or 1))
    dropped, history = dropped + history[keep_n:], history[:keep_n]
    tmp = f"{manifest_path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"lineage": lineage, "run": run, "updated": time.time(),
                   "history": history}, f)
    os.replace(tmp, manifest_path)
    live = {h["digest"] for h in history}
    for old in dropped:
        if old.get("digest") in live:
            continue
        try:
            os.unlink(old.get("file") or "")
        except OSError:
            pass
    return path, digest, nbytes


def _start_checkpointer(spec: dict):
    """The interval checkpointer of one task: ``(stop, save_now)``, or
    ``(None, None)`` without a ``checkpoint`` block (or on a process other
    than 0: the gang's train state is replicated, one writer suffices).

    ``save_now(trigger)`` takes one snapshot synchronously, for the
    interval thread and the SIGTERM handler alike; a step high-water mark
    skips a snapshot that is not newer than the last one saved.  The
    handler (``trigger="preempt"``, on the main thread) waits for a save in
    flight only while that save writes its bundle (I/O that finishes on its
    own), and at most ``PREEMPT_TAKE_WAIT_S`` while it is still inside the
    hook: a hook may wait on the step the handler interrupted.
    """
    cfg = spec.get("checkpoint") or {}
    try:
        interval = float(cfg.get("interval_s") or 0)
    except (TypeError, ValueError):
        interval = 0.0
    process_id = int((spec.get("distributed") or {}).get("process_id") or 0)
    if interval <= 0 or not cfg.get("dir") or process_id != 0:
        return None, None
    directory = os.path.abspath(str(cfg["dir"]))
    lineage = str(cfg.get("lineage") or spec.get("operation_id") or "task")
    run = str(cfg.get("run") or "")
    keep_n = int(cfg.get("keep_n") or 3)
    state = {"last_step": None, "failures": 0, "writing": False}
    lock = threading.Lock()

    def acquire(trigger: str) -> bool:
        if trigger != "preempt":
            return lock.acquire()
        if lock.acquire(blocking=False):
            return True
        if state["writing"]:
            return lock.acquire()
        return lock.acquire(timeout=PREEMPT_TAKE_WAIT_S)

    def save_now(trigger: str):
        take = getattr(sys.modules.get(_CHECKPOINT_MODULE), "take_snapshot", None)
        if take is None:
            return None  # the electron registered no hook
        if not acquire(trigger):
            return None
        try:
            if trigger == "interval" and stop.is_set():
                return None  # the task ended
            try:
                snap = take()
            except Exception as err:  # noqa: BLE001 - the user's hook
                state["failures"] += 1
                if state["failures"] == 1:
                    print(f"snapshot hook failed: {err!r}", file=sys.stderr)
                _emit_worker_event(spec, "worker.checkpoint_error", lineage=lineage,
                                   trigger=trigger, error=repr(err))
                return None
            if snap is None:
                return None
            tree, step = snap
            step = int(step)
            last = state["last_step"]
            if step < 0 or (last is not None and step <= last):
                return None  # nothing new since the last save
            # The write pickles the whole tree with the GIL held, which can
            # keep the beat thread silent for seconds: the dispatcher holds
            # its stall clock from this record to the save's end.
            _emit_worker_event(spec, "worker.checkpoint_started", lineage=lineage, step=step,
                               trigger=trigger)
            started = time.monotonic()
            state["writing"] = True
            try:
                path, digest, nbytes = _write_checkpoint_bundle(directory, lineage, step, tree,
                                                                keep_n, run)
            finally:
                state["writing"] = False
            state["last_step"] = step
        finally:
            lock.release()
        _emit_worker_event(spec, "worker.checkpoint_saved", lineage=lineage, step=step,
                           digest=digest, path=path, bytes=nbytes, trigger=trigger,
                           save_s=round(time.monotonic() - started, 6))
        return step

    class Stop(threading.Event):
        def set(self) -> None:
            """Stop the interval, and let a save in flight finish: the task's
            end must not leave a bundle the manifest does not name."""
            super().set()
            with lock:
                pass

    stop = Stop()

    def loop() -> None:
        while not stop.wait(interval):
            try:
                save_now("interval")
            except Exception as err:  # noqa: BLE001 - never kill the task
                state["failures"] += 1
                _emit_worker_event(spec, "worker.checkpoint_error", lineage=lineage,
                                   trigger="interval", error=repr(err))
                if state["failures"] == 1:
                    print(f"checkpoint save failed: {err!r}", file=sys.stderr)

    threading.Thread(target=loop, name="covalent-gpu-checkpointer", daemon=True).start()
    return stop, save_now


def _install_preempt_handler(spec: dict, save_now) -> None:
    """SIGTERM is the spot preemption notice: emit
    ``worker.preempt_notice`` (the dispatcher relabels the coming death),
    take one last snapshot, then die of the signal, so the exit status is
    the one the dispatcher's probes expect.  Main thread only (the signal
    API's rule)."""
    import signal

    if threading.current_thread() is not threading.main_thread():
        return

    def on_term(signum, frame):
        _emit_worker_event(spec, "worker.preempt_notice", signal="SIGTERM")
        try:
            if save_now is not None:
                save_now("preempt")
        except Exception:  # noqa: BLE001 - dying anyway; the save is best-effort
            pass
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)

    try:
        signal.signal(signal.SIGTERM, on_term)
    except (ValueError, OSError):
        pass


_RESUME_ENV = ("COVALENT_TPU_RESUME_CHECKPOINT", "COVALENT_TPU_RESUME_STEP",
               "COVALENT_TPU_RESUME_DIGEST")
#: Where ``resume_state`` announces its restore (the telemetry file): the
#: unpickle holds the GIL, so the dispatcher holds the stall clock.
_RESUME_EVENTS_ENV = "COVALENT_TPU_RESUME_EVENTS"


def _apply_resume(spec: dict, process_id: int) -> None:
    """The resume contract: a retry attempt's ``resume`` block becomes the
    three environment variables ``utils.checkpoint.resume_state`` reads
    (absolute paths: the electron reads them after the chdir into its
    workdir), and the telemetry file it announces the restore in; without
    one, stale values are cleared."""
    resume = spec.get("resume") or {}
    if not resume.get("file"):
        for name in (*_RESUME_ENV, _RESUME_EVENTS_ENV):
            os.environ.pop(name, None)
        return
    os.environ.update(zip(_RESUME_ENV, (os.path.abspath(str(resume["file"])),
                                        str(resume.get("step", "")),
                                        str(resume.get("digest", "")))))
    if spec.get("telemetry_file"):
        os.environ[_RESUME_EVENTS_ENV] = os.path.abspath(str(spec["telemetry_file"]))
    else:
        os.environ.pop(_RESUME_EVENTS_ENV, None)
    _emit_worker_event(spec, "worker.resume_available", process_id=process_id,
                       step=resume.get("step"), digest=resume.get("digest"))


def run_task(spec: dict) -> int:
    """Execute one staged task described by ``spec``.  Returns the exit code.

    A gang process (``distributed`` in the spec) fails before the
    rendezvous on anything that can fail alone (its pip install, a torn
    function file): it exits 1, and the dispatcher, which watches every
    process, fails the task and blames it instead of leaving process 0 in
    the rendezvous.  Only process 0 writes a result file.
    """
    result_file = spec["result_file"]

    pid_file = spec.get("pid_file")
    if pid_file:
        # First thing, before any failure mode: the dispatcher's liveness
        # probe reads it.  Atomic write: never observed empty.
        tmp_pid = f"{pid_file}.tmp.{os.getpid()}"
        with open(tmp_pid, "w") as f:
            f.write(str(os.getpid()))
        os.replace(tmp_pid, pid_file)

    unsupported = sorted(set(spec) - _SPEC_KEYS)
    if unsupported:
        _fallback_result(result_file, NotImplementedError(
            f"task spec keys {unsupported} are not supported by this harness"
        ))
        return 1

    distributed = spec.get("distributed")
    process_id = int(distributed["process_id"]) if distributed else 0
    # Absolute before the electron chdirs: the heartbeat, the checkpointer
    # and the SIGTERM handler write here while it runs.
    if spec.get("telemetry_file"):
        spec["telemetry_file"] = os.path.abspath(spec["telemetry_file"])
    _emit_worker_event(spec, "worker.task_started", process_id=process_id)
    # Liveness from before anything can block (the pip install, the
    # rendezvous, the electron): a worker stuck anywhere after this keeps
    # beating, and one that falls silent is wedged.
    heartbeat_stop = _start_heartbeat(spec)
    checkpoint_stop, checkpoint_now = _start_checkpointer(spec)

    def fail(error: BaseException) -> int:
        for stop in (heartbeat_stop, checkpoint_stop):
            if stop is not None:
                stop.set()
        _emit_worker_event(spec, "worker.task_finished", process_id=process_id, ok=False,
                           error=repr(error))
        if process_id == 0:
            _fallback_result(result_file, error)
        else:
            print(f"process {process_id}: {error!r}", file=sys.stderr)
        return 1

    try:
        _apply_spec_env(spec)
        _apply_resume(spec, process_id)
        if distributed:
            _rank_env(distributed)
        # Before the function pickle is loaded: unpickling may import the
        # dependency (reference ct.DepsPip, svm_workflow.py:6,19).
        if spec.get("pip_deps"):
            install_pip_deps(spec["pip_deps"])
        import cloudpickle as pickle
    except (ImportError, RuntimeError) as setup_error:
        return fail(setup_error)

    digest = spec.get("function_digest")
    if digest and not _digest_ok(spec["function_file"], digest):
        return fail(RuntimeError(
            f"staged function {spec['function_file']} does not match its content "
            "digest (torn or stale artifact)"))

    times: dict = {}
    if distributed:
        joined = time.time()
        try:
            times["backend"] = _join_gang(distributed)
        except Exception as join_error:  # noqa: BLE001 - transported to dispatcher
            return fail(RuntimeError(f"process {process_id} could not join the gang: "
                                     f"{join_error!r}"))
        times["rendezvous"] = time.time() - joined

    with open(spec["function_file"], "rb") as f:
        fn, args, kwargs = pickle.load(f)

    # After every import that could install its own SIGTERM handling (the
    # process group's bootstrap above, the function's unpickling), so the
    # preemption notice reaches this one.
    if spec.get("checkpoint"):
        _install_preempt_handler(spec, checkpoint_now)

    profile_dir = spec.get("profile_dir")
    profiler = None
    if profile_dir and _claim_profiler(str(spec.get("operation_id") or "launch"), profile_dir):
        profiler = _start_profiler(profile_dir)

    workdir = spec.get("workdir")
    current_dir = os.getcwd()
    result, exception = None, None
    started = time.time()
    marker = f"{result_file}.done.{process_id}"
    try:
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            os.chdir(workdir)
        result = _to_host(fn(*args, **kwargs))
    except Exception as task_error:  # noqa: BLE001 - transported to dispatcher
        exception = task_error
        if process_id:
            # Into the log and the marker before the process group closes:
            # process 0 may fail on the closed group, and the dispatcher
            # must find this process's error first and blame it.
            import traceback

            traceback.print_exc()
            _write_marker(marker, f"error {task_error!r}\n")
    finally:
        ended = time.time()
        os.chdir(current_dir)
        if profiler is not None:
            try:
                _stop_profiler(profiler, profile_dir)
            finally:
                with _PROFILE_LOCK:
                    _PROFILE_ACTIVE.clear()
        if distributed:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()

    if process_id == 0:
        tmp = result_file + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump((result, exception, {"start": started, "end": ended, **times}), f)
        os.replace(tmp, result_file)
    elif exception is None:
        # the others' marker: the dispatcher's watcher reads it as "done"
        _write_marker(marker, "done\n")
    for stop in (heartbeat_stop, checkpoint_stop):
        if stop is not None:
            stop.set()
    _emit_worker_event(spec, "worker.task_finished", process_id=process_id,
                       ok=exception is None,
                       **({"error": repr(exception)} if exception is not None else {}))
    return 0


def _write_marker(path: str, text: str) -> None:
    """A gang process's done marker, written whole (the watcher reads its
    first word: ``done``, or ``error`` and the electron's exception)."""
    with open(f"{path}.tmp", "w") as f:
        f.write(text)
    os.replace(f"{path}.tmp", path)


# ---------------------------------------------------------------------------
# Resident runtime: ``python harness.py --serve``
#
# One JSON object per line each way.  Commands on stdin:
#
#   {"cmd":"ping"}                                  -> {"event":"pong"}
#   {"cmd":"run","id":task,"spec":path[,"log":path]} -> {"event":"started",
#                                                       "id","pid"}, later
#                                                      {"event":"exit","id",
#                                                       "code","signal"}
#   {"cmd":"kill","id":task[,"sig":15]}             -> {"event":"killed","id"}
#   {"cmd":"watch","id":task,"path":jsonl}          -> {"event":"watching","id"},
#                                                      then one telemetry event
#                                                      per line of the file
#   {"cmd":"unwatch","id":task}                     -> {"event":"unwatched","id"}
#   {"cmd":"task_inventory"}                        -> {"event":"task_inventory",
#                                                       "pid","tasks":[{id,pid}]}
#   {"cmd":"register_fn","digest":sha256,"path":cas} -> {"event":"registered",
#                                                       "digest"}
#                                                    | {"event":"register_error",
#                                                       "digest","code","message"}
#   {"cmd":"invoke","id":op,"digest":sha256,"spec":{...},"args":b64
#    | "args_path"+"args_digest"[,"path"][,"result_path","result_max_inline"]}
#                                                   -> {"event":"started","id",
#                                                       "pid","rpc":true},
#                                                      telemetry, then
#                                                      {"event":"result","id",
#                                                       "ok","data":b64
#                                                       | "data_path"+
#                                                       "data_digest"+"bytes"}
#   {"cmd":"serve_open","id":sid,"digest":sha256,"path":"<cas>/<sha256>.pkl",
#    "options":{"queue_max","default_deadline_s","stats_interval_s"},
#    "spec":{"operation_id","env"}}                 -> {"event":"serve_opened",
#                                                       "id","slots","pid"}
#                                                    | {"event":"serve_error",...}
#   {"cmd":"serve_request","id":sid,"rid":rid,"prompt":[...],"params":{...},
#    "deadline_s":s[,"kv_digest":sha256,"kv"|"kv_path"|"kv_bytes"]}
#                                                   -> telemetry records below
#   {"cmd":"serve_prefill","id":sid,"rid":rid,"prompt":[...],"params":{...}}
#                                                   -> {"event":"serve_kv","id",
#                                                       "rid","digest","bytes",
#                                                       "data":b64 | frame body
#                                                       "data_bytes"}
#                                                    | {"event":"serve_kv",...,
#                                                       "code","message"}
#   {"cmd":"serve_cancel","id":sid,"rid":rid}        (no answer: the stream's
#                                                     terminal record)
#   {"cmd":"serve_close","id":sid}                  -> {"event":"serve_closed",
#                                                       "id","served"} after the
#                                                       drain
#   {"cmd":"serve_resume","id":sid,"rid":rid,"from":n}
#                                                   -> the history from n as one
#                                                      serve.token record
#                                                      (resumed: true), then
#                                                      {"event":"serve_resumed",
#                                                       "id","rid","state","from",
#                                                       "sent"}
#   {"cmd":"serve_inventory"}                       -> {"event":"serve_inventory",
#                                                       "pid","epoch","sessions"}
#   {"cmd":"epoch","epoch":n}                       -> {"event":"epoch_ok","epoch"}
#                                                    | {"event":"error",
#                                                       "code":"stale_epoch"}
#   {"cmd":"multi_invoke","digest","ops":[...],"args_lens":[...]} (a frame
#    whose body is the ops' args pickles end to end)
#                                                   -> {"event":"multi_started",
#                                                       "ids","pid","rpc":true},
#                                                      then each op as invoke
#   {"cmd":"frames","version":1,"codec":""|"zlib"}  -> {"event":"frames",
#                                                       "version":1,"codec"}
#   {"cmd":"shutdown"}                              -> {"event":"bye"}
#
# A session streams {"event":"telemetry","id":sid,"data":record}, one line a
# record; each record carries ts/pid/a per-process seq/type: ``serve.token``
# (rid, cumulative ``idx`` of the chunk's first token, tokens, done[, error]),
# ``serve.reject`` (rid, code, message) and ``serve.stats``.  The ready
# banner advertises ``"frames": 1``; once the client answers ``frames``,
# results, KV bundles and coalesced telemetry (``telemetry_batch``: a JSON
# array of records as the body) ride binary frames (see the frame block
# below), and the client may send any command as a frame.
#
# Verbs of later items are refused with an ``error`` event naming the item.
#
# Crash recovery.  A dispatcher that journals declares its epoch (``epoch``)
# on every channel; the server keeps the highest it has seen and refuses
# the mutating commands of a channel that declared a lower one
# (``stale_epoch``).  Each session keeps every running stream's tokens, and
# a ring of finished ones, so ``serve_resume`` can re-emit a stream from
# the offset a restarted dispatcher holds.  When stdin closes and
# ``COVALENT_TPU_ORPHAN_TTL_S`` > 0, a server with live sessions goes into
# orphan mode: it writes its protocol to /dev/null, keeps decoding, and
# waits on a unix socket named in ``pool_orphan.json`` beside this file for
# one ``{"cmd":"adopt","epoch":n}`` at an epoch no lower than its own; the
# socket then becomes its channel and a fresh banner (``reattach``) starts
# the protocol over.  At the TTL it drains and exits.  SIGTERM with live
# sessions is the preemption notice: ``serve.preempt`` on every session's
# side-band, and the server keeps serving.
#
# Sessions and RPC invocations run in this process on their own threads,
# and share its one CUDA context.  This process is never forked: once it
# has touched the card (a session or an RPC electron initialises CUDA), a
# forked child could not use CUDA.  ``run`` forks from the zygote instead,
# a helper this server spawns once, which imports the same preloads and
# never initialises CUDA.
# ---------------------------------------------------------------------------

#: Per-process record sequence: the dispatcher drops a record whose seq is
#: not above the last one it saw for the same id.
_worker_event_seq = 0
_worker_event_lock = threading.Lock()


def _build_worker_event(spec: dict, type: str, **fields) -> dict:
    """One worker record: the ts/pid/seq envelope, the dispatcher's trace
    context from the spec's ``trace`` block (``trace_id``, the attempt's
    span as ``parent_id``, ``attempt``), then ``fields``."""
    global _worker_event_seq
    with _worker_event_lock:
        _worker_event_seq += 1
        seq = _worker_event_seq
    event = {
        "ts": round(time.time(), 6),
        "pid": os.getpid(),
        "seq": seq,
        "type": type,
        "operation_id": spec.get("operation_id"),
    }
    trace = spec.get("trace") or {}
    if trace.get("trace_id"):
        event["trace_id"] = trace["trace_id"]
        event["parent_id"] = trace.get("span_id")
        if trace.get("attempt") is not None:
            event["attempt"] = trace["attempt"]
    event.update(fields)
    return event


#: The protocol channel: a binary file over a copy of the original stdout.
#: :func:`serve` points fd 1 at stderr, so a ``print`` in a factory or a
#: compiler's output cannot land inside a protocol line or frame.
_PROTO = getattr(sys.stdout, "buffer", sys.stdout)
#: Serializes protocol writes: the command loop, every session thread and
#: every RPC thread share the one channel, and a JSON line and a frame must
#: never interleave mid-message.
_EMIT_LOCK = threading.Lock()


def _write_proto(*parts: bytes) -> None:
    """Write one whole protocol message under the emit lock."""
    with _EMIT_LOCK:
        try:
            for part in parts:
                _PROTO.write(part)
            _PROTO.flush()
        except (OSError, ValueError):
            pass  # dead channel: the sessions' threads must not die of it


def _emit(obj: dict) -> None:
    _write_proto((json.dumps(obj) + "\n").encode())


# ---------------------------------------------------------------------------
# Binary frames (negotiated; JSON lines stay the fallback).
#
# Mirror of ``transport/frames.py``, stdlib-only because this file runs
# standalone on workers; ``tests/test_torch_frames.py`` keeps this copy,
# the package's and the reference's byte-compatible:
#
#   magic(2)=C5 F7  version(1)  verb(1)  flags(1)  hlen(4 BE)  blen(4 BE)
#   header: UTF-8 JSON object (the command/event, minus its bulky field)
#   body:   raw bytes, re-attached under the field named by header["_body"]
#
# The server advertises ``"frames": 1`` in its ready banner; the client
# answers ``{"cmd":"frames",...}`` and the ack flips this side's output to
# frames where a body rides (results, KV bundles, telemetry batches).
# ``COVALENT_TPU_AGENT_FRAMES=0`` in the worker's environment answers
# ``version: 0`` and keeps the channel on JSON lines.
# ---------------------------------------------------------------------------

_FRAME_MAGIC = b"\xc5\xf7"
_FRAME_VERSION = 1
_FRAME_HEADER = struct.Struct(">2sBBBII")
_FRAME_MAX_HEADER = 16 * 1024 * 1024
_FRAME_MAX_BODY = 512 * 1024 * 1024
_FRAME_MIN_COMPRESS = 512
_FRAME_FLAG_ZLIB = 0x01

_VERB_CMD = 0
_VERB_INVOKE = 1
_VERB_RESULT = 2
_VERB_TELEMETRY = 3
_VERB_MULTI_INVOKE = 4
_VERB_SERVE = 5

#: Outbound frame state, flipped by the negotiated ``frames`` command.
_FRAMES = {"out": False, "codec": ""}


def _frames_enabled() -> bool:
    """Kill switch: ``COVALENT_TPU_AGENT_FRAMES=0``/``off`` keeps JSON lines."""
    return os.environ.get("COVALENT_TPU_AGENT_FRAMES", "").strip().lower() not in (
        "0", "off", "false", "no")


def _emit_frame(verb: int, header: dict, body: bytes = b"") -> None:
    """One binary frame on the protocol channel (whole, under the emit
    lock).  The body is zlib-compressed when the negotiated codec allows
    and the payload is big enough to win."""
    flags = 0
    if body and _FRAMES["codec"] == "zlib" and len(body) >= _FRAME_MIN_COMPRESS:
        packed = zlib.compress(body, 6)
        if len(packed) < len(body) * 0.9:
            body, flags = packed, _FRAME_FLAG_ZLIB
    head = json.dumps(header, separators=(",", ":")).encode()
    fixed = _FRAME_HEADER.pack(_FRAME_MAGIC, _FRAME_VERSION, verb, flags, len(head), len(body))
    _write_proto(fixed, head, body)


def _handle_frames_cmd(command: dict) -> None:
    """Negotiation: ack version 1 and the accepted body codec, and switch
    this side's output to frames.  A disabled runtime answers ``version:
    0``, so the client settles on JSON lines at once."""
    if not _frames_enabled():
        _emit({"event": "frames", "version": 0})
        return
    codec = "zlib" if str(command.get("codec") or "") == "zlib" else ""
    _emit({"event": "frames", "version": _FRAME_VERSION, "codec": codec})
    _FRAMES["out"] = True
    _FRAMES["codec"] = codec


def _frame_resync(buffer: bytearray) -> None:
    """Drop garbage through the next newline (or all of it): after a bad
    magic, version or length the position is untrusted, and the next
    newline is the only honest resync point."""
    nl = buffer.find(b"\n", 1)
    if nl < 0:
        buffer.clear()
    else:
        del buffer[:nl + 1]


def _extract_commands(buffer: bytearray) -> list:
    """Every complete inbound message in ``buffer``, frames and JSON lines
    (consumed in place; an incomplete frame or line stays buffered).

    Malformed input is answered with an ``error`` event and skipped, never
    allowed to hang the loop: a bad magic, version or length (``bad_frame``,
    then a resync at the next newline), a frame header that is not a JSON
    object (the frame is consumed whole, the stream stays in sync), a torn
    compressed body (``bad_frame``, ``permanent``, to every op id it
    carries), or a line that is not a JSON object.
    """
    commands: list = []
    while buffer:
        if buffer[0] == _FRAME_MAGIC[0]:
            if len(buffer) < _FRAME_HEADER.size:
                break  # header still in flight
            magic, version, _verb, flags, hlen, blen = _FRAME_HEADER.unpack(
                bytes(buffer[:_FRAME_HEADER.size]))
            if magic != _FRAME_MAGIC or version != _FRAME_VERSION:
                _emit({"event": "error", "code": "bad_frame",
                       "message": f"bad frame magic/version ({magic!r} v{version})"})
                _frame_resync(buffer)
                continue
            if hlen > _FRAME_MAX_HEADER or blen > _FRAME_MAX_BODY:
                _emit({"event": "error", "code": "bad_frame",
                       "message": f"oversized frame (header {hlen}B, body {blen}B)"})
                _frame_resync(buffer)
                continue
            total = _FRAME_HEADER.size + hlen + blen
            if len(buffer) < total:
                break  # body still in flight
            header = bytes(buffer[_FRAME_HEADER.size:_FRAME_HEADER.size + hlen])
            body = bytes(buffer[_FRAME_HEADER.size + hlen:total])
            del buffer[:total]
            try:
                command = json.loads(header.decode("utf-8"))
                if not isinstance(command, dict):
                    raise ValueError("frame header is not an object")
            except (ValueError, UnicodeDecodeError) as err:
                _emit({"event": "error", "code": "bad_frame",
                       "message": f"frame header is not JSON: {err}"})
                continue
            if flags & _FRAME_FLAG_ZLIB:
                try:
                    body = zlib.decompress(body)
                except zlib.error as err:
                    ids = [str(command.get("id") or "")]
                    if command.get("cmd") == "multi_invoke":
                        # a batched frame's ids live in its ops: the refusal
                        # must reach every waiting op
                        ids = [str(op.get("id") or "") for op in (command.get("ops") or [])
                               if isinstance(op, dict)] or ids
                    for tid in ids:
                        _emit({"event": "error", "id": tid, "code": "bad_frame",
                               "permanent": True,
                               "message": f"frame body failed decompression (torn payload): "
                                          f"{err}"})
                    continue
            key = command.pop("_body", None)
            if key:
                command[str(key)] = body
            commands.append(command)
        else:
            nl = buffer.find(b"\n")
            if nl < 0:
                break  # line still in flight
            line = bytes(buffer[:nl]).decode(errors="replace").strip()
            del buffer[:nl + 1]
            if not line:
                continue
            try:
                command = json.loads(line)
            except ValueError:
                command = None
            if isinstance(command, dict):
                commands.append(command)
            else:
                _emit({"event": "error", "message": "malformed command"})
    return commands


class _TelemetryBatcher:
    """Coalesces side-band records into ``telemetry_batch`` frames.

    With frames on, the intermediate ``serve.token`` chunks of one engine
    step buffer per id and ship as ONE frame whose body is the JSON array
    of the records: the session loop flushes its id when the step's chunks
    are out (:meth:`flush`), and a buffer of
    ``COVALENT_TPU_SERVE_COALESCE_MAX`` records (default 32) goes at once.
    Everything else (a stream's last chunk, rejects, stats, an RPC
    invocation's records) flushes the buffers and itself at once, so per-id
    order holds and a stream's end is never delayed.  Every record keeps
    its own envelope (seq, cumulative ``idx``): the client's dedup and
    exactly-once splice see the records they always did.  With frames off,
    every record is its own JSON line, as before negotiation.

    The reference flushes a buffer once it is ``COVALENT_TPU_SERVE_COALESCE_MS``
    (2 ms) old, checked by the session loop between steps; a step of this
    port's engine takes a whole sync chunk (about a second for the 125M LM
    at 32 steps), so a chunk would wait for the next one.  Flushing at the
    end of the step keeps the coalescing and drops the wait, and the
    window.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending: dict = {}  # id -> [records]
        try:
            self.max_records = max(1, int(os.environ.get("COVALENT_TPU_SERVE_COALESCE_MAX",
                                                         "32")))
        except ValueError:
            self.max_records = 32

    def emit(self, task_id: str, data: dict) -> None:
        if not _FRAMES["out"]:
            _emit({"event": "telemetry", "id": task_id, "data": data})
            return
        urgent = data.get("type") != "serve.token" or data.get("done")
        with self._lock:
            self._pending.setdefault(task_id, []).append(data)
            full = len(self._pending[task_id]) >= self.max_records
        if urgent or full:
            self.flush()

    def flush(self, task_id: str | None = None) -> None:
        """Send the buffered records: every id's, or ``task_id``'s only.
        Sent under the batcher's lock, so a second thread's flush cannot
        overtake this one's records on the wire."""
        with self._lock:
            if task_id is None:
                pending, self._pending = self._pending, {}
            else:
                records = self._pending.pop(task_id, None)
                pending = {task_id: records} if records else {}
            for tid, records in pending.items():
                emit_telemetry_batch(tid, records)


def emit_telemetry_batch(task_id: str, records: list) -> None:
    """One coalesced telemetry frame (one JSON line per record with frames off)."""
    if not _FRAMES["out"]:
        for data in records:
            _emit({"event": "telemetry", "id": task_id, "data": data})
        return
    try:
        body = json.dumps(records, default=repr).encode()
    except (TypeError, ValueError):
        return
    _emit_frame(_VERB_TELEMETRY, {"event": "telemetry_batch", "id": task_id,
                                  "count": len(records), "_body": "records"}, body)


_BATCHER = _TelemetryBatcher()


def _load_fn_payload(path: str, digest: str):
    """``(code, fn_or_error)``: digest-verified CAS bytes -> callable."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as err:
        return "missing", err
    import hashlib

    if hashlib.sha256(data).hexdigest() != digest:
        return "digest_mismatch", RuntimeError(
            f"registered function {path} does not match its content digest "
            "(torn or stale CAS artifact)"
        )
    try:
        import cloudpickle

        return "", cloudpickle.loads(data)
    except BaseException as err:  # noqa: BLE001 - arbitrary user payloads
        return "load_failed", err


def _inference_thread() -> None:
    """Turn autograd off on the calling thread (grad mode is per thread):
    everything a session thread runs is inference."""
    try:
        import torch
    except ImportError:
        return
    torch.set_grad_enabled(False)


def _device_mem() -> dict:
    """The card's allocator counters, once this process has touched CUDA."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return {}
    return {"device_mem": {"bytes_in_use": torch.cuda.memory_allocated(),
                           "peak_bytes_in_use": torch.cuda.max_memory_allocated()}}


def _gray_chaos_from_env() -> dict | None:
    """The worker's gray faults from ``COVALENT_TPU_CHAOS`` (the
    dispatcher's ``ChaosTransport`` gates its own ops; a serving brownout
    must live in the decode loop).  Only ``seed``, ``jitter``, ``p_slow``
    and ``slow_factor`` are read, other keys are the transport's to check;
    None when no gray mode is set."""
    import random as random_mod

    spec = os.environ.get("COVALENT_TPU_CHAOS", "").strip()
    if not spec:
        return None
    vals = {"seed": 0.0, "jitter": 0.0, "p_slow": 0.0, "slow_factor": 10.0}
    for token in spec.split(","):
        key, sep, value = token.strip().partition("=")
        if sep and key.strip() in vals:
            try:
                vals[key.strip()] = float(value)
            except ValueError:
                pass
    if vals["jitter"] <= 0 and vals["p_slow"] <= 0:
        return None
    return {"rng": random_mod.Random(int(vals["seed"])), "jitter": vals["jitter"],
            "p_slow": vals["p_slow"], "slow_s": vals["slow_factor"] * max(vals["jitter"], 0.01)}


class _ServeSession:
    """One resident serving session: engine, admission queue, loop thread.

    The command loop calls :meth:`submit` / :meth:`cancel_request` /
    :meth:`close` (cheap, never blocking); the factory call (model build on
    the card), admission and decode chunks run on the session's own daemon
    thread, so the protocol stays live while the engine works.
    """

    def __init__(self, sid: str, command: dict) -> None:
        import queue as queue_mod

        self.sid = sid
        self.spec = dict(command.get("spec") or {})
        self.spec.setdefault("operation_id", sid)
        #: the decode loop's gray faults (set when the loop starts)
        self._gray = None
        options = dict(command.get("options") or {})
        try:
            self.queue_max = max(1, int(options.get("queue_max", 64)))
        except (TypeError, ValueError):
            self.queue_max = 64
        try:
            self.default_deadline_s = float(options.get("default_deadline_s") or 0.0)
        except (TypeError, ValueError):
            self.default_deadline_s = 0.0
        try:
            self.stats_interval_s = float(options.get("stats_interval_s") or 1.0)
        except (TypeError, ValueError):
            self.stats_interval_s = 1.0
        self.digest = str(command.get("digest") or "")
        self.path = str(command.get("path") or "")
        self.queue: "queue_mod.Queue" = queue_mod.Queue()
        #: serve_prefill commands awaiting the session thread (the
        #: disaggregated set's prefill-only work: no decode lane taken)
        self.prefill_queue: "queue_mod.Queue" = queue_mod.Queue()
        #: serve_attach/serve_detach commands awaiting the session thread
        self.attach_queue: "queue_mod.Queue" = queue_mod.Queue()
        self.attaches = 0
        #: rid -> {"deadline": abs monotonic | None, "emitted": n, "t_admit"}
        self.running: dict = {}
        #: rids accepted into the queue and not yet admitted or refused.
        self.queued: set = set()
        #: every rid ever accepted: a queued request ("pending") against
        #: one this worker never saw ("unknown") when a stream resumes
        self.submitted: set = set()
        #: rid -> every token emitted so far, for running lanes: the
        #: recovery path's ``serve_resume`` re-emits ``history[from:]``.
        #: Extended together with each chunk's emission under
        #: ``_history_lock``, so a resume and a live chunk never leave a gap.
        self.history: dict = {}
        #: rid -> {"tokens", "error"} of finished streams, bounded: a stream
        #: that ended while no dispatcher listened resumes to its whole answer
        self.finished: dict = {}
        self.finished_max = 256
        self._history_lock = threading.Lock()
        #: rids a ``serve_cancel`` asked to kill, drained on the session
        #: thread (running lane -> engine cancel + terminal record;
        #: queued -> skipped at admission).
        self.cancels: set = set()
        self._cancel_lock = threading.Lock()
        self._cancelled_pending: set = set()
        self.slots = 1
        self.served = 0
        self.tokens_total = 0
        #: KV admissions (a shipped bundle took a lane), full-prefill
        #: fallbacks of KV-carrying requests, and prefill-only passes
        self.kv_admits = 0
        self.kv_fallbacks = 0
        self.prefills = 0
        self._t_open = time.time()
        self._closed = threading.Event()
        self._engine = None
        self._thread = threading.Thread(
            target=self._loop, name=f"covalent-gpu-serve-{sid}", daemon=True
        )

    # -- command-loop surface (must never block) ---------------------------

    def start(self) -> None:
        self._thread.start()

    def submit(self, command: dict) -> None:
        """Admission control: bounded queue, immediate shed on overflow."""
        rid = str(command.get("rid") or "")
        if not rid:
            self._emit_reject("", "bad_request", "serve_request requires rid")
            return
        if self._closed.is_set():
            self._emit_reject(rid, "unknown_session", "session closed")
            return
        if self.queue.qsize() >= self.queue_max:
            self._emit_reject(
                rid, "serve_admission_shed", f"admission queue full ({self.queue_max})"
            )
            return
        command = dict(command)
        command["_enqueued"] = time.monotonic()
        self.queued.add(rid)
        self.submitted.add(rid)
        self.queue.put(command)

    def submit_attach(self, command: dict) -> None:
        """Queue one serve_attach/serve_detach for the session thread: the
        splice happens between decode chunks on the engine's own thread, and
        its answer (``serve_attached``/``serve_detached``) is emitted from
        there, so it cannot reorder against the splice (reference
        ``harness.py:2154-2170``)."""
        if self._closed.is_set():
            _emit({"event": str(command.get("cmd") or "serve_attach") + "ed", "id": self.sid,
                   "adapter": str(command.get("adapter") or ""), "code": "unknown_session",
                   "message": "session closed", "permanent": True})
            return
        self.attach_queue.put(dict(command))
        self.queue.put(None)  # wake an idle loop now

    def submit_prefill(self, command: dict) -> None:
        """Queue one prefill-only command (the disaggregated set's prefill
        replica).  The bounded-admission verdict of :meth:`submit`; a
        refusal answers with a ``serve_kv`` error, so the dispatcher
        degrades to a full prefill at once instead of waiting out its
        timeout."""
        rid = str(command.get("rid") or "")
        if not rid:
            self._emit_kv("", code="bad_request", message="serve_prefill requires rid")
            return
        if self._closed.is_set():
            self._emit_kv(rid, code="unknown_session", message="session closed")
            return
        if self.prefill_queue.qsize() >= self.queue_max:
            self._emit_kv(rid, code="serve_admission_shed",
                          message=f"prefill queue full ({self.queue_max})")
            return
        self.prefill_queue.put(dict(command))
        self.queue.put(None)  # wake an idle loop now, not at its next tick

    def cancel_request(self, rid: str) -> None:
        """Ask the session thread to cancel one request, running or queued;
        its terminal ``serve.token`` record (``error="cancelled"``) comes
        from that thread, in order with the live chunks."""
        if not rid:
            return
        with self._cancel_lock:
            self.cancels.add(rid)
        self.queue.put(None)  # wake an idle loop promptly

    def close(self) -> None:
        self._closed.set()
        self.queue.put(None)  # wake the loop

    # -- emission ----------------------------------------------------------

    def _emit_serve(self, type: str, **fields) -> None:
        """One session record over the telemetry side-band, through the
        coalescer: intermediate token chunks batch into one frame per
        window, everything else goes at once, in order."""
        _BATCHER.emit(self.sid, _build_worker_event(self.spec, type, rpc=True, **fields))

    def _emit_span(self, name: str, trace, t0: float, t1: float | None = None,
                   **attrs) -> None:
        """One worker-side span on the side-band, in the request's trace.

        ``trace`` is the request's carrier off its ``serve_request`` (or
        ``serve_prefill``) command; without one nothing is sent, so a
        worker never starts a trace of its own.  The dispatcher re-emits
        the record with these ids (``SessionSupervisor._on_remote_span``),
        which puts the worker's queue, admission, prefill and decode time
        inside the request's waterfall.  ``t0``/``t1`` are monotonic; the
        wall-clock ``start_ts`` is rebuilt here."""
        if not isinstance(trace, dict) or not trace.get("trace_id"):
            return
        t1 = time.monotonic() if t1 is None else t1
        parent = trace.get("span_id")
        fields = {
            "name": name, "trace_id": str(trace["trace_id"]),
            "parent_id": str(parent) if parent else None,
            "span_id": os.urandom(8).hex(),
            "start_ts": round(time.time() - (time.monotonic() - t0), 6),
            "duration_s": round(max(0.0, t1 - t0), 6), "status": "OK",
        }
        if attrs:
            fields["attributes"] = attrs
        self._emit_serve("span", **fields)

    def _emit_kv(self, rid: str, data: bytes | None = None, code: str = "",
                 message: str = "") -> None:
        """One ``serve_kv`` answer to a prefill command: the bundle rides a
        raw frame body on a negotiated channel, base64 in the JSON line
        otherwise, with its sha256; a failure sends ``code``/``message``."""
        event = {"event": "serve_kv", "id": self.sid, "rid": rid}
        if code:
            event["code"] = code
            event["message"] = message
            _emit(event)
            return
        import hashlib

        data = data or b""
        event["digest"] = hashlib.sha256(data).hexdigest()
        event["bytes"] = len(data)
        if _FRAMES["out"]:
            event["_body"] = "data_bytes"
            _emit_frame(_VERB_SERVE, event, data)
        else:
            import base64

            event["data"] = base64.b64encode(data).decode("ascii")
            _emit(event)

    def _pump_attach(self) -> None:
        """Apply the queued adapter splices (reference ``harness.py:2312-
        2383``): ``serve_attach`` loads a sha256-verified CAS bundle (the
        registry's wire form) and calls the engine's ``attach_adapter(name,
        payload)``; ``serve_detach`` its ``detach_adapter(name)``.  A failure
        answers with the same event carrying ``code``/``message`` and
        ``permanent``: an engine refusal tagged permanent (a geometry
        mismatch, a full bank, an unknown adapter) is refused once, not
        retried."""
        import queue as queue_mod

        while True:
            try:
                command = self.attach_queue.get_nowait()
            except queue_mod.Empty:
                return
            verb = str(command.get("cmd") or "serve_attach")
            event, name = verb + "ed", str(command.get("adapter") or "")
            t_attach = time.monotonic()

            def fail(code: str, err, permanent: bool = True, label: str = "") -> None:
                _emit({"event": event, "id": self.sid, "adapter": name, "code": code,
                       "message": repr(err), "permanent": bool(permanent),
                       **({"label": label} if label else {})})

            method = getattr(self._engine, "detach_adapter" if verb == "serve_detach"
                             else "attach_adapter", None)
            if method is None:
                fail("unsupported", f"engine has no {verb[6:]}_adapter surface")
                continue
            if verb == "serve_detach":
                try:
                    method(name)
                except BaseException as err:  # noqa: BLE001 - engine refusals
                    fail("unknown_adapter", err)
                    continue
                _emit({"event": event, "id": self.sid, "adapter": name})
                continue
            code, payload = _load_fn_payload(str(command.get("path") or ""),
                                             str(command.get("digest") or ""))
            if code:
                fail(code, payload, permanent=(code == "digest_mismatch"))
                continue
            try:
                digest = method(name, payload)
            except BaseException as err:  # noqa: BLE001 - engine refusals
                label = str(getattr(err, "fault_label", "") or "")
                fail("attach_failed", err,
                     permanent=bool(label) and not getattr(err, "fault_transient", False),
                     label=label)
                continue
            self.attaches += 1
            _emit({"event": event, "id": self.sid, "adapter": name, "digest": str(digest or ""),
                   "attach_s": round(time.monotonic() - t_attach, 6)})

    def _pump_prefill(self) -> None:
        """Run the queued prefill-only commands on the session thread (the
        engine is single-threaded state) and send each KV bundle back."""
        import queue as queue_mod

        while True:
            try:
                command = self.prefill_queue.get_nowait()
            except queue_mod.Empty:
                return
            rid = str(command.get("rid") or "")
            prefill = getattr(self._engine, "prefill_only", None)
            if prefill is None:
                self._emit_kv(rid, code="unsupported",
                              message="engine has no prefill_only surface")
                continue
            t_prefill = time.monotonic()
            try:
                data = prefill(command.get("prompt"), dict(command.get("params") or {}))
                if not isinstance(data, (bytes, bytearray)):
                    raise TypeError(f"prefill_only returned {type(data).__name__}, want bytes")
            except BaseException as err:  # noqa: BLE001 - engine refusals
                self._emit_kv(rid, code="prefill_failed", message=repr(err))
                continue
            self.prefills += 1
            self._emit_span("serve.worker.prefill", command.get("trace"), t_prefill, rid=rid,
                            kv_bytes=len(data))
            self._emit_kv(rid, bytes(data))

    @staticmethod
    def _resolve_kv(command: dict):
        """``(bundle bytes, verified)`` of a request that carries a KV bundle:
        a frame body (``kv_bytes``), base64 (``kv``) or a CAS path
        (``kv_path``).  Its sha256 must match ``kv_digest`` before the
        engine may unpickle it; any failure is ``(None, False)``, and the
        request degrades to a full prefill."""
        data = command.get("kv_bytes")
        if data is None and command.get("kv"):
            import base64

            try:
                data = base64.b64decode(command["kv"])
            except (TypeError, ValueError):
                return None, False
        if data is None and command.get("kv_path"):
            try:
                with open(command["kv_path"], "rb") as f:
                    data = f.read()
            except OSError:
                return None, False
        if data is None:
            return None, False
        import hashlib

        digest = str(command.get("kv_digest") or "")
        if not digest or hashlib.sha256(data).hexdigest() != digest:
            return None, False
        return bytes(data), True

    def _emit_reject(self, rid: str, code: str, message: str) -> None:
        self._emit_serve("serve.reject", rid=rid, code=code, message=message)

    def _emit_terminal(self, rid: str, idx: int, error: str) -> None:
        """A stream's last record with no tokens: cancelled or out of time."""
        with self._history_lock:
            self._emit_serve("serve.token", rid=rid, idx=idx, tokens=[], done=True, error=error)
            self._finish_history(rid, error)

    def _finish_history(self, rid: str, error: str = "") -> None:
        """Move one rid's history into the bounded finished ring (the
        caller holds ``_history_lock``)."""
        tokens = self.history.pop(rid, [])
        self.finished[rid] = {"tokens": tokens, "error": error}
        while len(self.finished) > self.finished_max:
            self.finished.pop(next(iter(self.finished)))

    def resume(self, rid: str, start: int) -> None:
        """Re-emit one stream's tokens from ``start`` (the recovery path),
        then ack with what this worker knows of it: ``streaming`` (a live
        lane, its tokens re-emitted), ``done`` (the finished ring: the
        tail and ``done`` re-emitted), ``pending`` (queued, nothing emitted
        yet) or ``unknown`` (never seen: the dispatcher sends the request
        again).  The re-emission and any live chunk take the history lock,
        so the wire sees ``history[start:]`` at idx ``start`` and then
        chunks that continue from its end; the dispatcher's splice drops
        any overlap."""
        start = max(0, int(start or 0))
        with self._history_lock:
            if rid in self.running:
                tokens = list(self.history.get(rid, ())[start:])
                self._emit_serve("serve.token", rid=rid, idx=start, tokens=tokens,
                                 done=False, resumed=True)
                state, sent = "streaming", len(tokens)
            elif rid in self.finished:
                entry = self.finished[rid]
                tokens = list(entry["tokens"][start:])
                extra = {"error": entry["error"]} if entry.get("error") else {}
                self._emit_serve("serve.token", rid=rid, idx=start, tokens=tokens,
                                 done=True, resumed=True, **extra)
                state, sent = "done", len(tokens)
            elif rid in self.submitted:
                state, sent = "pending", 0
            else:
                state, sent = "unknown", 0
        _BATCHER.flush(self.sid)
        _emit({"event": "serve_resumed", "id": self.sid, "rid": rid,
               "state": state, "from": start, "sent": sent})

    def inventory(self) -> dict:
        """This session's entry in the ``serve_inventory`` answer."""
        with self._history_lock:
            running = {rid: int(state.get("emitted") or 0)
                       for rid, state in self.running.items()}
            finished = {rid: {"tokens": len(entry["tokens"]), "error": entry.get("error") or ""}
                        for rid, entry in self.finished.items()}
        entry = {"sid": self.sid, "digest": self.digest, "slots": self.slots,
                 "served": self.served, "queued": self.queue.qsize(),
                 "running": running, "finished": finished}
        # the attached adapters (name -> content digest): recovery compares
        # them with the journaled records to decide which to re-attach
        digests = getattr(self._engine, "adapter_digests", None)
        if isinstance(digests, dict) and digests:
            entry["adapters"] = {str(k): str(v) for k, v in digests.items()}
        return entry

    def _emit_stats(self) -> None:
        # The engine's own counters (a ContinuousEngine's prefix-tree hits,
        # prefill positions, ...) ride along: every number in its ``stats``.
        engine_stats = getattr(self._engine, "stats", None)
        fields: dict = {}
        if isinstance(engine_stats, dict):
            fields = {str(k): v for k, v in engine_stats.items()
                      if isinstance(v, (int, float)) and not isinstance(v, bool)}
        age = max(time.time() - self._t_open, 1e-9)
        fields.update(
            slots=self.slots,
            busy=len(self.running),
            queued=self.queue.qsize(),
            served=self.served,
            tokens_total=self.tokens_total,
            tokens_per_s=round(self.tokens_total / age, 3),
            **_device_mem(),
        )
        if self.kv_admits or self.kv_fallbacks:
            fields.update(kv_admits=self.kv_admits, kv_fallbacks=self.kv_fallbacks)
        if self.prefills:
            fields["prefills"] = self.prefills
        self._emit_serve("serve.stats", **fields)

    # -- session thread ----------------------------------------------------

    def _open_engine(self) -> bool:
        """Apply the spec env, load + verify the factory payload, build the
        engine with autograd off on this thread, ack open."""
        try:
            _apply_spec_env(self.spec)
        except RuntimeError as err:
            self._emit_open_error("spec_env", err, permanent=True)
            return False
        _inference_thread()
        code, loaded = _load_fn_payload(self.path, self.digest)
        if code:
            self._emit_open_error(code, loaded, permanent=(code == "digest_mismatch"))
            return False
        try:
            self._engine = loaded()
        except BaseException as err:  # noqa: BLE001 - arbitrary factories
            # A factory refusing its model shape tags fault_label /
            # fault_transient: the dispatcher must not retry it.
            label = getattr(err, "fault_label", "") or ""
            permanent = bool(label) and not bool(getattr(err, "fault_transient", False))
            self._emit_open_error("factory_failed", err, permanent=permanent, label=label)
            return False
        try:
            self.slots = max(1, int(getattr(self._engine, "slots", 1)))
        except (TypeError, ValueError):
            self.slots = 1
        _emit({"event": "serve_opened", "id": self.sid, "slots": self.slots,
               "pid": os.getpid()})
        return True

    def _emit_open_error(self, code: str, err, permanent: bool = False,
                         label: str = "") -> None:
        # Terminal BEFORE the error leaves the process: the client may
        # reopen the sid the moment this event lands.
        self._closed.set()
        _emit({
            "event": "serve_error", "id": self.sid, "code": code,
            "message": repr(err), "permanent": bool(permanent),
            **({"label": label} if label else {}),
        })

    def _admit_waiting(self) -> None:
        """Move queued requests onto free engine lanes (deadline-checked)."""
        import queue as queue_mod

        while len(self.running) < self.slots:
            try:
                command = self.queue.get_nowait()
            except queue_mod.Empty:
                return
            if command is None:
                continue
            rid = str(command.get("rid") or "")
            self.queued.discard(rid)
            if rid in self._cancelled_pending:
                self._cancelled_pending.discard(rid)
                self._emit_terminal(rid, 0, "cancelled")
                continue
            deadline_s = command.get("deadline_s", self.default_deadline_s)
            try:
                deadline_s = float(deadline_s or 0.0)
            except (TypeError, ValueError):
                deadline_s = 0.0
            if deadline_s > 0 and time.monotonic() - command["_enqueued"] >= deadline_s:
                self._emit_reject(
                    rid, "deadline", f"request spent its {deadline_s:.1f}s deadline queued"
                )
                continue
            params = dict(command.get("params") or {})
            trace = command.get("trace")
            t_admit_start = time.monotonic()
            self._emit_span("serve.worker.queue_wait", trace, command["_enqueued"],
                            t_admit_start, rid=rid)
            admitted = False
            if (command.get("kv_bytes") is not None or command.get("kv")
                    or command.get("kv_path")):
                # The disaggregated road: the shipped bundle goes straight
                # into a lane, digest-verified first.  Any failure (a torn
                # transfer, a digest mismatch, a bundle of another engine
                # shape) degrades to the full prefill below: the stream is
                # the same either way.
                kv_data, verified = self._resolve_kv(command)
                admit_kv = getattr(self._engine, "admit_from_kv", None)
                if verified and admit_kv is not None:
                    try:
                        admit_kv(rid, kv_data, params)
                        admitted = True
                        self.kv_admits += 1
                    except BaseException:  # noqa: BLE001 - fall back
                        admitted = False
                if not admitted:
                    self.kv_fallbacks += 1
            if not admitted:
                try:
                    self._engine.admit(rid, command.get("prompt"), params)
                except BaseException as err:  # noqa: BLE001 - rejections
                    self._emit_reject(rid, "engine_error", repr(err))
                    continue
            t_admitted = time.monotonic()
            self._emit_span("serve.worker.admission", trace, t_admit_start, t_admitted,
                            rid=rid, kv=admitted)
            self.running[rid] = {
                "deadline": command["_enqueued"] + deadline_s if deadline_s > 0 else None,
                "emitted": 0,
                "t_admit": t_admitted,
                "trace": trace,
            }

    def _cancel_lane(self, rid: str) -> None:
        cancel = getattr(self._engine, "cancel", None)
        if cancel is not None:
            try:
                cancel(rid)
            except BaseException:  # noqa: BLE001 - best-effort free
                pass

    def _end_lane(self, rid: str, error: str) -> None:
        """Free a running lane early and close its stream with ``error``."""
        self._cancel_lane(rid)
        state = self.running[rid]
        self._emit_span("serve.worker.decode", state.get("trace"), state["t_admit"], rid=rid,
                        tokens=state["emitted"], error=error)
        with self._history_lock:
            state = self.running.pop(rid)
            self._emit_serve("serve.token", rid=rid, idx=state["emitted"], tokens=[],
                             done=True, error=error)
            self._finish_history(rid, error)
        self.served += 1

    def _drain_cancels(self) -> None:
        """Apply queued ``serve_cancel`` requests: a running lane ends now,
        a queued rid is skipped at admission, an unknown rid is a no-op
        (cancels race completion by design)."""
        with self._cancel_lock:
            if not self.cancels:
                return
            rids = list(self.cancels)
            self.cancels.clear()
        for rid in rids:
            if rid in self.running:
                self._end_lane(rid, "cancelled")
            elif rid in self.queued:
                self._cancelled_pending.add(rid)

    def _pump_engine(self) -> None:
        """One decode chunk for every busy lane; stream the fresh tokens.
        A gray chaos plan (``_gray_chaos_from_env``) delays the chunk first:
        the engine still answers, late."""
        gray = self._gray
        if gray is not None:
            if gray["jitter"] > 0:
                time.sleep(gray["rng"].random() * gray["jitter"])
            if gray["p_slow"] > 0 and gray["rng"].random() < gray["p_slow"]:
                time.sleep(gray["slow_s"])
        try:
            events = self._engine.step() or []
        except BaseException as err:  # noqa: BLE001 - an engine crash fails all
            for rid in list(self.running):
                self._emit_reject(rid, "engine_error", repr(err))
                self._cancel_lane(rid)
                self.running.pop(rid, None)
                with self._history_lock:
                    self._finish_history(rid, "engine_error")
            return
        for event in events:
            rid = str(event.get("rid") or "")
            state = self.running.get(rid)
            if state is None:
                continue
            tokens = list(event.get("tokens") or ())
            done = bool(event.get("done"))
            extra = {k: v for k, v in event.items() if k not in ("rid", "tokens", "done")}
            if done:
                extra.setdefault("gen_s", round(time.monotonic() - state["t_admit"], 6))
                # the span before the last chunk: the dispatcher closes the
                # request's trace on ``done``
                self._emit_span("serve.worker.decode", state.get("trace"), state["t_admit"],
                                rid=rid, tokens=state["emitted"] + len(tokens))
            # history and emission are one unit under the lock a resume
            # takes: a resume's snapshot holds this chunk, or the chunk's
            # idx lands at or past the resume's end
            with self._history_lock:
                idx = state["emitted"]
                state["emitted"] += len(tokens)
                self.tokens_total += len(tokens)
                if tokens:
                    self.history.setdefault(rid, []).extend(tokens)
                self._emit_serve("serve.token", rid=rid, idx=idx, tokens=tokens, done=done,
                                 **extra)
                if done:
                    self.served += 1
                    self.running.pop(rid, None)
                    self._finish_history(rid, str(extra.get("error") or ""))
        # the step's chunks leave together, now
        _BATCHER.flush(self.sid)
        # A lane past its deadline is cancelled and closed with an error
        # marker, freeing the slot.
        now = time.monotonic()
        for rid, state in list(self.running.items()):
            if state["deadline"] is not None and now >= state["deadline"]:
                self._end_lane(rid, "deadline_exceeded")

    def _loop(self) -> None:
        self._gray = _gray_chaos_from_env()
        if not self._open_engine():
            return
        last_stats = time.monotonic()
        try:
            while not (self._closed.is_set() and not self.running and self.queue.empty()):
                self._drain_cancels()
                self._pump_attach()
                self._pump_prefill()
                self._admit_waiting()
                if self.running:
                    self._pump_engine()
                else:
                    # Idle: block on the queue with a short tick so stats
                    # keep flowing and close() wakes promptly.
                    import queue as queue_mod

                    try:
                        command = self.queue.get(timeout=0.1)
                    except queue_mod.Empty:
                        command = None
                    if command is not None:
                        self.queue.put(command)
                if (self.stats_interval_s > 0
                        and time.monotonic() - last_stats >= self.stats_interval_s):
                    last_stats = time.monotonic()
                    self._emit_stats()
        finally:
            closer = getattr(self._engine, "close", None)
            if closer is not None:
                try:
                    closer()
                except BaseException:  # noqa: BLE001 - teardown best-effort
                    pass
            self._emit_stats()
            # the stats record flushed the buffered tokens ahead of it;
            # serve_closed must not overtake a straggler batch either
            _BATCHER.flush()
            _emit({"event": "serve_closed", "id": self.sid, "served": self.served})


# ---------------------------------------------------------------------------
# The dispatcher epoch fence (split-brain guard; reference harness.py:1879-1960).
# ---------------------------------------------------------------------------

#: ``value`` is the highest epoch this worker has ever seen (an ``epoch``
#: command, or the adopt handshake); ``channel`` the epoch the current
#: channel declared.  A channel below the high-water mark belongs to a
#: dispatcher that crashed and was succeeded: its mutating commands are
#: refused with ``stale_epoch``.  Both start at 0, so a dispatcher that
#: never declares an epoch (journaling off) is not fenced.
_EPOCH = {"value": 0, "channel": 0}

#: Commands that mutate worker state and are fenced.  Reads (ping, the
#: inventories, watch) stay open to any dispatcher: a stale one can look,
#: not touch.
_FENCED_CMDS = frozenset((
    "run", "register_fn", "invoke", "multi_invoke", "serve_open",
    "serve_request", "serve_prefill", "serve_close", "serve_resume",
    "serve_cancel", "serve_attach", "serve_detach", "kill",
))


def _epoch_ok() -> bool:
    return _EPOCH["channel"] >= _EPOCH["value"]


def _handle_epoch_cmd(command: dict) -> None:
    try:
        declared = int(command.get("epoch") or 0)
    except (TypeError, ValueError):
        declared = 0
    _EPOCH["channel"] = declared
    if declared >= _EPOCH["value"]:
        _EPOCH["value"] = declared
        _emit({"event": "epoch_ok", "epoch": declared})
    else:
        _emit({"event": "error", "id": "", "code": "stale_epoch",
               "message": f"dispatcher epoch {declared} is stale "
                          f"(worker has seen {_EPOCH['value']})"})


def _refuse_stale(name: str, command: dict) -> None:
    """Answer one fenced command of a stale dispatcher in the shape its
    waiter settles on, so the stale dispatcher fails fast."""
    message = (f"stale dispatcher epoch {_EPOCH['channel']} "
               f"(worker fenced at {_EPOCH['value']})")
    sid = str(command.get("id") or "")
    if name == "serve_request":
        _emit({"event": "telemetry", "id": sid, "data": _build_worker_event(
            {}, "serve.reject", rpc=True, rid=str(command.get("rid") or ""),
            code="stale_epoch", message=message)})
    elif name == "serve_prefill":
        _emit({"event": "serve_kv", "id": sid, "rid": str(command.get("rid") or ""),
               "code": "stale_epoch", "message": message})
    elif name in ("serve_open", "serve_close"):
        _emit({"event": "serve_error", "id": sid, "code": "stale_epoch",
               "message": message, "permanent": True})
    elif name == "serve_resume":
        _emit({"event": "serve_resumed", "id": sid, "rid": str(command.get("rid") or ""),
               "state": "refused", "code": "stale_epoch"})
    elif name in ("serve_attach", "serve_detach"):
        _emit({"event": name + "ed", "id": sid, "adapter": str(command.get("adapter") or ""),
               "code": "stale_epoch", "message": message, "permanent": True})
    else:
        _emit({"event": "error", "id": sid, "code": "stale_epoch", "message": message})


def _serve_open(command: dict, sessions: dict) -> None:
    sid = str(command.get("id") or "")
    if not sid or not command.get("digest") or not command.get("path"):
        _emit({"event": "serve_error", "id": sid, "code": "bad_request",
               "message": "serve_open requires id, digest and path", "permanent": True})
        return
    existing = sessions.get(sid)
    if existing is not None:
        if existing._closed.is_set() and existing._thread.is_alive():
            # A failed open (or a drained close) emits its event before the
            # thread's last instructions run: wait out the teardown.
            existing._thread.join(timeout=2.0)
        if existing._closed.is_set() and not existing._thread.is_alive():
            sessions.pop(sid, None)  # a dead entry: the sid is re-openable
        else:
            _emit({"event": "serve_error", "id": sid, "code": "duplicate",
                   "message": f"session {sid} already open", "permanent": True})
            return
    session = _ServeSession(sid, command)
    sessions[sid] = session
    session.start()


def _serve_request(command: dict, sessions: dict) -> None:
    sid = str(command.get("id") or "")
    session = sessions.get(sid)
    if session is None:
        # A streamed per-request reject, so the caller's stream fails fast.
        _emit({"event": "telemetry", "id": sid, "data": _build_worker_event(
            {}, "serve.reject", rpc=True, rid=str(command.get("rid") or ""),
            code="unknown_session", message=f"no open session {sid!r}",
        )})
        return
    session.submit(command)


def _serve_prefill(command: dict, sessions: dict) -> None:
    sid = str(command.get("id") or "")
    session = sessions.get(sid)
    if session is None:
        # a serve_kv error: the prefill waiter settles on serve_kv events only
        _emit({"event": "serve_kv", "id": sid, "rid": str(command.get("rid") or ""),
               "code": "unknown_session", "message": f"no open session {sid!r}"})
        return
    session.submit_prefill(command)


def _serve_attach(command: dict, sessions: dict) -> None:
    """Route one adapter splice (attach or detach) to its session."""
    sid = str(command.get("id") or "")
    session = sessions.get(sid)
    if session is None:
        _emit({"event": str(command.get("cmd") or "serve_attach") + "ed", "id": sid,
               "adapter": str(command.get("adapter") or ""), "code": "unknown_session",
               "message": f"no open session {sid!r}", "permanent": True})
        return
    session.submit_attach(command)


def _serve_close(command: dict, sessions: dict) -> None:
    sid = str(command.get("id") or "")
    session = sessions.pop(sid, None)
    if session is None:
        _emit({"event": "serve_error", "id": sid, "code": "unknown_session",
               "message": f"no open session {sid!r}", "permanent": True})
        return
    session.close()  # the session thread answers serve_closed after its drain


def _serve_cancel(command: dict, sessions: dict) -> None:
    """Fire-and-forget: an unknown session or rid is a silent no-op."""
    session = sessions.get(str(command.get("id") or ""))
    if session is not None:
        session.cancel_request(str(command.get("rid") or ""))


def _serve_resume(command: dict, sessions: dict) -> None:
    sid = str(command.get("id") or "")
    rid = str(command.get("rid") or "")
    session = sessions.get(sid)
    if session is None:
        _emit({"event": "serve_resumed", "id": sid, "rid": rid,
               "state": "unknown", "from": 0, "sent": 0})
        return
    try:
        start = int(command.get("from") or 0)
    except (TypeError, ValueError):
        start = 0
    session.resume(rid, start)


def _serve_inventory(sessions: dict) -> None:
    entries = []
    for session in list(sessions.values()):
        if session._closed.is_set():
            continue
        try:
            entries.append(session.inventory())
        except Exception:  # noqa: BLE001 - one bad session must not hide the rest
            pass
    _emit({"event": "serve_inventory", "pid": os.getpid(), "epoch": _EPOCH["value"],
           "sessions": entries})


# ---------------------------------------------------------------------------
# RPC execute-by-digest (reference: harness.py:1283-1547).
#
# The dispatcher ships the cloudpickled function once per connection into
# the CAS, registers it by digest, and then invokes it by digest with its
# args inline on the channel (or staged in the CAS when oversized); the
# result comes back on the channel (or staged by path when oversized).  No
# process, pid file, poll or result file per electron.  Each invocation
# runs on its own thread of this process: concurrent invocations share the
# warm imports and the one CUDA context, and a crash that takes the process
# down reaches the dispatcher as the channel's death.
# ---------------------------------------------------------------------------


def _rpc_register(command: dict, registry: dict) -> None:
    digest = command.get("digest")
    path = command.get("path")
    if not digest or not path:
        _emit({"event": "error", "message": "register_fn requires digest and path"})
        return
    if digest in registry:  # idempotent: a re-register is a no-op ack
        _emit({"event": "registered", "digest": digest})
        return
    code, loaded = _load_fn_payload(path, digest)
    if code:
        _emit({"event": "register_error", "digest": digest, "code": code,
               "message": repr(loaded)})
        return
    registry[digest] = loaded
    _emit({"event": "registered", "digest": digest})


def _decode_rpc_args(command: dict) -> tuple:
    """``(args, kwargs)`` of an invoke: a frame body (``args_bytes``),
    inline base64, or a CAS path whose bytes are digest-verified before
    they are unpickled (the guard the function pickle gets)."""
    import base64

    import cloudpickle

    raw = command.get("args_bytes")
    b64 = command.get("args")
    if raw is not None:
        data = raw  # the frame delivered the pickle's exact bytes
    elif b64 is not None:
        data = base64.b64decode(b64)
    else:
        path = command.get("args_path")
        if not path:
            return (), {}
        with open(path, "rb") as f:
            data = f.read()
        expected = command.get("args_digest")
        if expected:
            import hashlib

            if hashlib.sha256(data).hexdigest() != expected:
                raise RuntimeError(
                    f"staged RPC args {path} do not match their content digest "
                    "(torn or stale CAS artifact)"
                )
    args, kwargs = cloudpickle.loads(data)
    return tuple(args), dict(kwargs)


def _pickle_rpc_result(result, exception, times: dict) -> bytes:
    """The ``(result, exception, times)`` pickle: the layout of the result
    file launch mode writes."""
    try:
        import cloudpickle as pick
    except ImportError:
        import pickle as pick
    try:
        return pick.dumps((result, exception, times))
    except BaseException as err:  # noqa: BLE001 - unpicklable user results
        import pickle

        return pickle.dumps(
            (None, RuntimeError(f"RPC result not picklable: {err!r}"), times)
        )


def _emit_rpc_result(task_id: str, result, exception, times: dict, command: dict) -> None:
    """Send one invocation's result, inline or staged by size.

    A result pickle at or below ``result_max_inline`` rides the channel
    inline: a raw frame body on a negotiated channel, base64 in a JSON line
    otherwise.  A larger one is written (atomically) to the command's
    ``result_path`` and announced by path and sha256, the size rule the
    args follow on the way in.  No ``result_path`` keeps it inline; a
    staging failure falls back to inline rather than lose the result.
    """
    import base64

    data = _pickle_rpc_result(result, exception, times)
    result_path = command.get("result_path")
    try:
        max_inline = int(command.get("result_max_inline"))
    except (TypeError, ValueError):
        max_inline = -1
    if result_path and 0 <= max_inline < len(data):
        import hashlib

        try:
            tmp = f"{result_path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, result_path)
        except OSError:
            pass  # the inline road below
        else:
            _emit({"event": "result", "id": task_id, "ok": exception is None,
                   "data_path": result_path,
                   "data_digest": hashlib.sha256(data).hexdigest(), "bytes": len(data)})
            return
    if _FRAMES["out"]:
        _emit_frame(_VERB_RESULT, {"event": "result", "id": task_id, "ok": exception is None,
                                   "_body": "data_bytes"}, data)
        return
    _emit({"event": "result", "id": task_id, "ok": exception is None,
           "data": base64.b64encode(data).decode("ascii")})


def _emit_rpc_event(spec: dict, task_id: str, type: str, **fields) -> None:
    """One worker record, pushed over the channel with the ``rpc`` marker
    (it lands in no file a launch-mode worker would write)."""
    _BATCHER.emit(task_id, _build_worker_event(spec, type, rpc=True, **fields))


def _start_rpc_heartbeat(spec: dict, task_id: str):
    """Heartbeats for one invocation over the channel every
    ``spec["heartbeat_s"]`` seconds (none when unset); returns the event
    that stops them."""
    try:
        interval = float(spec.get("heartbeat_s") or 0)
    except (TypeError, ValueError):
        interval = 0.0
    if interval <= 0:
        return None
    stop = threading.Event()

    def beat_loop() -> None:
        hb_seq = 0
        while True:
            hb_seq += 1
            _emit_rpc_event(spec, task_id, "worker.heartbeat", hb_seq=hb_seq,
                            interval_s=interval, **_device_mem())
            if stop.wait(interval):
                return

    threading.Thread(target=beat_loop, name="covalent-gpu-rpc-heartbeat", daemon=True).start()
    return stop


def _fresh_rng() -> None:
    """Reseed the global random generators as a fresh interpreter seeds
    them (from the system's entropy), so an earlier invocation's
    ``torch.manual_seed`` does not carry over into the next.  Invocations
    that run at the same time share the generators all the same."""
    import random

    random.seed()
    numpy = sys.modules.get("numpy")
    if numpy is not None:
        numpy.random.seed()
    torch = sys.modules.get("torch")
    if torch is not None:
        torch.seed()  # CPU now; the card's generators lazily, at CUDA's start


def _run_rpc_task(command: dict, fn) -> None:
    """Run one registered function in this process and send its result.

    The launch-mode contract without the process: the task's env applied
    (``task_env`` means the same in both modes), ``worker.task_started`` /
    ``worker.task_finished`` records, user exceptions transported (never
    raised), tensors moved to host memory before pickling, and ``times``
    from this thread's own clock around the call.
    """
    task_id = command.get("id") or ""
    spec = dict(command.get("spec") or {})
    spec.setdefault("operation_id", task_id)
    result, exception = None, None
    args, kwargs = (), {}
    try:
        _apply_spec_env(spec)
        args, kwargs = _decode_rpc_args(command)
    except BaseException as err:  # noqa: BLE001 - a refused env or torn args fail the task
        exception = err
    _emit_rpc_event(spec, task_id, "worker.task_started", process_id=0)
    heartbeat_stop = _start_rpc_heartbeat(spec, task_id)
    started = time.time()
    try:
        if exception is None:
            _fresh_rng()
            try:
                result = _to_host(fn(*args, **kwargs))
            except Exception as task_error:  # noqa: BLE001 - transported
                exception = task_error
    finally:
        ended = time.time()
        if heartbeat_stop is not None:
            heartbeat_stop.set()
    # The finished record goes before the result: a client settles the
    # invocation and forgets its id on the result, so a record after it
    # would outlive the task in the client's books, or be lost to a
    # shutdown that follows the result.
    _emit_rpc_event(
        spec, task_id, "worker.task_finished", process_id=0, ok=exception is None,
        **({"error": repr(exception)} if exception is not None else {}),
    )
    _emit_rpc_result(task_id, result, exception, {"start": started, "end": ended}, command)


def _rpc_invoke(command: dict, registry: dict, sync: bool = False) -> None:
    task_id = command.get("id")
    digest = command.get("digest")
    if not task_id or not digest:
        _emit({"event": "error", "id": task_id or "",
               "message": "invoke requires id and digest"})
        return
    fn = registry.get(digest)
    if fn is None and command.get("path"):
        # Self-heal a lost registration (the runtime restarted between the
        # dispatcher's register and invoke): load from the CAS path,
        # digest-verified.
        code, loaded = _load_fn_payload(command["path"], digest)
        if not code:
            registry[digest] = fn = loaded
    if fn is None:
        _emit({"event": "error", "id": task_id, "code": "unregistered",
               "message": f"no registered function for digest {digest[:12]}"})
        return
    _emit({"event": "started", "id": task_id, "pid": os.getpid(), "rpc": True})
    if sync:
        _run_rpc_task(command, fn)
        return
    threading.Thread(target=_run_rpc_task, args=(command, fn),
                     name=f"covalent-gpu-rpc-{task_id}", daemon=True).start()


def _rpc_multi_invoke(command: dict, registry: dict) -> None:
    """Batched invoke: N queued electrons of one digest in ONE frame.

    The header carries each op's command (id, spec, result_path, ...) and
    ``args_lens``; the body is the ops' args pickles end to end, split back
    here by length.  One ``multi_started`` acks every op; each op then runs
    as a lone ``invoke`` does, on its own thread with its own result.  A
    body whose lengths do not add up is torn content (``permanent``):
    sending the same bytes again cannot help.
    """
    digest = command.get("digest")
    ops = [op for op in (command.get("ops") or []) if isinstance(op, dict)]
    lens = command.get("args_lens") or []
    body = command.get("args_bytes") or b""
    ids = [str(op.get("id") or "") for op in ops]
    if not digest or not ops or len(lens) != len(ops):
        for tid in ids or [""]:
            _emit({"event": "error", "id": tid, "code": "bad_request",
                   "message": "multi_invoke requires digest, ops and args_lens"})
        return
    try:
        lens = [int(n) for n in lens]
        lens_ok = all(n >= 0 for n in lens) and sum(lens) == len(body)
    except (TypeError, ValueError):
        lens_ok = False
    if not lens_ok:
        for tid in ids:
            _emit({"event": "error", "id": tid, "code": "bad_frame", "permanent": True,
                   "message": "multi_invoke args_lens do not match the frame body "
                              "(torn payload)"})
        return
    fn = registry.get(digest)
    if fn is None and command.get("path"):
        code, loaded = _load_fn_payload(command["path"], digest)
        if not code:
            registry[digest] = fn = loaded
    if fn is None:
        for tid in ids:
            _emit({"event": "error", "id": tid, "code": "unregistered",
                   "message": f"no registered function for digest {str(digest)[:12]}"})
        return
    _emit({"event": "multi_started", "ids": ids, "pid": os.getpid(), "rpc": True})
    offset = 0
    for op, n in zip(ops, lens):
        op = dict(op)
        op["args_bytes"] = body[offset:offset + n]
        offset += n
        threading.Thread(target=_run_rpc_task, args=(op, fn),
                         name=f"covalent-gpu-rpc-{op.get('id')}", daemon=True).start()


# ---------------------------------------------------------------------------
# The run verb: launch-mode specs forked from the zygote.
#
# The reference forks its pool server itself (harness.py:1183-1280); here
# the server may hold a CUDA context, so the fork happens in the zygote,
# which reports each child's pid and exit status back over its stdout:
#
#   server -> zygote  {"cmd":"fork","id":task,"spec":path,"log":path}
#   zygote -> server  {"event":"ready","pid"}
#                     {"event":"forked","id","pid"}
#                     {"event":"fork_error","id","code","message"}
#                     {"event":"exit","pid","code","signal"}
# ---------------------------------------------------------------------------


def _preload() -> None:
    """Import the modules named in ``COVALENT_TPU_POOL_PRELOAD`` (comma-
    separated, default ``cloudpickle``) once; a failure is logged and left
    to the task that needs the module."""
    for mod in filter(None, os.environ.get("COVALENT_TPU_POOL_PRELOAD", "cloudpickle")
                      .split(",")):
        try:
            __import__(mod.strip())
        except Exception as preload_error:  # noqa: BLE001 - tasks retry the import
            print(f"preload {mod} failed: {preload_error}", file=sys.stderr)


class ZygoteCudaError(RuntimeError):
    """The zygote found CUDA initialised in itself and refused to fork."""


#: The zygote's own descriptors (its event channel, its SIGCHLD wake-up
#: pipe), closed in each child.
_ZYGOTE_FDS: list = []


def _zygote_fork(command: dict, children: dict) -> int:
    """Fork one task child, which runs ``command["spec"]``; returns its pid.

    A child forked from a process in which CUDA is initialised cannot use
    the card.  Nothing in the zygote initialises it, so finding it
    initialised is a fault (a preload that touched the card at import): the
    fork raises :class:`ZygoteCudaError` rather than hand the task a broken
    device.
    """
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise ZygoteCudaError(
            "CUDA is initialised in the pool's zygote, so a forked task could not use "
            "the card; refusing to fork (check COVALENT_TPU_POOL_PRELOAD: a preloaded "
            "module must not touch the card at import)"
        )
    sys.stdout.flush()
    sys.stderr.flush()
    pid = os.fork()
    if pid == 0:
        _zygote_child(command)  # never returns
    children[pid] = str(command.get("id") or "")
    return pid


def _zygote_child(command: dict) -> None:
    """The forked task: its own session, stdin from /dev/null, stdout and
    stderr to the task log, then the spec as launch mode runs it."""
    rc = 1
    try:
        # The reference's child resets the server's locks, frame state,
        # telemetry batcher, sessions and profiler here (harness.py:
        # 1195-1225), which a thread of the server may hold at fork time.
        # The zygote runs one thread and holds none of them: nothing to reset.
        import signal

        signal.set_wakeup_fd(-1)
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        for fd in _ZYGOTE_FDS:
            try:
                os.close(fd)
            except OSError:
                pass
        os.setsid()
        log_fd = os.open(command.get("log") or os.devnull,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        devnull = os.open(os.devnull, os.O_RDONLY)
        os.dup2(devnull, 0)
        os.dup2(log_fd, 1)
        os.dup2(log_fd, 2)
        with open(command["spec"]) as f:
            spec = json.load(f)
        rc = run_task(spec)
    except BaseException:  # noqa: BLE001 - the child must never return
        import traceback

        traceback.print_exc()
    finally:
        os._exit(rc)


def _zygote_reap(children: dict) -> None:
    """Report every child that exited as ``exit`` (pid, code, signal)."""
    while True:
        try:
            pid, status = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid <= 0:
            return
        if children.pop(pid, None) is None:
            continue
        code = os.waitstatus_to_exitcode(status)
        _emit({"event": "exit", "pid": pid, "code": code if code >= 0 else -1,
               "signal": -code if code < 0 else 0})


def zygote() -> int:
    """The fork helper's loop (``harness.py --zygote``).

    It imports the preloads, then reads ``fork`` lines on stdin and forks
    one child per line, answering on stdout with ``forked`` or
    ``fork_error``, and with ``exit`` when it reaps a child.  It runs no
    other code: one thread, no lock held, no CUDA context.  When stdin
    closes (the server is gone) it exits once its children have.
    """
    global _PROTO
    import selectors
    import signal
    import traceback

    _PROTO = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    _preload()
    rpipe, wpipe = os.pipe()
    os.set_blocking(rpipe, False)
    os.set_blocking(wpipe, False)
    _ZYGOTE_FDS[:] = [_PROTO.fileno(), rpipe, wpipe]
    signal.set_wakeup_fd(wpipe)
    signal.signal(signal.SIGCHLD, lambda *_: None)
    sel = selectors.DefaultSelector()
    sel.register(0, selectors.EVENT_READ, "commands")
    sel.register(rpipe, selectors.EVENT_READ, "sigchld")
    children: dict = {}
    buffer = bytearray()
    stdin_open = True
    _emit({"event": "ready", "pid": os.getpid()})
    while stdin_open or children:
        for key, _ in sel.select():
            if key.data == "sigchld":
                try:
                    while os.read(rpipe, 512):
                        pass
                except BlockingIOError:
                    pass
                continue
            data = os.read(0, 65536)
            if not data:
                stdin_open = False
                sel.unregister(0)
                continue
            buffer.extend(data)
            for command in _extract_commands(buffer):
                task_id = str(command.get("id") or "")
                if command.get("cmd") != "fork" or not task_id or not command.get("spec"):
                    _emit({"event": "fork_error", "id": task_id, "code": "bad_request",
                           "message": "fork requires id and spec"})
                    continue
                try:
                    pid = _zygote_fork(command, children)
                except Exception as err:  # noqa: BLE001 - reported, and loud in the log
                    traceback.print_exc()
                    _emit({"event": "fork_error", "id": task_id,
                           "code": "cuda_initialized" if isinstance(err, ZygoteCudaError)
                           else "fork_failed", "message": repr(err)})
                    continue
                _emit({"event": "forked", "id": task_id, "pid": pid})
        _zygote_reap(children)
    return 0


class _Zygote:
    """The pool server's handle on its zygote: started at once, restarted
    by the next ``run`` if it died."""

    def __init__(self, harness_path: str, sel) -> None:
        self._harness = harness_path
        self._sel = sel
        self._proc = None
        self._buffer = bytearray()

    def start(self) -> None:
        import selectors
        import subprocess

        # stderr inherited: the server's log
        self._proc = subprocess.Popen(
            [sys.executable, self._harness, "--zygote"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        )
        self._buffer.clear()
        self._sel.register(self._proc.stdout.fileno(), selectors.EVENT_READ, "zygote")

    def send(self, command: dict) -> None:
        line = (json.dumps(command) + "\n").encode()
        for attempt in (0, 1):
            if self._proc is None:
                self.start()
            try:
                self._proc.stdin.write(line)
                self._proc.stdin.flush()
                return
            except (BrokenPipeError, OSError):
                if attempt:
                    raise
                self._drop()

    def read(self) -> list | None:
        """The zygote's complete event lines, or None once it is gone."""
        data = os.read(self._proc.stdout.fileno(), 65536)
        if not data:
            self._drop()
            return None
        self._buffer.extend(data)
        events = []
        while b"\n" in self._buffer:
            line, _, rest = bytes(self._buffer).partition(b"\n")
            self._buffer[:] = rest
            try:
                event = json.loads(line)
            except ValueError:
                continue
            if isinstance(event, dict):
                events.append(event)
        return events

    def _drop(self) -> None:
        proc, self._proc = self._proc, None
        if proc is None:
            return
        try:
            self._sel.unregister(proc.stdout.fileno())
        except (KeyError, ValueError):
            pass
        for stream in (proc.stdin, proc.stdout):
            try:
                stream.close()
            except OSError:
                pass
        try:
            proc.wait(timeout=5.0)
        except Exception:  # noqa: BLE001 - a zygote that will not die is left to init
            pass

    def close(self) -> None:
        """Close the zygote's stdin: it exits once its children have."""
        if self._proc is not None:
            try:
                self._proc.stdin.close()
            except OSError:
                pass


def _spawn_task(command: dict, zygote: _Zygote) -> None:
    """``run``: have the zygote fork a child for the spec; ``started``
    follows when it reports the pid."""
    task_id = command.get("id")
    spec_path = command.get("spec")
    if not task_id or not spec_path:
        _emit({"event": "error", "id": task_id or "", "message": "run requires id and spec"})
        return
    try:
        zygote.send({"cmd": "fork", "id": str(task_id), "spec": spec_path,
                     "log": command.get("log") or ""})
    except OSError as err:
        _emit({"event": "error", "id": task_id, "code": "zygote_unavailable",
               "message": f"the pool's zygote is unavailable: {err!r}"})


def _task_exited(children: dict, watchers: dict, pid: int, code: int, signal: int,
                 **extra) -> None:
    task_id = children.pop(pid, None)
    if task_id is None:
        return
    if task_id in watchers:
        # Auto-unwatch on exit, after one last pump that flushes the
        # file's tail: a long-lived server must not stat files of finished
        # tasks forever.
        _pump_watchers({task_id: watchers.pop(task_id)})
    _emit({"event": "exit", "id": task_id, "code": code, "signal": signal, **extra})


def _on_zygote_event(event: dict, children: dict, watchers: dict) -> None:
    kind = event.get("event")
    task_id = str(event.get("id") or "")
    if kind == "forked":
        pid = int(event["pid"])
        children[pid] = task_id
        _emit({"event": "started", "id": task_id, "pid": pid})
    elif kind == "fork_error":
        _emit({"event": "error", "id": task_id, "code": event.get("code") or "fork_failed",
               "message": f"the pool's zygote could not fork: {event.get('message')}"})
    elif kind == "exit":
        _task_exited(children, watchers, int(event["pid"]), int(event.get("code", -1)),
                     int(event.get("signal", 0)))


def _kill_task(command: dict, children: dict) -> None:
    target = command.get("id")
    try:
        sig = int(command.get("sig", 15))
    except (TypeError, ValueError):
        sig = 15
    for pid, task_id in list(children.items()):
        if task_id == target:
            # Group AND direct pid: a kill racing the child's setsid()
            # would otherwise miss it.
            for kill in (os.killpg, os.kill):
                try:
                    kill(pid, sig)
                except ProcessLookupError:
                    pass
            _emit({"event": "killed", "id": target})
            return
    _emit({"event": "error", "id": target or "", "message": "unknown task id"})


def _task_inventory(children: dict) -> None:
    _emit({"event": "task_inventory", "pid": os.getpid(), "epoch": _EPOCH["value"],
           "tasks": [{"id": task_id, "pid": pid} for pid, task_id in children.items()]})


#: Per-pump read ceiling: one large telemetry burst must not stall the
#: command loop behind a single read.
_WATCH_READ_LIMIT = 256 * 1024


def _pump_watchers(watchers: dict) -> None:
    """Forward the new complete JSON lines of every watched file.

    Each watcher keeps a byte offset; a partial last line waits for the
    next pump.  Lines that are not JSON objects are dropped (the side-band
    carries structured records only), and a missing file means the task
    has not written yet.
    """
    for task_id, w in list(watchers.items()):
        try:
            size = os.path.getsize(w["path"])
        except OSError:
            continue
        if size < w["pos"]:
            w["pos"], w["buf"] = 0, ""  # truncated or rotated: start over
        if size == w["pos"]:
            continue
        try:
            with open(w["path"], "r", encoding="utf-8", errors="replace") as f:
                f.seek(w["pos"])
                chunk = f.read(_WATCH_READ_LIMIT)
                w["pos"] = f.tell()
        except OSError:
            continue
        w["buf"] += chunk
        while "\n" in w["buf"]:
            line, w["buf"] = w["buf"].split("\n", 1)
            line = line.strip()
            if not line:
                continue
            try:
                data = json.loads(line)
            except ValueError:
                continue
            if isinstance(data, dict):
                _emit({"event": "telemetry", "id": task_id, "data": data})


def _watch(command: dict, watchers: dict) -> None:
    task_id = command.get("id")
    path = command.get("path")
    if not task_id or not path:
        _emit({"event": "error", "id": task_id or "", "message": "watch requires id and path"})
        return
    # Offset 0 on every (re-)watch: a reconnecting dispatcher gets the
    # backlog.
    watchers[task_id] = {"path": path, "pos": 0, "buf": ""}
    _emit({"event": "watching", "id": task_id})


# ---------------------------------------------------------------------------
# Orphan mode and re-adoption (reference harness.py:3056-3300).
#
# A pool server's only channel is the stdin/stdout pipe of the process the
# dispatcher spawned: when the dispatcher dies, the channel dies, while the
# resident sessions (weights on the card, running decodes) live on.  With
# live sessions and ``COVALENT_TPU_ORPHAN_TTL_S`` > 0 the server goes into
# orphan mode instead of exiting: its protocol output goes to /dev/null, a
# unix socket beside this file waits for a successor, ``pool_orphan.json``
# names it, and the sessions keep decoding (each stream's history grows)
# until one ``adopt`` at an epoch no lower than the fence arrives (the
# socket becomes the channel, a fresh banner starts the protocol over) or
# the TTL expires (the sessions drain and the server exits).  Nothing here
# forks: the process holds a CUDA context.
# ---------------------------------------------------------------------------

ORPHAN_RENDEZVOUS = "pool_orphan.json"


def _orphan_dir() -> str:
    """The remote cache: this file runs from its CAS copy
    (``{remote_cache}/cas/<digest>.py``) or from
    ``{remote_cache}/covalent_gpu_harness.py``."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(here) if os.path.basename(here) == "cas" else here


def _orphan_ttl_s() -> float:
    try:
        return float(os.environ.get("COVALENT_TPU_ORPHAN_TTL_S", "0") or 0)
    except (TypeError, ValueError):
        return 0.0


def _set_proto(stream) -> None:
    """Point the protocol channel at ``stream`` (under the emit lock, so
    no message is cut in two) and close the old one."""
    global _PROTO
    with _EMIT_LOCK:
        old, _PROTO = _PROTO, stream
        try:
            old.flush()
        except (OSError, ValueError):
            pass
        try:
            old.close()
        except (OSError, ValueError):
            pass


def _enter_orphan_mode(sel, sessions: dict) -> dict | None:
    """Switch a server whose channel died into the wait for adoption;
    returns the orphan state, or None when orphan mode does not apply (no
    live session, no TTL, or no socket)."""
    import selectors
    import socket

    ttl = _orphan_ttl_s()
    live = sorted(sid for sid, sess in sessions.items() if not sess._closed.is_set())
    if ttl <= 0 or not live:
        return None
    base = _orphan_dir()
    sock_path = os.path.join(base, f"pool_orphan.{os.getpid()}.sock")
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    try:
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        listener.bind(sock_path)
        listener.listen(2)
        listener.setblocking(False)
    except OSError as err:
        print(f"orphan socket failed: {err}", file=sys.stderr)
        return None
    meta = {"pid": os.getpid(), "sock": sock_path, "epoch": _EPOCH["value"],
            "sessions": live, "ttl_s": ttl, "t_orphaned": time.time()}
    rendezvous = os.path.join(base, ORPHAN_RENDEZVOUS)
    tmp = f"{rendezvous}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(meta, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, rendezvous)
    except OSError as err:
        print(f"orphan rendezvous failed: {err}", file=sys.stderr)
        listener.close()
        return None
    # The dead pipe goes quiet: every emitter (session threads included)
    # keeps running, its writes land in /dev/null.
    _set_proto(open(os.devnull, "wb"))
    _BATCHER.flush()
    sel.register(listener, selectors.EVENT_READ, "orphan")
    print(f"orphaned: {len(live)} session(s) wait {ttl:g} s for adoption on {sock_path}",
          file=sys.stderr)
    return {"listener": listener, "sock_path": sock_path, "rendezvous": rendezvous,
            "deadline": time.monotonic() + ttl}


def _orphan_cleanup(sel, orphan: dict) -> None:
    try:
        sel.unregister(orphan["listener"])
    except (KeyError, ValueError):
        pass
    try:
        orphan["listener"].close()
    except OSError:
        pass
    for path in (orphan["sock_path"], orphan["rendezvous"]):
        try:
            os.unlink(path)
        except OSError:
            pass


def _orphan_try_adopt(sel, orphan: dict, sessions: dict) -> bool:
    """Take one adoption attempt; True when the socket became the channel
    (the caller starts the protocol over), False to keep waiting."""
    try:
        conn, _ = orphan["listener"].accept()
    except OSError:
        return False
    try:
        conn.setblocking(True)
        conn.settimeout(10.0)
        data = b""
        while not data.endswith(b"\n") and len(data) < 65536:
            chunk = conn.recv(4096)
            if not chunk:
                break
            data += chunk
        try:
            adopt = json.loads(data.decode("utf-8", "replace"))
        except ValueError:
            adopt = {}
        if not isinstance(adopt, dict):
            adopt = {}
        try:
            epoch = int(adopt.get("epoch") or 0)
        except (TypeError, ValueError):
            epoch = 0
        if adopt.get("cmd") != "adopt" or epoch < _EPOCH["value"]:
            # The fence: a stale dispatcher (or garbage) does not get the
            # sessions; it is answered, and the wait goes on.
            try:
                conn.sendall((json.dumps({
                    "event": "error", "code": "stale_epoch",
                    "message": f"adopt epoch {epoch} < fence {_EPOCH['value']}",
                }) + "\n").encode())
            except OSError:
                pass
            conn.close()
            return False
        _EPOCH["value"] = epoch
        _EPOCH["channel"] = epoch
        conn.settimeout(None)
        fd = conn.fileno()
        os.dup2(fd, 0)
        _set_proto(os.fdopen(os.dup(fd), "wb"))
        # the adopted channel starts on JSON lines; the successor
        # negotiates frames off the fresh banner as any client does
        _FRAMES["out"] = False
        _FRAMES["codec"] = ""
        conn.close()  # fds 0 and the protocol stream hold the socket now
    except OSError:
        try:
            conn.close()
        except OSError:
            pass
        return False
    _orphan_cleanup(sel, orphan)
    banner = {"event": "ready", "pid": os.getpid(), "mode": "pool", "reattach": True,
              "epoch": epoch,
              "sessions": sorted(sid for sid, sess in sessions.items()
                                 if not sess._closed.is_set())}
    if _frames_enabled():
        banner["frames"] = _FRAME_VERSION
        banner["codecs"] = ["zlib"]
    _emit(banner)
    print(f"adopted at epoch {epoch}", file=sys.stderr)
    return True


def attach_relay(sock_path: str) -> int:
    """``harness.py --attach <sock>``: bridge stdio onto an orphan's socket.

    A successor dispatcher cannot dial a unix socket on a remote worker,
    but it can start processes there, so adoption rides the road a fresh
    pool server takes: the transport starts this relay, which pumps its
    stdin to the socket and the socket to its stdout.  The adopt line, the
    fence and the banner all pass through verbatim."""
    import select as select_mod
    import socket

    try:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(sock_path)
    except OSError as err:
        sys.stdout.write(json.dumps({"event": "error", "code": "attach_failed",
                                     "message": f"connect {sock_path}: {err}"}) + "\n")
        sys.stdout.flush()
        return 3
    sock.setblocking(True)
    sfd = sock.fileno()

    def write_all(fd: int, data: bytes) -> bool:
        while data:
            try:
                n = os.write(fd, data)
            except OSError:
                return False
            data = data[n:]
        return True

    try:
        while True:
            ready, _, _ = select_mod.select([0, sfd], [], [])
            if 0 in ready:
                data = os.read(0, 65536)
                if not data:
                    break  # the dispatcher hung up: the orphan waits again
                try:
                    sock.sendall(data)
                except OSError:
                    break
            if sfd in ready:
                data = sock.recv(65536)
                if not data:
                    break  # the server closed (refused, or exited)
                if not write_all(1, data):
                    break
    finally:
        try:
            sock.close()
        except OSError:
            pass
    return 0


def _announce_preemption(sessions: dict, reason: str = "sigterm") -> None:
    """Emit ``serve.preempt`` on every live session's side-band."""
    for session in list(sessions.values()):
        try:
            session._emit_serve("serve.preempt", reason=reason)
        except Exception:  # noqa: BLE001 - the notice is best-effort
            pass
    try:
        _BATCHER.flush()
    except Exception:  # noqa: BLE001
        pass


def _install_serve_preempt_notice(sessions: dict) -> None:
    """SIGTERM on a server with live sessions is the spot preemption
    notice: announce ``serve.preempt`` on every session and keep serving.
    The dispatcher's supervisor hands the sessions off to a fresh server
    inside the grace window; the preempter's hard kill (or the channel's
    death) ends this process, not the notice.  With no session, SIGTERM
    ends the process as before."""
    import signal

    def on_term(signum, frame):
        if not any(not sess._closed.is_set() for sess in sessions.values()):
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)
            return
        # Never write the channel from the handler: it runs on the main
        # thread, which may hold the emit lock at delivery.  A helper
        # thread takes the lock as any emitter does.
        threading.Thread(target=_announce_preemption, args=(sessions,),
                         name="covalent-gpu-preempt-notice", daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, on_term)
    except (ValueError, OSError):  # pragma: no cover - not the main thread
        pass


def serve() -> int:
    """The pool server's command loop (see the protocol above).

    Protocol lines go to a copy of the original stdout; fd 1 is pointed at
    stderr before any module is preloaded or user code runs.  The zygote
    starts first, then this process imports ``COVALENT_TPU_POOL_PRELOAD``
    (comma-separated, default ``cloudpickle``; the zygote imports the same),
    so the two cold starts overlap.  When stdin closes or ``shutdown``
    arrives the server exits, and its sessions and invocations with it (a
    reconnecting dispatcher re-opens them on a fresh server); forked tasks
    run on, and the zygote exits after them.  With live sessions and
    ``COVALENT_TPU_ORPHAN_TTL_S`` > 0 a closed stdin means orphan mode
    instead (see above); SIGTERM with live sessions is the preemption
    notice.
    """
    global _PROTO
    import selectors

    _PROTO = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sel = selectors.DefaultSelector()
    sel.register(0, selectors.EVENT_READ, "stdin")
    zygote_proc = _Zygote(os.path.abspath(__file__), sel)
    zygote_proc.start()
    _preload()

    sessions: dict = {}
    _install_serve_preempt_notice(sessions)
    #: the orphan state while the TTL runs, None otherwise
    orphan: dict | None = None
    #: pid -> task id of every forked task still running
    children: dict = {}
    #: task id -> {"path", "pos", "buf"}: telemetry files tailed (watch)
    watchers: dict = {}
    #: digest -> unpickled function (register_fn); dies with the process,
    #: the lifetime the dispatcher's per-connection registry mirrors
    registry: dict = {}
    buffer = bytearray()
    banner: dict = {"event": "ready", "pid": os.getpid(), "mode": "pool"}
    if _frames_enabled():
        # the capability: the client answers with a frames command, or
        # stays on JSON lines
        banner["frames"] = _FRAME_VERSION
        banner["codecs"] = ["zlib"]
    _emit(banner)
    try:
        while True:
            tick = 0.25 if (watchers or orphan is not None) else None
            for key, _ in sel.select(timeout=tick):
                if key.data == "zygote":
                    events = zygote_proc.read()
                    if events is None:
                        # The zygote died: its children were re-parented and
                        # their exits cannot be seen from here.  Each ends
                        # with ``lost``; the dispatcher reads its status
                        # from the task's own files.
                        print("the pool's zygote exited; the next run starts another",
                              file=sys.stderr)
                        for pid in list(children):
                            _task_exited(children, watchers, pid, -1, 0, lost=True)
                        continue
                    for event in events:
                        _on_zygote_event(event, children, watchers)
                    continue
                if key.data == "orphan":
                    if orphan is not None and _orphan_try_adopt(sel, orphan, sessions):
                        # the socket is the channel now: the protocol starts
                        # over on it (stale inbound bytes dropped)
                        orphan = None
                        buffer.clear()
                        sel.register(0, selectors.EVENT_READ, "stdin")
                    continue
                data = os.read(0, 65536)
                if not data:
                    sel.unregister(0)
                    orphan = _enter_orphan_mode(sel, sessions)
                    if orphan is None:
                        return 0  # channel dropped
                    continue
                buffer.extend(data)
                for command in _extract_commands(buffer):
                    name = command.get("cmd")
                    if name == "ping":
                        _emit({"event": "pong"})
                    elif name == "frames":
                        _handle_frames_cmd(command)
                    elif name == "epoch":
                        _handle_epoch_cmd(command)
                    elif name == "serve_inventory":
                        _serve_inventory(sessions)
                    elif name == "task_inventory":
                        _task_inventory(children)
                    elif name in _FENCED_CMDS and not _epoch_ok():
                        _refuse_stale(name, command)
                    elif name == "serve_resume":
                        _serve_resume(command, sessions)
                    elif name == "run":
                        _spawn_task(command, zygote_proc)
                    elif name == "register_fn":
                        _rpc_register(command, registry)
                    elif name == "invoke":
                        _rpc_invoke(command, registry)
                    elif name == "multi_invoke":
                        _rpc_multi_invoke(command, registry)
                    elif name == "serve_open":
                        _serve_open(command, sessions)
                    elif name == "serve_request":
                        _serve_request(command, sessions)
                    elif name == "serve_prefill":
                        _serve_prefill(command, sessions)
                    elif name == "serve_cancel":
                        _serve_cancel(command, sessions)
                    elif name == "serve_close":
                        _serve_close(command, sessions)
                    elif name == "profile_start":
                        _profile_start(command, sessions)
                    elif name == "profile_stop":
                        _profile_stop(command)
                    elif name == "kill":
                        _kill_task(command, children)
                    elif name == "watch":
                        _watch(command, watchers)
                    elif name == "unwatch":
                        task_id = command.get("id")
                        watchers.pop(task_id, None)
                        _emit({"event": "unwatched", "id": task_id or ""})
                    elif name == "shutdown":
                        _emit({"event": "bye"})
                        return 0
                    elif name in ("serve_attach", "serve_detach"):
                        _serve_attach(command, sessions)
                    else:
                        _emit({"event": "error", "message": f"unknown cmd: {name}"})
            if orphan is not None and time.monotonic() >= orphan["deadline"]:
                # the TTL is spent with no successor: drain and exit rather
                # than hold the model's memory on the card for ever
                _orphan_cleanup(sel, orphan)
                print("orphan TTL spent: draining and exiting", file=sys.stderr)
                for session in list(sessions.values()):
                    session.close()
                return 0
            _pump_watchers(watchers)
    finally:
        zygote_proc.close()


def _runner_channel(argv: list[str]) -> None:
    """Set a runner's channel up: protocol lines go to a copy of the
    original stdout and fd 1 points at stderr (the agent discards a
    runner's stderr), so a torch or CUDA warning, a kernel build's output
    or a factory's ``print`` never lands in the protocol; ``--log <path>``
    after the mode appends stderr to that file instead."""
    global _PROTO
    _PROTO = os.fdopen(os.dup(1), "wb")
    if len(argv) >= 4 and argv[2] == "--log":
        try:
            fd = os.open(argv[3], os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        except OSError:
            pass
        else:
            os.dup2(fd, 2)
            os.close(fd)
    os.dup2(2, 1)


def rpc_child(argv: list[str]) -> int:
    """``harness.py --rpc-child [--log <path>]``: one invocation, the
    command on stdin (reference: harness.py:1607-1640).

    The native agent forks this runner per ``invoke``, pipes the command
    (which carries the function's CAS ``path``: the runner loads and checks
    it, then runs it on this thread) and closes the pipe; the runner's
    ``started``, side-band records and ``result`` go back over the agent's
    channel verbatim.  A fresh interpreter per invocation: slower than the
    pool's warm loop, with the same protocol."""
    _runner_channel(argv)
    buffer = bytearray()
    saw_bytes = False
    while True:
        for command in _extract_commands(buffer):
            if command.get("cmd") == "frames":
                # the agent announces the channel's frame mode first
                _handle_frames_cmd(command)
                continue
            _rpc_invoke(command, {}, sync=True)
            _BATCHER.flush()
            return 0
        data = sys.stdin.buffer.read1(65536)
        if not data:
            break
        saw_bytes = True
        buffer.extend(data)
    if saw_bytes:
        _emit({"event": "error", "message": "malformed invoke command"})
        return 1
    print("usage: harness.py --rpc-child  (invoke command on stdin)", file=sys.stderr)
    return 2


def serve_child(argv: list[str]) -> int:
    """``harness.py --serve-child [--log <path>]``: one serving session over
    stdin (reference: harness.py:3353-3400).

    The native agent forks this runner at ``serve_open`` with its stdin
    held open, forwards the session's commands to it (requests, cancels,
    prefills, resumes, the inventory, the profile verbs, the close) and
    streams its events back verbatim.  The close, or EOF, ends the
    session: its requests drain first."""
    _runner_channel(argv)
    sessions: dict = {}
    _install_serve_preempt_notice(sessions)
    opened: list = []  # every session ever opened, for the final drain
    buffer = bytearray()
    closing = False
    while not closing:
        for command in _extract_commands(buffer):
            name = command.get("cmd")
            if name == "frames":
                _handle_frames_cmd(command)
            elif name == "serve_open":
                _serve_open(command, sessions)
                session = sessions.get(str(command.get("id") or ""))
                if session is not None and session not in opened:
                    opened.append(session)
            elif name == "serve_request":
                _serve_request(command, sessions)
            elif name == "serve_cancel":
                _serve_cancel(command, sessions)
            elif name == "serve_resume":
                _serve_resume(command, sessions)
            elif name == "serve_inventory":
                _serve_inventory(sessions)
            elif name == "serve_prefill":
                _serve_prefill(command, sessions)
            elif name == "profile_start":
                _profile_start(command, sessions)
            elif name == "profile_stop":
                _profile_stop(command)
            elif name == "serve_close":
                _serve_close(command, sessions)
                closing = True
                break
            elif name in ("serve_attach", "serve_detach"):
                _serve_attach(command, sessions)
            else:
                _emit({"event": "error", "message": f"unknown cmd: {name}"})
        if closing:
            break
        data = sys.stdin.buffer.read1(65536)
        if not data:
            break  # EOF closes the session
        buffer.extend(data)
    for session in sessions.values():
        session.close()
    for session in opened:
        session._thread.join()
    with _PROFILE_LOCK:
        stopping = bool(_PROFILE_ACTIVE.get("stopping"))
    if stopping:
        # a trace being packed finishes before the process goes
        for thread in threading.enumerate():
            if thread.name == "covalent-gpu-profiler":
                thread.join(timeout=120.0)
    return 0


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[1] == "--serve":
        return serve()
    if len(argv) == 2 and argv[1] == "--zygote":
        return zygote()
    if len(argv) >= 2 and argv[1] == "--rpc-child":
        return rpc_child(argv)
    if len(argv) >= 2 and argv[1] == "--serve-child":
        return serve_child(argv)
    if len(argv) >= 3 and argv[1] == "--attach":
        return attach_relay(argv[2])
    if len(argv) != 2:
        print("usage: harness.py <task_spec.json> | --serve | --rpc-child | --serve-child "
              "| --attach <socket>", file=sys.stderr)
        return 2
    # Become a session/process-group leader: a kill of `-- -pid` then reaches
    # the electron's own subprocesses too.
    try:
        os.setsid()
    except OSError:
        pass  # already a leader
    with open(argv[1]) as f:
        spec = json.load(f)
    return run_task(spec)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
