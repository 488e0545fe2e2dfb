"""Worker-side bootstrap: ``python harness.py <task_spec.json>``,
``python harness.py --serve`` or ``python harness.py --zygote``.

Counterpart of ``covalent_tpu_plugin/harness.py``.  The executor ships this
one file to the worker (it imports nothing of the package).

* **Launch mode** (``harness.py <spec>``), run detached: it applies the
  task's environment, installs its pip dependencies, unpickles ``(fn, args,
  kwargs)``, runs the electron, moves tensors in the result to host memory,
  and writes ``(result, exception, times)`` back as a pickle, which the
  dispatcher fetches; ``times`` holds the electron's own ``start`` and
  ``end`` (unix seconds), which the dispatcher's ``execute`` stage reads.
  Optionally it traces the electron with ``torch.profiler``.  The spec keys
  of later slices (the distributed bootstrap, heartbeats, the checkpointer,
  resume) are refused: the electron does not run, and the error comes back
  as its exception.
* **Resident mode** (``harness.py --serve``): the pool server.  It speaks a
  JSON-lines protocol on stdin/stdout, hosts resident serving sessions and
  RPC invocations in its own process, and runs launch-mode specs (``run``)
  as forks of its zygote (see :func:`serve`).
* **Zygote** (``harness.py --zygote``): the pool server's fork helper, a
  single-threaded process that has imported the preloads but never
  initialised CUDA (see :func:`zygote`).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

#: spec keys this harness understands
_SPEC_KEYS = {
    "operation_id", "function_file", "result_file", "workdir", "pid_file",
    "env", "profile_dir", "pip_deps",
}


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


def run_task(spec: dict) -> int:
    """Execute one staged task described by ``spec``.  Returns the exit code."""
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
            f"task spec keys {unsupported} are not supported by this harness yet"
        ))
        return 1

    try:
        _apply_spec_env(spec)
        # Before the function pickle is loaded: unpickling may import the
        # dependency (reference ct.DepsPip, svm_workflow.py:6,19).
        if spec.get("pip_deps"):
            install_pip_deps(spec["pip_deps"])
        import cloudpickle as pickle
    except (ImportError, RuntimeError) as setup_error:
        _fallback_result(result_file, setup_error)
        return 1

    with open(spec["function_file"], "rb") as f:
        fn, args, kwargs = pickle.load(f)

    profile_dir = spec.get("profile_dir")
    profiler = _start_profiler(profile_dir) if profile_dir else None

    workdir = spec.get("workdir")
    current_dir = os.getcwd()
    result, exception = None, None
    started = time.time()
    try:
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            os.chdir(workdir)
        result = _to_host(fn(*args, **kwargs))
    except Exception as task_error:  # noqa: BLE001 - transported to dispatcher
        exception = task_error
    finally:
        ended = time.time()
        os.chdir(current_dir)
        if profiler is not None:
            _stop_profiler(profiler, profile_dir)

    tmp = result_file + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump((result, exception, {"start": started, "end": ended}), f)
    os.replace(tmp, result_file)
    return 0


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
#    "deadline_s":s}                                -> telemetry records below
#   {"cmd":"serve_cancel","id":sid,"rid":rid}        (no answer: the stream's
#                                                     terminal record)
#   {"cmd":"serve_close","id":sid}                  -> {"event":"serve_closed",
#                                                       "id","served"} after the
#                                                       drain
#   {"cmd":"frames",...}                            -> {"event":"frames",
#                                                       "version":0}
#   {"cmd":"shutdown"}                              -> {"event":"bye"}
#
# A session streams {"event":"telemetry","id":sid,"data":record}, one line a
# record; each record carries ts/pid/a per-process seq/type: ``serve.token``
# (rid, cumulative ``idx`` of the chunk's first token, tokens, done[, error]),
# ``serve.reject`` (rid, code, message) and ``serve.stats``.  The reference's
# runtime also batches records into binary frames; this one advertises no
# frames, so the channel stays on these lines.
#
# Verbs of later items are refused with an ``error`` event naming the item.
#
# Sessions and RPC invocations run in this process on their own threads,
# and share its one CUDA context.  This process is never forked: once it
# has touched the card (a session or an RPC electron initialises CUDA), a
# forked child could not use CUDA.  ``run`` forks from the zygote instead,
# a helper this server spawns once, which imports the same preloads and
# never initialises CUDA.
# ---------------------------------------------------------------------------

#: Verbs of the reference's runtime that this one refuses, and what brings them.
_LATER_VERBS = {
    "serve_prefill": "ROADMAP item 2c (the disaggregated set)",
    "serve_attach": "slice 3 (LoRA) and ROADMAP item 2c",
    "serve_detach": "slice 3 (LoRA) and ROADMAP item 2c",
    "serve_resume": "ROADMAP item 2c (recovery)",
    "serve_inventory": "ROADMAP item 2c (recovery)",
    "epoch": "ROADMAP item 2c (recovery)",
    "adopt": "ROADMAP item 2c (recovery)",
    "profile_start": "ROADMAP item 2c (serving metrics and tracing)",
    "profile_stop": "ROADMAP item 2c (serving metrics and tracing)",
    # the reference's client sends it only in binary frames
    "multi_invoke": "ROADMAP item 2c.1 (binary frames and invoke micro-batching)",
}

#: Command-line modes of the reference's harness that this one refuses.
_LATER_MODES = {
    "--rpc-child": "ROADMAP item 2c.6 (the native agent's one-shot RPC runner)",
    "--serve-child": "ROADMAP item 2c.6 (the native agent's serving runner)",
    "--attach": "ROADMAP item 2c.4 (recovery: orphan adoption)",
}

#: Per-process record sequence: the dispatcher drops a record whose seq is
#: not above the last one it saw for the same id.
_worker_event_seq = 0
_worker_event_lock = threading.Lock()


def _build_worker_event(spec: dict, type: str, **fields) -> dict:
    """One worker record: the ts/pid/seq envelope plus ``fields``."""
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
    event.update(fields)
    return event


#: The protocol channel: a file over a copy of the original stdout.
#: :func:`serve` points fd 1 at stderr, so a ``print`` in a factory or a
#: compiler's output cannot land inside a protocol line.
_PROTO = sys.stdout
#: Serializes protocol writes: the command loop and every session thread
#: share the one channel.
_EMIT_LOCK = threading.Lock()


def _emit(obj: dict) -> None:
    with _EMIT_LOCK:
        try:
            _PROTO.write(json.dumps(obj) + "\n")
            _PROTO.flush()
        except (OSError, ValueError):
            pass  # dead channel: the sessions' threads must not die of it


def _extract_commands(buffer: bytearray) -> list:
    """Every complete JSON line in ``buffer`` (consumed in place; a partial
    line stays buffered).  A line that is not a JSON object is answered
    with an ``error`` event and skipped."""
    commands: list = []
    while True:
        nl = buffer.find(b"\n")
        if nl < 0:
            return commands
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
        #: rid -> {"deadline": abs monotonic | None, "emitted": n, "t_admit"}
        self.running: dict = {}
        #: rids accepted into the queue and not yet admitted or refused.
        self.queued: set = set()
        #: rids a ``serve_cancel`` asked to kill, drained on the session
        #: thread (running lane -> engine cancel + terminal record;
        #: queued -> skipped at admission).
        self.cancels: set = set()
        self._cancel_lock = threading.Lock()
        self._cancelled_pending: set = set()
        self.slots = 1
        self.served = 0
        self.tokens_total = 0
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
        self.queue.put(command)

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
        """One session record over the telemetry side-band, one line each."""
        _emit({"event": "telemetry", "id": self.sid,
               "data": _build_worker_event(self.spec, type, rpc=True, **fields)})

    def _emit_reject(self, rid: str, code: str, message: str) -> None:
        self._emit_serve("serve.reject", rid=rid, code=code, message=message)

    def _emit_terminal(self, rid: str, idx: int, error: str) -> None:
        """A stream's last record with no tokens: cancelled or out of time."""
        self._emit_serve("serve.token", rid=rid, idx=idx, tokens=[], done=True, error=error)

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
            try:
                self._engine.admit(rid, command.get("prompt"),
                                   dict(command.get("params") or {}))
            except BaseException as err:  # noqa: BLE001 - rejections
                self._emit_reject(rid, "engine_error", repr(err))
                continue
            self.running[rid] = {
                "deadline": command["_enqueued"] + deadline_s if deadline_s > 0 else None,
                "emitted": 0,
                "t_admit": time.monotonic(),
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
        state = self.running.pop(rid)
        self._emit_terminal(rid, state["emitted"], error)
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
        """One decode chunk for every busy lane; stream the fresh tokens."""
        try:
            events = self._engine.step() or []
        except BaseException as err:  # noqa: BLE001 - an engine crash fails all
            for rid in list(self.running):
                self._emit_reject(rid, "engine_error", repr(err))
                self._cancel_lane(rid)
                self.running.pop(rid, None)
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
            idx = state["emitted"]
            state["emitted"] += len(tokens)
            self.tokens_total += len(tokens)
            self._emit_serve("serve.token", rid=rid, idx=idx, tokens=tokens, done=done,
                             **extra)
            if done:
                self.served += 1
                self.running.pop(rid, None)
        # A lane past its deadline is cancelled and closed with an error
        # marker, freeing the slot.
        now = time.monotonic()
        for rid, state in list(self.running.items()):
            if state["deadline"] is not None and now >= state["deadline"]:
                self._end_lane(rid, "deadline_exceeded")

    def _loop(self) -> None:
        if not self._open_engine():
            return
        last_stats = time.monotonic()
        try:
            while not (self._closed.is_set() and not self.running and self.queue.empty()):
                self._drain_cancels()
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
            _emit({"event": "serve_closed", "id": self.sid, "served": self.served})


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
    """``(args, kwargs)`` of an invoke: inline base64, or a CAS path whose
    bytes are digest-verified before they are unpickled (the guard the
    function pickle gets)."""
    import base64

    import cloudpickle

    b64 = command.get("args")
    if b64 is not None:
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
    base64-inline; a larger one is written (atomically) to the command's
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
    _emit({"event": "result", "id": task_id, "ok": exception is None,
           "data": base64.b64encode(data).decode("ascii")})


def _emit_rpc_event(spec: dict, task_id: str, type: str, **fields) -> None:
    """One worker record, pushed over the channel with the ``rpc`` marker
    (it lands in no file a launch-mode worker would write)."""
    _emit({"event": "telemetry", "id": task_id,
           "data": _build_worker_event(spec, type, rpc=True, **fields)})


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
    _emit_rpc_result(task_id, result, exception, {"start": started, "end": ended}, command)
    _emit_rpc_event(
        spec, task_id, "worker.task_finished", process_id=0, ok=exception is None,
        **({"error": repr(exception)} if exception is not None else {}),
    )


def _rpc_invoke(command: dict, registry: dict) -> None:
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
    threading.Thread(target=_run_rpc_task, args=(command, fn),
                     name=f"covalent-gpu-rpc-{task_id}", daemon=True).start()


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

    _PROTO = os.fdopen(os.dup(1), "w", encoding="utf-8")
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
    # The reference adds its epoch fence's value; the fence comes with
    # ROADMAP item 2c.4.
    _emit({"event": "task_inventory", "pid": os.getpid(),
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


def serve() -> int:
    """The pool server's command loop (see the protocol above).

    Protocol lines go to a copy of the original stdout; fd 1 is pointed at
    stderr before any module is preloaded or user code runs.  The zygote
    starts first, then this process imports ``COVALENT_TPU_POOL_PRELOAD``
    (comma-separated, default ``cloudpickle``; the zygote imports the same),
    so the two cold starts overlap.  When stdin closes or ``shutdown``
    arrives the server exits, and its sessions and invocations with it (a
    reconnecting dispatcher re-opens them on a fresh server); forked tasks
    run on, and the zygote exits after them.
    """
    global _PROTO
    import selectors

    _PROTO = os.fdopen(os.dup(1), "w", encoding="utf-8")
    os.dup2(2, 1)
    sel = selectors.DefaultSelector()
    sel.register(0, selectors.EVENT_READ, "stdin")
    zygote_proc = _Zygote(os.path.abspath(__file__), sel)
    zygote_proc.start()
    _preload()

    sessions: dict = {}
    #: pid -> task id of every forked task still running
    children: dict = {}
    #: task id -> {"path", "pos", "buf"}: telemetry files tailed (watch)
    watchers: dict = {}
    #: digest -> unpickled function (register_fn); dies with the process,
    #: the lifetime the dispatcher's per-connection registry mirrors
    registry: dict = {}
    buffer = bytearray()
    _emit({"event": "ready", "pid": os.getpid(), "mode": "pool"})
    try:
        while True:
            for key, _ in sel.select(timeout=0.25 if watchers else None):
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
                data = os.read(0, 65536)
                if not data:
                    return 0  # channel dropped
                buffer.extend(data)
                for command in _extract_commands(buffer):
                    name = command.get("cmd")
                    if name == "ping":
                        _emit({"event": "pong"})
                    elif name == "frames":
                        _emit({"event": "frames", "version": 0})  # JSON lines only
                    elif name == "task_inventory":
                        _task_inventory(children)
                    elif name == "run":
                        _spawn_task(command, zygote_proc)
                    elif name == "register_fn":
                        _rpc_register(command, registry)
                    elif name == "invoke":
                        _rpc_invoke(command, registry)
                    elif name == "serve_open":
                        _serve_open(command, sessions)
                    elif name == "serve_request":
                        _serve_request(command, sessions)
                    elif name == "serve_cancel":
                        _serve_cancel(command, sessions)
                    elif name == "serve_close":
                        _serve_close(command, sessions)
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
                    elif name in _LATER_VERBS:
                        _emit({"event": "error", "id": str(command.get("id") or ""),
                               "code": "not_ported",
                               "message": f"{name} is not ported yet: it comes with "
                                          f"{_LATER_VERBS[name]}"})
                    else:
                        _emit({"event": "error", "message": f"unknown cmd: {name}"})
            _pump_watchers(watchers)
    finally:
        zygote_proc.close()


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[1] == "--serve":
        return serve()
    if len(argv) == 2 and argv[1] == "--zygote":
        return zygote()
    if len(argv) >= 2 and argv[1] in _LATER_MODES:
        print(f"harness.py {argv[1]} is not ported yet: it comes with "
              f"{_LATER_MODES[argv[1]]}", file=sys.stderr)
        return 2
    if len(argv) != 2:
        print("usage: harness.py <task_spec.json> | --serve", file=sys.stderr)
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
