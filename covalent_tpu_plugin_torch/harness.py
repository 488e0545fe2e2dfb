"""Worker-side bootstrap: ``python harness.py <task_spec.json>`` or
``python harness.py --serve``.

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
  JSON-lines protocol on stdin/stdout and hosts resident serving sessions
  in its own process (see :func:`serve`).
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
# Sessions run in this process on their own threads; nothing here forks (a
# process that has touched the card cannot hand CUDA to a forked child).
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
    "run": "slice 5 (the pool's run verb, which must spawn, not fork)",
    "kill": "slice 5 (the pool's run verb, which must spawn, not fork)",
    "watch": "slice 5 (the pool's run verb, which must spawn, not fork)",
    "unwatch": "slice 5 (the pool's run verb, which must spawn, not fork)",
    "task_inventory": "slice 5 (the pool's run verb, which must spawn, not fork)",
    "register_fn": "slice 5 (RPC dispatch)",
    "invoke": "slice 5 (RPC dispatch)",
    "multi_invoke": "slice 5 (RPC dispatch)",
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


def serve() -> int:
    """The pool server's command loop (see the protocol above).

    Protocol lines go to a copy of the original stdout; fd 1 is pointed at
    stderr before any module is preloaded or user code runs.  Modules named
    in ``COVALENT_TPU_POOL_PRELOAD`` (comma-separated, default
    ``cloudpickle``) are imported once up front.  When stdin closes or
    ``shutdown`` arrives the server exits, and its sessions with it: a
    reconnecting dispatcher re-opens them on a fresh server.
    """
    global _PROTO
    _PROTO = os.fdopen(os.dup(1), "w", encoding="utf-8")
    os.dup2(2, 1)
    for mod in filter(None, os.environ.get("COVALENT_TPU_POOL_PRELOAD", "cloudpickle")
                      .split(",")):
        try:
            __import__(mod.strip())
        except Exception as preload_error:  # noqa: BLE001 - sessions retry the import
            print(f"preload {mod} failed: {preload_error}", file=sys.stderr)

    sessions: dict = {}
    buffer = bytearray()
    _emit({"event": "ready", "pid": os.getpid(), "mode": "pool"})
    while True:
        data = os.read(0, 65536)
        if not data:
            break  # channel dropped
        buffer.extend(data)
        for command in _extract_commands(buffer):
            name = command.get("cmd")
            if name == "ping":
                _emit({"event": "pong"})
            elif name == "frames":
                _emit({"event": "frames", "version": 0})  # JSON lines only
            elif name == "serve_open":
                _serve_open(command, sessions)
            elif name == "serve_request":
                _serve_request(command, sessions)
            elif name == "serve_cancel":
                _serve_cancel(command, sessions)
            elif name == "serve_close":
                _serve_close(command, sessions)
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
    return 0


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[1] == "--serve":
        return serve()
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
