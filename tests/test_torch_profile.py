"""Resident profiling on ``torch.profiler``, on the CPU.

The protocol first, on raw runtimes: one script of profile verbs goes to
the reference's and the port's pool servers (``harness.py --serve``) and
to both ``--serve-child`` runners, and the answers must agree, pids, paths,
digests and messages masked (``bad_request``, ``not_running``, ``busy``,
``unknown_session``, a started, a stopped and a discarded trace).  On the
port's side: the trace is one ``<sha256>.profile.tgz`` whose name is its
digest, a launch-mode ``profile_dir`` is refused while a resident trace
runs, and a ``--serve-child`` announces its packed trace before it exits
(the reference's runner exits first, and its trace is never announced).
Then the dispatcher: one pool-mode ``GPUExecutor`` serves a stub session
while ``ServeHandle.capture_profile`` and ``GPUExecutor.capture_profile``
trace it, a profiled RPC electron stays on the RPC road with its trace in
``last_timings``, a torn artifact is refused by its digest, and a
runtime-less executor captures nothing.
"""

import asyncio
import hashlib
import json
import subprocess
import sys
import tarfile
import threading
from pathlib import Path

import cloudpickle
import pytest

from covalent_tpu_plugin_torch import GPUExecutor
from covalent_tpu_plugin_torch import harness as port_harness
from covalent_tpu_plugin_torch.obs import events as obs_events
from covalent_tpu_plugin_torch.serving import ServeError, open_session

from .test_torch_session import make_factory
from .test_torch_session_protocol import RUNTIMES, Runtime, is_event, is_record

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 60.0
PROFILE_IDS = ("p0", "ps", "p1", "p2", "p3")
#: Fields whose values are each process's own.
MASKED = ("pid", "path", "digest", "bytes", "message")


def profile_event(kind, pid):
    return lambda e: e.get("event") == kind and e.get("id") == pid


def sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def members(path: Path) -> list:
    with tarfile.open(path, "r:gz") as tar:
        return sorted(m.name for m in tar.getmembers() if m.isfile())


def masked(events: list) -> list:
    return [{k: "*" if k in MASKED else v for k, v in e.items()} for e in events]


def on_both(drive) -> dict:
    """``drive(name)`` for each runtime at once, in threads; name -> its result."""
    out, errors = {}, {}

    def run(name):
        try:
            out[name] = drive(name)
        except BaseException as err:  # noqa: BLE001 - reported below
            errors[name] = err

    threads = [threading.Thread(target=run, args=(name,)) for name in RUNTIMES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return out


# ---------------------------------------------------------------------------
# The protocol on the pool server
# ---------------------------------------------------------------------------


def run_pool_script(rt: Runtime, root: Path) -> None:
    rt.wait(is_event("ready"))
    rt.send({"cmd": "profile_start", "id": "p0"})                 # no dir
    rt.wait(profile_event("profile_error", "p0"))
    rt.send({"cmd": "profile_stop", "id": "p0"})                  # nothing runs
    rt.wait(lambda e: sum(1 for x in rt.events if x.get("id") == "p0") >= 2)
    rt.send({"cmd": "profile_start", "id": "ps", "dir": str(root / "t"), "sid": "nobody"})
    rt.wait(profile_event("profile_error", "ps"))
    rt.send({"cmd": "profile_start", "id": "p1", "dir": str(root / "trace1")})
    rt.wait(profile_event("profile_started", "p1"))
    rt.send({"cmd": "profile_start", "id": "p2", "dir": str(root / "trace2")})  # busy
    rt.wait(profile_event("profile_error", "p2"))
    rt.send({"cmd": "profile_stop", "id": "p2"})                  # not the active one
    rt.wait(lambda e: sum(1 for x in rt.events if x.get("id") == "p2") >= 2)
    rt.send({"cmd": "profile_stop", "id": "p1", "artifact_dir": str(root / "cas")})
    rt.wait(profile_event("profile_stopped", "p1"))
    rt.send({"cmd": "profile_start", "id": "p3", "dir": str(root / "trace3")})
    rt.wait(profile_event("profile_started", "p3"))
    rt.send({"cmd": "profile_stop", "id": "p3", "discard": True})
    rt.wait(profile_event("profile_stopped", "p3"))
    rt.send({"cmd": "shutdown"})
    rt.wait(is_event("bye"))


@pytest.fixture(scope="module")
def pool_scripts(tmp_path_factory):
    """The script on the reference's and the port's pool servers at once:
    name -> (its directory, its answers by profile id)."""
    roots = {name: tmp_path_factory.mktemp(f"pool_profile_{name}") for name in RUNTIMES}

    def drive(name):
        rt = Runtime(RUNTIMES[name], roots[name])
        try:
            run_pool_script(rt, roots[name])
        finally:
            rt.close()
        return roots[name], {pid: [e for e in rt.events if e.get("id") == pid]
                             for pid in PROFILE_IDS}

    return on_both(drive)


@pytest.fixture(scope="module")
def pool_script(pool_scripts):
    return pool_scripts["port"]


def test_the_pool_server_answers_the_profile_script_like_the_reference(pool_scripts):
    (_, ref), (_, port) = pool_scripts["reference"], pool_scripts["port"]
    for pid in PROFILE_IDS:
        assert masked(port[pid]) == masked(ref[pid]), pid


def test_profile_verbs_refuse_with_the_reference_codes(pool_script):
    _, events = pool_script
    assert [(e["event"], e.get("code")) for e in events["p0"]] == [
        ("profile_error", "bad_request"), ("profile_error", "not_running")]
    assert [(e["event"], e.get("code")) for e in events["ps"]] == [
        ("profile_error", "unknown_session")]
    assert [(e["event"], e.get("code")) for e in events["p2"]] == [
        ("profile_error", "busy"), ("profile_error", "not_running")]


def test_a_stopped_trace_is_one_artifact_named_by_its_digest(pool_script):
    root, events = pool_script
    started, stopped = events["p1"]
    assert started["event"] == "profile_started" and started["pid"] > 0
    path = Path(stopped["path"])
    assert path.parent == root / "cas"
    assert path.name == f"{stopped['digest']}.profile.tgz"
    assert sha256(path) == stopped["digest"] and path.stat().st_size == stopped["bytes"]
    assert members(path) == ["./trace.json"]
    assert not (root / "trace1").exists()  # the raw trace is consumed


def test_a_discarded_trace_leaves_nothing(pool_script):
    root, events = pool_script
    assert events["p3"][-1] == {"event": "profile_stopped", "id": "p3", "discarded": True}
    assert not (root / "trace3").exists()


def test_a_launch_mode_trace_waits_for_a_resident_one(capsys):
    """One profiler per process: ``profile_dir`` in a process whose
    resident trace runs is refused (the electron runs unprofiled)."""
    with port_harness._PROFILE_LOCK:
        port_harness._PROFILE_ACTIVE.update({"id": "resident", "dir": "/nowhere"})
    try:
        assert port_harness._claim_profiler("launch-op", "/elsewhere") is False
        assert "busy" in capsys.readouterr().err
    finally:
        port_harness._PROFILE_ACTIVE.clear()
    assert port_harness._claim_profiler("launch-op", "/elsewhere") is True
    port_harness._PROFILE_ACTIVE.clear()


# ---------------------------------------------------------------------------
# The protocol in a --serve-child (the native agent's session runner)
# ---------------------------------------------------------------------------


def test_a_serve_child_profiles_its_session_and_keeps_stdout_for_the_protocol(tmp_path):
    payload = cloudpickle.dumps(make_factory(noisy=True))
    (tmp_path / "f.pkl").write_bytes(payload)
    digest = hashlib.sha256(payload).hexdigest()
    log = tmp_path / "child.log"
    proc = subprocess.Popen(
        [sys.executable, str(RUNTIMES["port"]), "--serve-child", "--log", str(log)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    script = [
        {"cmd": "serve_open", "id": "s1", "digest": digest, "path": str(tmp_path / "f.pkl")},
        {"cmd": "serve_request", "id": "s1", "rid": "r1", "prompt": [3],
         "params": {"max_new_tokens": 4}},
        {"cmd": "profile_start", "id": "x", "dir": str(tmp_path / "t"), "sid": "other"},
        {"cmd": "profile_start", "id": "p", "dir": str(tmp_path / "t"), "sid": "s1"},
        {"cmd": "serve_inventory"},
        {"cmd": "profile_stop", "id": "p", "artifact_dir": str(tmp_path / "cas")},
        {"cmd": "serve_close", "id": "s1"},
    ]
    wire = "".join(json.dumps(c) + "\n" for c in script).encode()
    out, err = proc.communicate(wire, timeout=WAIT_S)
    assert proc.returncode == 0
    events = [json.loads(line) for line in out.decode().splitlines()]  # protocol only
    kinds = [(e["event"], e.get("id"), e.get("code")) for e in events
             if e["event"] != "telemetry"]
    assert ("serve_opened", "s1", None) in kinds
    assert ("profile_error", "x", "unknown_session") in kinds
    assert ("profile_started", "p", None) in kinds
    # the session closes after its drain; the trace, packed on its own
    # thread, is announced before the runner exits
    assert ("serve_closed", "s1", None) in kinds
    stopped = next(e for e in events if e["event"] == "profile_stopped")
    assert sha256(Path(stopped["path"])) == stopped["digest"]
    tokens = [t for e in events if e["event"] == "telemetry"
              and e["data"]["type"] == "serve.token" for t in e["data"]["tokens"]]
    assert tokens == [4, 5, 6, 7]
    # the factory's prints went to the log, not to the channel
    assert "factory says hello" in log.read_text() and err == b""


def test_a_serve_child_answers_the_profile_verbs_like_the_reference(tmp_path):
    """One session in each runtime's ``--serve-child``, driven a command at
    a time: a capture pinned to another session is refused, one pinned to
    this session starts, the inventory, the stop, the close.  Both answer
    alike, but for the end: the port's runner announces its packed trace
    and exits 0; the reference's exits while the trace still stops."""
    payload = cloudpickle.dumps(make_factory())
    (tmp_path / "f.pkl").write_bytes(payload)
    digest = hashlib.sha256(payload).hexdigest()

    def drive(name):
        root = tmp_path / name
        root.mkdir()
        rt = Runtime(RUNTIMES[name], root, mode="--serve-child")
        try:
            rt.send({"cmd": "serve_open", "id": "s1", "digest": digest,
                     "path": str(tmp_path / "f.pkl")})
            rt.wait(is_event("serve_opened", "s1"))
            rt.send({"cmd": "serve_request", "id": "s1", "rid": "r1", "prompt": [3],
                     "params": {"max_new_tokens": 4}})
            rt.wait(is_record("r1", done=True))
            rt.send({"cmd": "profile_start", "id": "x", "dir": str(root / "t"), "sid": "other"})
            rt.wait(profile_event("profile_error", "x"))
            rt.send({"cmd": "profile_start", "id": "p", "dir": str(root / "t"), "sid": "s1"})
            rt.wait(lambda e: e.get("id") == "p")
            rt.send({"cmd": "serve_inventory"})
            rt.wait(is_event("serve_inventory"))
            rt.send({"cmd": "profile_stop", "id": "p", "artifact_dir": str(root / "cas")})
            rt.send({"cmd": "serve_close", "id": "s1"})
            rt.wait(is_event("serve_closed", "s1"))
        finally:
            rt.close()
        return rt.events, rt.proc.returncode

    runs = on_both(drive)
    # the reference's runner exits while its trace still stops on a daemon
    # thread, and may abort in the interpreter's teardown (SIGABRT)
    assert runs["port"][1] == 0
    runs = {name: events for name, (events, _) in runs.items()}
    answers = {name: masked([e for e in events if e["event"] not in
                             ("telemetry", "profile_stopped")])
               for name, events in runs.items()}
    assert answers["port"] == answers["reference"]
    assert [(e["event"], e.get("id"), e.get("code")) for e in answers["port"]] == [
        ("serve_opened", "s1", None), ("profile_error", "x", "unknown_session"),
        ("profile_started", "p", None), ("serve_inventory", None, None),
        ("serve_closed", "s1", None)]
    tokens = {name: [t for e in events if e["event"] == "telemetry"
                     and e["data"]["type"] == "serve.token" for t in e["data"]["tokens"]]
              for name, events in runs.items()}
    assert tokens["port"] == tokens["reference"] == [4, 5, 6, 7]
    stopped = [e for e in runs["port"] if e["event"] == "profile_stopped"]
    assert len(stopped) == 1 and sha256(Path(stopped[0]["path"])) == stopped[0]["digest"]


# ---------------------------------------------------------------------------
# The dispatcher: capture_profile, a profiled RPC electron, a torn artifact
# ---------------------------------------------------------------------------


def traced_sum(n):
    import torch

    return float(torch.ones(n).sum())


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    root = tmp_path_factory.mktemp("captures")
    seen: list = []
    obs_events.add_listener(seen.append)

    async def flow():
        cold = GPUExecutor(transport="local", cache_dir=str(root / "cold"),
                           remote_cache=str(root / "cold_remote"), python_path=sys.executable)
        ex = GPUExecutor(transport="local", cache_dir=str(root / "cache"),
                         remote_cache=str(root / "remote"), python_path=sys.executable,
                         use_agent="pool", dispatch_mode="rpc", pool_preload="cloudpickle",
                         profile_dir=str(root / "traces"), task_env={"PYTHONPATH": str(REPO)})
        out = {"cold": await cold.capture_profile(duration_s=0.1)}
        try:
            out["rpc"] = await ex.run(traced_sum, [5], {}, {"dispatch_id": "d", "node_id": 0})
            out["rpc_mode"] = ex.last_dispatch_mode
            out["rpc_trace"] = ex.last_timings.get("profile_trace")
            handle = await open_session(ex, make_factory(step_delay=0.02, default_cap=30))
            try:
                request = await handle.request([0])
                first = asyncio.ensure_future(handle.capture_profile(duration_s=0.5))
                await asyncio.sleep(0.1)
                try:  # the session's runtime is busy with the first capture
                    await handle.capture_profile(duration_s=0.1)
                except ServeError as err:
                    out["busy"] = str(err)
                out["session"] = await first
                out["tokens"] = await request.result(timeout=WAIT_S)
                out["executor"] = await ex.capture_profile(duration_s=0.2, sid=handle.sid)
                # a torn artifact: the fetched bytes no longer match the digest
                real_get = ex._transports["local:localhost"].get

                async def torn_get(remote, local):
                    await real_get(remote, local)
                    with open(local, "ab") as f:
                        f.write(b"torn")

                ex._transports["local:localhost"].get = torn_get
                out["torn"] = await ex.capture_profile(duration_s=0.1)
                ex._transports["local:localhost"].get = real_get
            finally:
                await handle.close()
        finally:
            await ex.close()
            await cold.close()
        return out

    try:
        out = asyncio.run(flow())
    finally:
        obs_events.remove_listener(seen.append)
    out["events"] = seen
    return out


def test_a_runtime_less_executor_captures_nothing(captures):
    assert captures["cold"] is None


def test_a_profiled_rpc_electron_is_traced_in_the_runtime(captures):
    assert captures["rpc"] == 5.0 and captures["rpc_mode"] == "rpc"
    trace = Path(captures["rpc_trace"])
    assert trace.exists() and trace.parent.name == "profiles"
    assert members(trace) == ["./trace.json"]


def test_serve_handle_capture_profile_returns_its_checked_artifact(captures):
    info = captures["session"]
    assert set(info) == {"sid", "duration_s", "path", "digest", "bytes"}
    assert info["duration_s"] == 0.5 and sha256(Path(info["path"])) == info["digest"]
    assert Path(info["path"]).stat().st_size == info["bytes"]
    assert captures["tokens"] == list(range(1, 31))
    assert "busy or unavailable" in captures["busy"]


def test_executor_capture_profile_pins_a_session(captures):
    info = captures["executor"]
    assert info["worker"] == "localhost" and sha256(Path(info["path"])) == info["digest"]


def test_a_torn_artifact_is_refused_by_its_digest(captures):
    assert captures["torn"] is None
    errors = [e for e in captures["events"] if e.get("type") == "task.profile_error"]
    assert any(e.get("stage") == "fetch" and "digest" in e.get("error", "") for e in errors)
    assert any(e.get("stage") == "start" and "busy" in e.get("error", "") for e in errors)
