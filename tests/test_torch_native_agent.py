"""The port's copy of the native agent against the JAX package's, on the CPU.

Both ``native/agent.cc`` files are compiled with this machine's C++
compiler into a temporary directory (the tests skip where there is none,
as ``tests/test_agent.py`` does) and fed the same command script: a ping,
``run`` (an exit code, a kill), ``watch``/``unwatch`` of a telemetry file,
``register_fn`` (a digest mismatch too) and ``invoke`` through the port's
``harness.py --rpc-child`` runner, the epoch fence and ``task_inventory``.
The two event streams must be equal with pids, times and sequence numbers
masked.  Then ``GPUExecutor(use_agent="native", transport="local")`` end to
end: the agent compiled by ``ensure_agent_binary``, an RPC electron in a
``--rpc-child``, a launch-mode electron exec'd by the agent, and a small
LM's serving session in a ``--serve-child`` whose streams equal the same
factory's on the pool server.
"""

import asyncio
import base64
import hashlib
import json
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import cloudpickle
import pytest
import torch

from covalent_tpu_plugin_torch import GPUExecutor
from covalent_tpu_plugin_torch.agent import AGENT_SOURCE, AgentError, agent_source_hash
from covalent_tpu_plugin_torch.models import serve
from covalent_tpu_plugin_torch.models.transformer import TransformerConfig
from covalent_tpu_plugin_torch.serving import open_session

REPO = Path(__file__).resolve().parent.parent
SOURCES = {
    "reference": REPO / "covalent_tpu_plugin" / "native" / "agent.cc",
    "port": AGENT_SOURCE,
}
RUNNER = [sys.executable, str(REPO / "covalent_tpu_plugin_torch" / "harness.py"), "--rpc-child"]
WAIT_S = 60.0
CXX = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    if CXX is None:
        pytest.skip("no C++ compiler on this machine")
    out = tmp_path_factory.mktemp("agents")
    built = {}
    for name, source in SOURCES.items():
        built[name] = out / f"agent_{name}"
        subprocess.run([CXX, "-O2", "-std=c++17", "-o", str(built[name]), str(source)],
                       check=True, timeout=300)
    return built


class Agent:
    """One agent process on JSON lines, with every event it printed."""

    def __init__(self, binary: Path, cwd: Path):
        self.proc = subprocess.Popen([str(binary)], cwd=cwd, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        self.events: list[dict] = []
        self._cond = threading.Condition()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            event = json.loads(line)
            with self._cond:
                self.events.append(event)
                self._cond.notify_all()

    def send(self, command: dict) -> None:
        self.proc.stdin.write((json.dumps(command) + "\n").encode())
        self.proc.stdin.flush()

    def wait(self, predicate) -> dict:
        with self._cond:
            if not self._cond.wait_for(lambda: any(map(predicate, self.events)),
                                       timeout=WAIT_S):
                raise AssertionError(f"timed out; events so far: {self.events}")
            return next(e for e in self.events if predicate(e))

    def close(self) -> None:
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=WAIT_S)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()


def event(kind, id=None):
    return lambda e: e.get("event") == kind and (id is None or e.get("id") == id)


def record(id, type):
    return lambda e: (e.get("event") == "telemetry" and e.get("id") == id
                      and (e.get("data") or {}).get("type") == type)


def by_value():
    """A function cloudpickle ships by value: the runner imports no test module."""

    def square(x):
        return x * x

    return square


def run_script(agent: Agent, root: Path) -> None:
    agent.wait(event("ready"))
    agent.send({"cmd": "ping"})
    agent.wait(event("pong"))
    agent.send({"cmd": "run", "id": "t1", "argv": ["/bin/sh", "-c", "exit 3"],
                "log": str(root / "t1.log")})
    agent.wait(event("exit", "t1"))
    agent.send({"cmd": "run", "id": "t2", "argv": ["/bin/sh", "-c", "exec sleep 30"],
                "log": str(root / "t2.log")})
    agent.wait(event("started", "t2"))
    agent.send({"cmd": "kill", "id": "t2", "sig": 15})
    agent.wait(event("exit", "t2"))
    agent.send({"cmd": "kill", "id": "nobody", "sig": 15})
    agent.wait(event("error", "nobody"))
    tele = root / "tele.jsonl"
    tele.write_text('{"type": "worker.heartbeat", "seq": 1}\n{"type": "x", "seq": 2}\n')
    agent.send({"cmd": "watch", "id": "w1", "path": str(tele)})
    agent.wait(lambda e: sum(1 for x in agent.events if x.get("event") == "telemetry"
                             and x.get("id") == "w1") >= 2)
    agent.send({"cmd": "unwatch", "id": "w1"})
    agent.wait(event("unwatched", "w1"))
    payload = cloudpickle.dumps(by_value())
    fn_path = root / "fn.pkl"
    fn_path.write_bytes(payload)
    digest = hashlib.sha256(payload).hexdigest()
    agent.send({"cmd": "register_fn", "digest": "0" * 64, "path": str(fn_path),
                "runner": RUNNER})
    agent.wait(event("register_error"))
    agent.send({"cmd": "register_fn", "digest": digest, "path": str(fn_path), "runner": RUNNER})
    agent.wait(event("registered"))
    args = base64.b64encode(cloudpickle.dumps(((7,), {}))).decode("ascii")
    agent.send({"cmd": "invoke", "id": "i1", "digest": digest, "path": str(fn_path),
                "args": args, "spec": {"operation_id": "i1"}})
    agent.wait(event("result", "i1"))
    agent.wait(record("i1", "worker.task_finished"))
    agent.wait(event("exit", "i1"))
    agent.send({"cmd": "invoke", "id": "i2", "digest": "f" * 64, "args": args})
    agent.wait(event("error", "i2"))
    agent.send({"cmd": "epoch", "epoch": 5})
    agent.wait(event("epoch_ok"))
    agent.send({"cmd": "epoch", "epoch": 2})
    agent.wait(lambda e: e.get("code") == "stale_epoch")
    agent.send({"cmd": "run", "id": "t3", "argv": ["/bin/true"], "log": str(root / "t3.log")})
    agent.wait(event("error", "t3"))
    agent.send({"cmd": "epoch", "epoch": 5})
    agent.wait(lambda e: sum(1 for x in agent.events if x.get("event") == "epoch_ok") >= 2)
    agent.send({"cmd": "task_inventory"})
    agent.wait(event("task_inventory"))
    agent.send({"cmd": "bogus"})
    agent.send({"cmd": "shutdown"})
    agent.wait(event("bye"))


MASKED = {"pid", "ts", "seq", "hb_seq", "start", "end", "gen_s"}


def masked(value, root: str):
    """``value`` with the masked fields starred and the run's directory
    named ``<root>``."""
    if isinstance(value, dict):
        return {k: "*" if k in MASKED else masked(v, root) for k, v in value.items()}
    if isinstance(value, list):
        return [masked(v, root) for v in value]
    if isinstance(value, str):
        return value.replace(root, "<root>")
    return value


def result_value(events: list) -> tuple:
    result = next(e for e in events if e.get("event") == "result")
    value, error, _times = cloudpickle.loads(base64.b64decode(result["data"]))
    return value, error


@pytest.fixture(scope="module")
def both_runs(binaries, tmp_path_factory):
    runs = {}
    for name, binary in binaries.items():
        root = tmp_path_factory.mktemp(f"script_{name}")
        agent = Agent(binary, root)
        try:
            run_script(agent, root)
        finally:
            agent.close()
        runs[name] = agent.events
        runs[f"{name}_root"] = str(root)
    return runs


def test_the_port_agent_answers_the_script_like_the_reference(both_runs):
    ref, port = (both_runs[n] for n in ("reference", "port"))
    # the invoke's result pickles the runner's own clock: compare its value
    assert result_value(port) == result_value(ref) == (49, None)
    strip = [lambda e: {k: v for k, v in e.items() if k != "data"}
             if e.get("event") == "result" else e][0]
    assert [masked(strip(e), both_runs["port_root"]) for e in port] == \
        [masked(strip(e), both_runs["reference_root"]) for e in ref]


def test_the_script_covers_every_verb(both_runs):
    kinds = {e["event"] for e in both_runs["port"]}
    assert {"ready", "pong", "started", "exit", "killed", "error", "watching", "telemetry",
            "unwatched", "register_error", "registered", "result", "epoch_ok",
            "task_inventory", "bye"} <= kinds
    exits = {e["id"]: (e["code"], e["signal"]) for e in both_runs["port"]
             if e["event"] == "exit"}
    assert exits["t1"] == (3, 0) and exits["t2"][1] == 15 and exits["i1"] == (0, 0)
    mismatch = next(e for e in both_runs["port"] if e["event"] == "register_error")
    assert mismatch["code"] == "digest_mismatch"
    stale = [e for e in both_runs["port"] if e.get("code") == "stale_epoch"]
    assert [e.get("id") for e in stale] == ["", "t3"]


def test_the_port_copy_changes_only_comments():
    def code(path):
        return [line for line in path.read_text().splitlines()
                if not line.strip().startswith("//")]

    assert code(SOURCES["port"]) == code(SOURCES["reference"])
    assert len(agent_source_hash()) == 12


# ---------------------------------------------------------------------------
# GPUExecutor(use_agent="native") end to end
# ---------------------------------------------------------------------------

TINY = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                         d_ff=64, max_seq=64, dtype=torch.float32)
PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [9, 8, 7, 6, 5], [11]]
CAPS = [6, 4, 5, 3]


def _executor(root: Path, use_agent: str, **kwargs) -> GPUExecutor:
    return GPUExecutor(transport="local", cache_dir=str(root / "cache"),
                       remote_cache=str(root / "remote"), remote_workdir=str(root / "work"),
                       python_path=sys.executable, use_agent=use_agent,
                       pool_preload="cloudpickle", task_env={"PYTHONPATH": str(REPO)},
                       poll_freq=0.2, **kwargs)


def torch_sum(n):
    import torch

    return float(torch.arange(n, dtype=torch.float64).sum())


async def _serve(target, factory) -> list:
    handle = await open_session(target, factory)
    try:
        requests = [await handle.request(p, params={"max_new_tokens": c})
                    for p, c in zip(PROMPTS, CAPS)]
        return [await r.result(timeout=WAIT_S) for r in requests]
    finally:
        await handle.close()


@pytest.fixture(scope="module")
def native_runs(binaries, tmp_path_factory):
    root = tmp_path_factory.mktemp("native_executor")
    factory = serve.lm_engine_factory(config=TINY, seed=0, device="cpu", max_batch=2,
                                      sync_steps=2, max_new_tokens=8)

    async def flow():
        native = _executor(root / "native", "native", dispatch_mode="rpc")
        pool = _executor(root / "pool", "pool")
        out = {}
        try:
            out["rpc"] = await native.run(torch_sum, [10], {}, {"dispatch_id": "d", "node_id": 0})
            out["rpc_mode"] = native.last_dispatch_mode
            client = native._agents["localhost"]
            out["agent_mode"], out["frames"] = client.mode, client.frames_active
            out["launch"] = await native.run(torch_sum, [4], {},
                                             {"dispatch_id": "d", "node_id": 1,
                                              "dispatch_mode": "launch"})
            out["launch_mode"] = native.last_dispatch_mode
            out["native_streams"] = await _serve(native, factory)
            out["pool_streams"] = await _serve(pool, factory)
            out["binary"] = sorted(p.name for p in (root / "native" / "remote").iterdir()
                                   if p.name.startswith("agent_"))
        finally:
            await native.close()
            await pool.close()
        return out

    return asyncio.run(flow())


def test_an_rpc_electron_runs_in_a_rpc_child(native_runs):
    assert native_runs["rpc"] == 45.0 and native_runs["rpc_mode"] == "rpc"
    assert native_runs["agent_mode"] == "native" and native_runs["frames"] is True
    # compiled once, named by the source's content hash
    assert f"agent_{agent_source_hash()}" in native_runs["binary"]


def test_a_launch_mode_electron_is_execd_by_the_agent(native_runs):
    assert native_runs["launch"] == 6.0 and native_runs["launch_mode"] == "launch"


def test_a_serve_child_session_streams_what_the_pool_server_streams(native_runs):
    assert [len(s) for s in native_runs["native_streams"]] == CAPS
    assert native_runs["native_streams"] == native_runs["pool_streams"]


def test_a_pinned_native_agent_that_cannot_build_is_an_error(tmp_path, monkeypatch, run_async):
    """``use_agent="native"`` falls to no other road: an agent that cannot
    build fails the lease, the session and the electron, each naming the
    compiler's failure, and nothing launches with nohup instead."""
    from covalent_tpu_plugin_torch import agent as agent_mod

    broken = tmp_path / "agent.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(agent_mod, "AGENT_SOURCE", broken)
    agent_mod.agent_source_hash.cache_clear()
    events = []
    from covalent_tpu_plugin_torch.obs import events as obs_events

    obs_events.add_listener(events.append)
    ex = _executor(tmp_path, "native")

    async def flow():
        try:
            with pytest.raises(AgentError, match="compile failed"):
                await ex.lease_gang()
            with pytest.raises(AgentError, match="native agent did not start"):
                await _serve(ex, serve.lm_engine_factory(config=TINY, seed=0, device="cpu"))
            # the dispatch fails (task.dispatch_failed), as for a worker
            # that cannot be reached
            with pytest.raises(RuntimeError, match="native agent did not start"):
                await ex.run(torch_sum, [3], {}, {"dispatch_id": "d", "node_id": 2,
                                                  "dispatch_mode": "launch"})
            assert "localhost" not in ex._agents
        finally:
            await ex.close()

    try:
        run_async(flow())
    finally:
        obs_events.remove_listener(events.append)
        agent_mod.agent_source_hash.cache_clear()
    unavailable = [e for e in events if e.get("type") == "agent.unavailable"]
    assert unavailable and unavailable[0]["tried"] == ["native"]
    assert "compile failed" in unavailable[0]["error"]


def test_unknown_agent_policies_are_refused():
    with pytest.raises(ValueError, match="'native'"):
        GPUExecutor(use_agent="zygote")
