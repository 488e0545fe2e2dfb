"""The port's pool ``run`` verb: launch-mode specs forked from the zygote.

Counterpart of ``tests/test_pool.py``, on the CPU.  The port's pool server
(``harness.py --serve``) runs each ``run`` as a fork of its zygote, a
helper that imported the preloads and never initialised CUDA, and pushes
``started`` and ``exit``.  The protocol-level tests share one pool server
(a module-scoped fixture on one event loop); the executor-level tests each
build their executor.  Waits are on pushed events, never on a sleep that
decides a verdict.
"""

import asyncio
import json
import os
import sys
import time
from pathlib import Path

import cloudpickle
import pytest

import covalent_tpu_plugin_torch.workflow as ct
from covalent_tpu_plugin_torch import GPUExecutor, gpu as gpu_mod, harness
from covalent_tpu_plugin_torch.agent import AgentError, start_pool_server
from covalent_tpu_plugin_torch.obs import events as obs_events
from covalent_tpu_plugin_torch.transport import LocalTransport
from covalent_tpu_plugin_torch.utils.serialize import load_result
from covalent_tpu_plugin_torch.workflow import runner

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 60.0
METADATA = {"dispatch_id": "dP", "node_id": 0}


def make_executor(tmp_path, **kwargs):
    """A GPUExecutor on the pool: light preloads, electrons of this file
    pickled by value, the checkout on the workers' path."""
    kwargs.setdefault("transport", "local")
    kwargs.setdefault("cache_dir", str(tmp_path / "cache"))
    kwargs.setdefault("remote_cache", str(tmp_path / "remote"))
    kwargs.setdefault("remote_workdir", str(tmp_path / "work"))
    kwargs.setdefault("python_path", sys.executable)
    kwargs.setdefault("poll_freq", 0.2)
    kwargs.setdefault("use_agent", True)
    kwargs.setdefault("pool_preload", "cloudpickle")
    kwargs.setdefault("task_env", {"PYTHONPATH": str(REPO)})
    return GPUExecutor(**kwargs)


class EventLog:
    """The executor's obs events of one test, by type."""

    def __init__(self):
        self.events: list[dict] = []

    def __call__(self, event: dict) -> None:
        self.events.append(event)

    def of(self, kind: str) -> list[dict]:
        return [e for e in self.events if e.get("type") == kind]


@pytest.fixture()
def event_log():
    log = EventLog()
    obs_events.add_listener(log)
    try:
        yield log
    finally:
        obs_events.remove_listener(log)


def stage_spec(tmp_path, fn, args=(), name="t"):
    """A launch-mode spec of ``fn(*args)``: (spec path, result path)."""
    function_file = tmp_path / f"fn_{name}.pkl"
    result_file = tmp_path / f"res_{name}.pkl"
    function_file.write_bytes(cloudpickle.dumps((fn, tuple(args), {})))
    spec = {"function_file": str(function_file), "result_file": str(result_file),
            "workdir": str(tmp_path / "wd"), "pid_file": str(tmp_path / f"pid_{name}")}
    spec_file = tmp_path / f"spec_{name}.json"
    spec_file.write_text(json.dumps(spec))
    return str(spec_file), result_file


class Pool:
    """One pool server for the module, driven on one event loop."""

    def __init__(self, root: Path):
        self.root = root
        self.loop = asyncio.new_event_loop()
        self.conn = LocalTransport()
        self.client = self.run(start_pool_server(
            self.conn, str(root / "remote"), sys.executable, preload="cloudpickle",
            env={"PYTHONPATH": str(REPO)}))

    def run(self, coro):
        return self.loop.run_until_complete(asyncio.wait_for(coro, WAIT_S))

    def close(self):
        self.run(self.client.close())
        self.loop.close()


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = Pool(tmp_path_factory.mktemp("pool"))
    yield p
    p.close()


def _make_square_plus():
    # Closure-local: cloudpickle ships it by value, so the worker does not
    # import this module (and with it torch) to unpickle it.
    def square_plus(a):
        return a * a + 1

    return square_plus


_square_plus = _make_square_plus()


async def until(predicate, timeout=WAIT_S):
    """Poll ``predicate()`` until it is true, within ``timeout`` seconds."""

    async def loop():
        while not predicate():
            await asyncio.sleep(0.02)

    await asyncio.wait_for(loop(), timeout)


def test_pool_server_runs_spec_and_pushes_exit(pool, tmp_path):
    spec_file, result_file = stage_spec(tmp_path, lambda a: a + 1, (41,))
    pid = pool.run(pool.client.run_task("t1", spec=spec_file, log=str(tmp_path / "t1.log")))
    code, signal = pool.run(pool.client.wait_exit("t1"))
    result, exception, times = load_result(result_file)
    assert pid > 0 and pid != pool.client._process._proc.pid
    assert (code, signal) == (0, 0)
    assert result == 42 and exception is None and times["end"] >= times["start"]
    # the child wrote its own pid first thing, as a nohup launch does
    assert int((tmp_path / "pid_t").read_text()) == pid


def test_pool_forks_are_concurrent_and_isolated(pool, tmp_path):
    """Two tasks forked at once run at the same time, in separate
    processes, and share no mutable state."""

    def slow_electron(tag, delay):
        import os
        import time

        os.environ["POOL_TEST_TAG"] = tag  # would leak if the processes were shared
        time.sleep(delay)
        return os.getpid(), os.environ["POOL_TEST_TAG"]

    spec_a, res_a = stage_spec(tmp_path, slow_electron, ("a", 0.6), "a")
    spec_b, res_b = stage_spec(tmp_path, slow_electron, ("b", 0.6), "b")
    t0 = time.perf_counter()
    pool.run(pool.client.run_task("a", spec=spec_a))
    pool.run(pool.client.run_task("b", spec=spec_b))

    async def both_exits():
        return await asyncio.gather(pool.client.wait_exit("a"), pool.client.wait_exit("b"))

    pool.run(both_exits())
    elapsed = time.perf_counter() - t0
    (pid_a, tag_a), (pid_b, tag_b) = load_result(res_a)[0], load_result(res_b)[0]
    assert pid_a != pid_b and (tag_a, tag_b) == ("a", "b")
    # two 0.6 s sleeps one after the other take more than 1.2 s: less is overlap
    assert elapsed < 1.2


def test_pool_transports_electron_exception(pool, tmp_path):
    def boom():
        raise ValueError("pool-boom")

    spec_file, result_file = stage_spec(tmp_path, boom)
    pool.run(pool.client.run_task("boom", spec=spec_file))
    code, _ = pool.run(pool.client.wait_exit("boom"))
    result, exception, _ = load_result(result_file)
    assert code == 0  # the harness succeeded; the error travels in the pickle
    assert result is None and isinstance(exception, ValueError) and "pool-boom" in str(exception)


def test_pool_kill_terminates_fork(pool, tmp_path):
    def sleeper():
        import time

        time.sleep(30)

    spec_file, _ = stage_spec(tmp_path, sleeper)
    pool.run(pool.client.run_task("victim", spec=spec_file))
    inventory = pool.run(pool.client.task_inventory())
    pool.run(pool.client.kill("victim"))
    code, signal = pool.run(pool.client.wait_exit("victim"))
    after = pool.run(pool.client.task_inventory())
    assert [t["id"] for t in inventory["tasks"]] == ["victim"]
    assert signal == 15 and code == -1
    assert after["tasks"] == []


def test_pool_watch_forwards_a_task_file(pool, tmp_path):
    """``watch`` tails a task's JSONL file from offset 0; each record
    reaches ``on_telemetry``; the task's exit flushes the tail and unwatches."""
    path = tmp_path / "events.jsonl"

    def writer(path):
        import json
        import time

        with open(path, "a") as f:
            for i in range(3):
                f.write(json.dumps({"type": "progress", "step": i, "seq": i + 1}) + "\n")
                f.flush()
                time.sleep(0.1)

    seen = []
    pool.client.on_telemetry = lambda task_id, data: seen.append((task_id, data["step"]))
    try:
        spec_file, _ = stage_spec(tmp_path, writer, (str(path),))
        pool.run(pool.client.watch("w", str(path)))
        pool.run(pool.client.run_task("w", spec=spec_file))
        pool.run(pool.client.wait_exit("w"))
        pool.run(pool.client.ping())  # the exit's last pump precedes this pong
        pool.run(pool.client.unwatch("w"))
    finally:
        pool.client.on_telemetry = None
    assert seen == [("w", 0), ("w", 1), ("w", 2)]


def test_zygote_refuses_to_fork_once_cuda_is_initialized(monkeypatch):
    """The zygote checks ``torch.cuda.is_initialized()`` before every fork
    and raises, without forking, when it is true."""
    import torch

    def no_fork():
        raise AssertionError("the zygote forked with CUDA initialised")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(os, "fork", no_fork)
    children: dict = {}
    with pytest.raises(harness.ZygoteCudaError, match="CUDA is initialised"):
        harness._zygote_fork({"id": "t", "spec": "unused.json"}, children)
    assert children == {}


def test_zygote_refusal_reaches_the_client_as_a_permanent_error(tmp_path, run_async):
    """A zygote that refuses to fork answers ``run`` with an error the
    client raises as PERMANENT (``zygote_cuda``): no fallback hides it."""
    from covalent_tpu_plugin_torch.resilience import FaultClass, classify_error

    # A preloaded module that leaves a ``torch`` reporting CUDA initialised,
    # as a module that touched the card at import would (a stand-in module,
    # so the test pays no torch import).
    (tmp_path / "fake_cuda_init.py").write_text(
        "import sys, types\n"
        "torch = types.ModuleType('torch')\n"
        "torch.cuda = types.SimpleNamespace(is_initialized=lambda: True)\n"
        "sys.modules['torch'] = torch\n")
    spec_file, _ = stage_spec(tmp_path, lambda: 1)

    async def flow():
        conn = LocalTransport()
        client = await start_pool_server(
            conn, str(tmp_path / "remote"), sys.executable,
            preload="cloudpickle,fake_cuda_init",
            env={"PYTHONPATH": f"{tmp_path}{os.pathsep}{REPO}"})
        try:
            with pytest.raises(AgentError) as excinfo:
                await client.run_task("t", spec=spec_file, timeout=WAIT_S)
            return excinfo.value
        finally:
            await client.close()

    error = run_async(flow())
    assert classify_error(error) == (FaultClass.PERMANENT, "zygote_cuda")
    assert "refusing to fork" in str(error)
    assert "refusing to fork" in (tmp_path / "remote" / "pool_server.log").read_text()


def test_pool_preload_imports_nothing_of_jax(tmp_path, run_async):
    """With the default preloads (``torch`` and this package) in the pool
    server and its zygote, neither an RPC electron (in the server) nor a
    ``run`` electron (a zygote fork) finds JAX or the reference package
    loaded, and the zygote never initialised CUDA."""

    def foreign():
        import sys

        import torch

        return (sorted({m.split(".")[0] for m in sys.modules}
                       & {"jax", "jaxlib", "flax", "optax", "covalent_tpu_plugin"}),
                "covalent_tpu_plugin_torch" in sys.modules, torch.cuda.is_initialized())

    async def flow():
        out = {}
        ex = make_executor(tmp_path, pool_preload=gpu_mod.POOL_PRELOAD)
        try:
            for mode in ("launch", "rpc"):
                out[mode] = await ex.run(foreign, [], {}, {**METADATA, "dispatch_mode": mode})
                assert ex.last_dispatch_mode == mode
        finally:
            await ex.close()
        return out

    assert run_async(flow()) == {"launch": ([], True, False), "rpc": ([], True, False)}


# --------------------------------------------------------------------------
# The executor on the pool
# --------------------------------------------------------------------------


@pytest.mark.parametrize("use_agent", [True, "auto"])
def test_executor_auto_mode_prefers_pool_and_reuses_it(tmp_path, run_async, use_agent):
    async def flow():
        ex = make_executor(tmp_path, use_agent=use_agent)
        try:
            first = await ex.run(_square_plus, [2], {}, METADATA)
            client = ex._agents.get("localhost")
            second = await ex.run(_square_plus, [3], {}, {"dispatch_id": "dP", "node_id": 1})
            pids = await ex.run(os.getpid, [], {}, {"dispatch_id": "dP", "node_id": 2})
            return (first, second, client is not None, ex._agents.get("localhost") is client,
                    ex.last_dispatch_mode, pids, client._process._proc.pid)
        finally:
            await ex.close()

    first, second, pooled, same, mode, task_pid, server_pid = run_async(flow())
    assert (first, second) == (5, 10)
    assert pooled and same and mode == "launch"
    assert task_pid not in (os.getpid(), server_pid)  # a fork, not the server


def test_executor_defaults_are_the_references(monkeypatch):
    ex = GPUExecutor()
    assert (ex.use_agent, ex.dispatch_mode, ex.rpc_inline_args_max) == (True, "launch", 64 << 10)
    assert "covalent_tpu_plugin_torch" in ex.pool_preload.split(",")
    assert GPUExecutor(use_agent="off").use_agent is False
    monkeypatch.setenv("COVALENT_TPU_DISPATCH_MODE", "RPC")
    monkeypatch.setenv("COVALENT_TPU_RPC_INLINE_MAX", "128")
    ex = GPUExecutor()
    assert (ex.dispatch_mode, ex.rpc_inline_args_max) == ("rpc", 128)
    assert GPUExecutor(dispatch_mode="auto", rpc_inline_args_max=7).rpc_inline_args_max == 7
    with pytest.raises(ValueError, match="dispatch_mode"):
        GPUExecutor(dispatch_mode="teleport")
    with pytest.raises(ValueError, match="use_agent"):
        GPUExecutor(use_agent="sometimes")


def test_gpu_alias_runs_electrons_through_the_pool(tmp_path, monkeypatch, event_log):
    """``executor="gpu"`` with the defaults: the electron is a zygote fork
    of the pool (``agent.started``), pushed its exit, and the same
    executor serves a second dispatch."""
    from covalent_tpu_plugin_torch.utils import config as config_mod

    monkeypatch.setenv("COVALENT_TPU_CONFIG", str(tmp_path / "config.toml"))
    config_mod._reset_cache_for_tests()
    try:
        for key, value in {"cache_dir": str(tmp_path / "cache"),
                           "remote_cache": str(tmp_path / "remote"),
                           "remote_workdir": str(tmp_path / "work"),
                           "python_path": sys.executable, "pool_preload": "cloudpickle",
                           "task_env": {"PYTHONPATH": str(REPO)}}.items():
            config_mod.set_config(f"executors.gpu.{key}", value)
        executor = ct.resolve_executor("gpu")
        double = ct.electron(lambda n: (n * 2, os.getpid()), executor=executor)
        flow = ct.lattice(lambda n: double(n))
        first = ct.dispatch_sync(flow)(4)
        second = ct.dispatch_sync(flow)(5)  # the same executor, a new dispatch
        client = executor._agents.get("localhost")
    finally:
        config_mod._reset_cache_for_tests()
    assert first.status is ct.Status.COMPLETED and first.result[0] == 8
    assert second.status is ct.Status.COMPLETED and second.result[0] == 10
    assert executor.use_agent is True and executor.last_dispatch_mode == "launch"
    assert client is not None and first.result[1] != client._process._proc.pid
    assert len(event_log.of("agent.started")) == 1
    assert not event_log.of("agent.unavailable") and not event_log.of("task.agent_fallback")
    asyncio.run_coroutine_threadsafe(executor.close(), runner._dispatcher_loop()).result(WAIT_S)


def test_launch_falls_back_to_nohup_when_the_pool_cannot_start(tmp_path, run_async,
                                                              monkeypatch, event_log):
    async def no_pool(*args, **kwargs):
        raise AgentError("scripted: no pool runtime")

    monkeypatch.setattr(gpu_mod, "start_pool_server", no_pool)

    async def flow():
        ex = make_executor(tmp_path)
        try:
            return await ex.run(_square_plus, [4], {}, METADATA), ex._agents.get("localhost")
        finally:
            await ex.close()

    result, client = run_async(flow())
    assert result == 17 and client is None
    assert len(event_log.of("agent.unavailable")) == 1


def test_task_survives_its_zygote(tmp_path, run_async):
    """Kill the zygote while a forked task runs: the server reports the
    task's exit as ``lost``, the executor reads the task's own files and
    gets its result, and the next ``run`` starts a new zygote."""
    import signal

    def slow(i):
        import time

        time.sleep(1.0)
        return i + 100

    async def flow():
        ex = make_executor(tmp_path, poll_freq=0.1)
        try:
            await ex.run(_square_plus, [1], {}, METADATA)  # the zygote is up
            task = asyncio.ensure_future(ex.run(slow, [5], {}, {"dispatch_id": "z", "node_id": 0}))
            await until(lambda: ex._pids)
            (task_pid,) = next(iter(ex._pids.values()))
            zygote_pid = int(os.popen(f"ps -o ppid= -p {task_pid}").read().strip())
            os.kill(zygote_pid, signal.SIGKILL)
            result = await asyncio.wait_for(task, WAIT_S)
            again = await ex.run(_square_plus, [3], {}, {"dispatch_id": "z", "node_id": 1})
            return result, again
        finally:
            await ex.close()

    assert run_async(flow()) == (105, 10)


def test_concurrent_electron_stress(tmp_path, run_async):
    """A 16-way fan-out through one executor and its pool: every result
    lands, and the executor and the channel keep nothing per task."""

    async def flow():
        ex = make_executor(tmp_path, poll_freq=0.05)
        try:
            results = await asyncio.gather(*(
                ex.run(_square_plus, [i], {}, {"dispatch_id": "stress", "node_id": i})
                for i in range(16)))
            client = ex._agents["localhost"]
            books = [ex._active_ops, ex._pids, ex._op_agents, ex._op_modes, client._started,
                     client._exits, client._errors, client._results]
            return results, [dict.fromkeys(b) for b in books]
        finally:
            await ex.close()

    results, books = run_async(flow())
    assert results == [i * i + 1 for i in range(16)]
    assert all(not b for b in books), books
