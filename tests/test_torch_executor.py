"""The port's executor, harness and package boundary, on the CPU.

``GPUExecutor(transport="local")`` stages an electron, launches the port's
own harness file in a subprocess, polls, fetches and cleans up, exactly as
it does on a GPU host; here the electrons run on CPU tensors.
"""

import hashlib
import json
import os
import pickle
import re
import shlex
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from covalent_tpu_plugin_torch import GPUExecutor, harness
from covalent_tpu_plugin_torch.cache import harness_digest
from covalent_tpu_plugin_torch.gpu import StagedTask
from covalent_tpu_plugin_torch.transport import LocalTransport

REPO = Path(__file__).resolve().parent.parent


def _executor(tmp_path, **kwargs):
    # launch mode through nohup + poll; the pool's tests opt in to it
    kwargs.setdefault("use_agent", False)
    return GPUExecutor(
        transport="local",
        cache_dir=str(tmp_path / "cache"),
        remote_cache=str(tmp_path / "remote"),
        remote_workdir=str(tmp_path / "work"),
        python_path=sys.executable,
        poll_freq=0.2,
        # the electrons below live in this test module: the worker imports it
        task_env={"PYTHONPATH": str(REPO)},
        **kwargs,
    )


def _attention_electron(seed):
    from covalent_tpu_plugin_torch.ops.attention import flash_attention

    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(1, 2, 128, 16, generator=gen) for _ in range(3))
    return {"out": flash_attention(q, k, v), "pid": os.getpid()}


def _raising_electron():
    raise KeyError("electron failed on the worker")


def _leftovers(tmp_path):
    """Staged files left on either side; the harness stays in the worker's
    CAS (it ships once per connection, under its digest)."""
    kept = ("cas", f"{harness_digest()}.py")
    return sorted(
        p.name for d in ("cache", "remote", "remote/cas") if (tmp_path / d).exists()
        for p in (tmp_path / d).iterdir() if p.name not in kept
    )


def test_executor_round_trips_a_torch_electron(tmp_path, run_async):
    ex = _executor(tmp_path)
    got = run_async(ex.run(_attention_electron, [3], {}, {"dispatch_id": "d", "node_id": 0}))
    want = _attention_electron(3)
    assert got["pid"] != os.getpid()  # it ran in the harness subprocess
    assert isinstance(got["out"], torch.Tensor) and not got["out"].requires_grad
    torch.testing.assert_close(got["out"], want["out"], rtol=0, atol=0)
    assert _leftovers(tmp_path) == []  # staged files gone on both sides


def test_executor_reraises_the_remote_exception_and_cleans_up(tmp_path, run_async):
    ex = _executor(tmp_path)
    with pytest.raises(KeyError, match="electron failed on the worker"):
        run_async(ex.run(_raising_electron, [], {}, {"dispatch_id": "d", "node_id": 1}))
    assert _leftovers(tmp_path) == []


def test_executor_ships_the_ports_own_harness(tmp_path):
    staged = StagedTask("op", tmp_path, "remote")
    local, remote, digest = staged.harness_artifact()
    assert local == harness.__file__
    assert Path(harness.__file__).resolve().parent == REPO / "covalent_tpu_plugin_torch"
    # content-addressed: shipped once per connection, under its digest
    assert (remote, digest) == (f"remote/cas/{harness_digest()}.py", harness_digest())
    assert harness_digest() == hashlib.sha256(Path(harness.__file__).read_bytes()).hexdigest()
    assert "import covalent_tpu_plugin" not in Path(harness.__file__).read_text()


def test_executor_refuses_transports_of_later_slices():
    """The SSH transports are ported; an unknown name is refused as the
    reference refuses it, and chaos plans wait for Queue 1 item 6."""
    for kind in ("local", "ssh", "minissh"):
        assert GPUExecutor(transport=kind, hostname="user@host:2222").transport_kind == kind
    with pytest.raises(ValueError, match='transport must be "local", "ssh" or "minissh"'):
        GPUExecutor(transport="telnet")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        GPUExecutor(transport="ssh", hostname="host", chaos={"drop_connect": 1})
    assert GPUExecutor().run_local_on_dispatch_fail is False


def test_harness_refuses_spec_keys_of_later_slices(tmp_path):
    result = tmp_path / "result.pkl"
    # the distributed bootstrap is ported (slice 4); the checkpointer is slice 5b's
    spec = {"result_file": str(result), "function_file": "unused",
            "checkpoint": {"interval_s": 1.0}}
    assert harness.run_task(spec) == 1
    value, error = pickle.loads(result.read_bytes())
    assert value is None and isinstance(error, NotImplementedError)
    assert "checkpoint" in str(error)


def test_harness_moves_result_tensors_to_host():
    t = torch.ones(3, requires_grad=True) * 2
    out = harness._to_host({"a": [t, (t, 1)], "b": "x"})
    assert not out["a"][0].requires_grad and out["a"][0].device.type == "cpu"
    assert isinstance(out["a"][1], tuple) and out["a"][1][1] == 1 and out["b"] == "x"


def test_harness_main_runs_a_spec_file(tmp_path):
    """The file the executor ships runs standalone: ``python harness.py spec``."""
    import cloudpickle

    fn_file, result, spec_file = (tmp_path / n for n in ("fn.pkl", "res.pkl", "spec.json"))
    fn_file.write_bytes(cloudpickle.dumps((np.add, (2, 3), {})))
    spec_file.write_text(json.dumps({
        "result_file": str(result), "function_file": str(fn_file),
        "pid_file": str(tmp_path / "pid"), "env": {"COVALENT_TEST_MARK": "1"},
    }))
    proc = subprocess.run([sys.executable, harness.__file__, str(spec_file)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    value, error, times = pickle.loads(result.read_bytes())
    assert (value, error) == (5, None) and times["end"] >= times["start"]
    assert (tmp_path / "pid").read_text().strip().isdigit()


def test_port_imports_nothing_of_jax_or_the_reference():
    """Import every module of the port in a clean interpreter: no module of
    JAX, flax, optax or the reference package appears beyond what the
    interpreter had loaded before (its site hooks, if any)."""
    script = r"""
import importlib, pkgutil, sys
def foreign():
    return {m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "covalent_tpu_plugin")}
before = foreign()
import covalent_tpu_plugin_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(len(names), sorted(foreign() - before), " ".join(names))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, added, walked = proc.stdout.strip().split(" ", 2)
    # the serving modules, the resident session's and slice 1b's are walked
    assert {f"covalent_tpu_plugin_torch.{m}" for m in (
        "models.decode", "models.serve", "agent", "cache", "resilience", "serving",
        "serving.handle", "serving.supervisor", "transport.process",
        "models.mlp", "obs", "obs.events", "obs.metrics", "obs.trace", "utils.config",
        "workflow", "workflow.dag", "workflow.deps", "workflow.executors",
        "workflow.runner", "parallel", "parallel.mesh", "parallel.sharding",
        "parallel.distributed", "parallel.collectives", "parallel.launch",
        "parallel.probe", "transport.ssh", "transport.minissh", "transport.codec",
        "transport.pool", "ops.ring_attention")} <= set(walked.split())
    assert int(count) >= 45
    assert added == "[]"


def test_gpu_alias_resolves_without_jax(tmp_path):
    """With JAX, flax, optax and the reference package unimportable,
    ``executor="gpu"`` still resolves, and a lattice runs on it."""
    script = r"""
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "covalent_tpu_plugin"):
            raise ImportError(f"{name} is not installed here")
sys.meta_path.insert(0, Refuse())
import covalent_tpu_plugin_torch.workflow as ct
from covalent_tpu_plugin_torch.utils.config import set_config
executor = ct.resolve_executor("gpu")
set_config("executors.gpu.python_path", sys.executable)
set_config("executors.gpu.cache_dir", sys.argv[1] + "/cache")
set_config("executors.gpu.remote_cache", sys.argv[1] + "/remote")
set_config("executors.gpu.remote_workdir", sys.argv[1] + "/work")
flow = ct.lattice(lambda x: ct.electron(lambda y: y * 3, executor="gpu")(x))
result = ct.dispatch_sync(flow)(14)
print(type(executor).__name__, result.status.value, result.result)
"""
    env = dict(os.environ, COVALENT_TPU_CONFIG=str(tmp_path / "config.toml"))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["GPUExecutor", "COMPLETED", "42"]


# --------------------------------------------------------------------------- #
# Stage timings, cancel, pip dependencies, plugin identity                    #
# --------------------------------------------------------------------------- #


def _timed_electron(seconds):
    import time

    time.sleep(seconds)
    return seconds


def test_last_timings_account_for_every_stage(tmp_path, run_async):
    ex = _executor(tmp_path)
    assert run_async(ex.run(_timed_electron, [0.2], {},
                            {"dispatch_id": "d", "node_id": 0})) == 0.2
    timings = ex.last_timings
    assert {"stage", "upload", "submit", "poll", "execute", "fetch", "cleanup",
            "total", "overhead", "wall_overhead"} <= set(timings)
    # execute is the harness's own clock around the electron
    assert 0.2 <= timings["execute"] < timings["total"]
    assert timings["overhead"] == pytest.approx(sum(
        v for k, v in timings.items()
        if k not in ("execute", "total", "overhead", "wall_overhead")))
    # the stages are sequential inside the root span: what they leave out
    # (validation, scheduling) only makes the wall view larger
    assert timings["overhead"] <= timings["wall_overhead"] + 1e-3
    assert timings["wall_overhead"] == pytest.approx(timings["total"] - timings["execute"])


def test_a_failed_run_still_reports_its_timings(tmp_path, run_async):
    ex = _executor(tmp_path)
    with pytest.raises(KeyError):
        run_async(ex.run(_raising_electron, [], {}, {"dispatch_id": "d", "node_id": 1}))
    assert ex.last_timings["execute"] >= 0 and ex.last_timings["total"] > 0


def _sleeping_electron(started):
    import os
    import time

    with open(started, "w") as f:
        f.write(str(os.getpid()))
    time.sleep(120)


def _gone(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        return True
    return state in ("Z", "X")


async def _until(predicate, what: str, timeout: float = 60.0) -> None:
    import asyncio

    deadline = asyncio.get_running_loop().time() + timeout
    while not predicate():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.02)


def test_cancel_by_node_prefix_kills_the_running_electron(tmp_path, run_async):
    """The runner cancels ``f"{dispatch_id}_{node_id}"``; the run's
    operation id carries a uuid suffix after that prefix."""
    import asyncio

    ex = _executor(tmp_path)
    started = tmp_path / "started"

    async def scenario():
        run = asyncio.ensure_future(ex.run(_sleeping_electron, [str(started)], {},
                                           {"dispatch_id": "disp", "node_id": 3}))
        await _until(lambda: started.exists() and started.read_text(), "the electron")
        (op,) = ex._pids
        assert op.startswith("disp_3_") and len(op) == len("disp_3_") + 8
        await ex.cancel("disp_1")  # another node's prefix: nothing happens
        assert not run.done()
        await ex.cancel("disp_3")
        with pytest.raises(asyncio.CancelledError):
            await asyncio.wait_for(run, 60)
        pid = int(started.read_text())
        await _until(lambda: _gone(pid), "the harness to die", 30)

    run_async(scenario())
    assert ex.last_timings["total"] > 0 and not ex._pids and not ex._cancelled_ops
    assert _leftovers(tmp_path) == []


def test_cancelled_dispatch_is_marked_cancelled(tmp_path):
    import covalent_tpu_plugin_torch.workflow as ct

    ex = _executor(tmp_path)
    started = tmp_path / "started"
    flow = ct.lattice(lambda p: ct.electron(_sleeping_electron, executor=ex)(p))
    dispatch_id = ct.dispatch(flow)(str(started))
    deadline = time.monotonic() + 60
    while not (started.exists() and started.read_text()):
        assert time.monotonic() < deadline, "the electron never started"
        time.sleep(0.02)
    result = ct.cancel(dispatch_id)
    assert result.status is ct.Status.CANCELLED
    pid = int(started.read_text())
    while not _gone(pid):
        assert time.monotonic() < deadline + 30, "the harness was not killed"
        time.sleep(0.02)


class _NeedsMarker:
    """Unpickles only once ``marker`` exists: proves what ran before the
    function pickle was loaded."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return (Path.read_text, (Path(self.marker),))


def test_harness_installs_pip_deps_before_unpickle(tmp_path, monkeypatch):
    from covalent_tpu_plugin_torch.utils.serialize import dump_task

    record = tmp_path / "pip_args.json"
    fake_pip = (f"{shlex.quote(sys.executable)} -c " + shlex.quote(
        f"import json,sys; json.dump(sys.argv[1:], open({str(record)!r}, 'w'))"))
    monkeypatch.setenv("COVALENT_TPU_PIP_CMD", fake_pip)
    function_file, result_file = tmp_path / "function.pkl", tmp_path / "result.pkl"
    dump_task(len, (_NeedsMarker(record),), {}, str(function_file))
    rc = harness.run_task({"function_file": str(function_file), "result_file": str(result_file),
                           "pip_deps": ["scikit-learn==1.1.2", "numpy"]})
    assert rc == 0
    assert json.loads(record.read_text()) == ["scikit-learn==1.1.2", "numpy"]
    result, exception, _ = pickle.loads(result_file.read_bytes())
    assert exception is None and result == len(record.read_text())


def test_pip_failure_comes_back_as_the_tasks_error(tmp_path, monkeypatch, run_async):
    monkeypatch.setenv("COVALENT_TPU_PIP_CMD", f"{shlex.quote(sys.executable)} -c " + shlex.quote(
        "import sys; print('no index', file=sys.stderr); sys.exit(1)"))
    ex = _executor(tmp_path)
    with pytest.raises(RuntimeError, match="pip dependency install failed.*no index"):
        run_async(ex.run(len, [[1]], {}, {"dispatch_id": "d", "node_id": 0,
                                          "pip_deps": ["not-a-package"]}))
    assert _leftovers(tmp_path) == []


class _LateResultTransport(LocalTransport):
    """Runs the status probe as if the result appeared right after the
    probe's first look for it (the harness wrote it and exited then)."""

    async def run(self, command, timeout=None):
        return await super().run(command.replace("if test -f", "if false && test -f", 1), timeout)


@pytest.mark.parametrize("with_pid", [True, False])
def test_status_probe_sees_a_result_written_just_before_exit(tmp_path, run_async, with_pid):
    staged = StagedTask("op", tmp_path, str(tmp_path))
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()  # gone: reaped
    Path(staged.remote_pid_file).write_text(str(proc.pid))
    Path(staged.remote_result_file).write_bytes(b"x")
    ex = _executor(tmp_path)
    conn = _LateResultTransport()
    pid = proc.pid if with_pid else None
    assert run_async(ex.get_status(conn, staged, pid)).value == "READY"
    os.remove(staged.remote_result_file)
    assert run_async(ex.get_status(conn, staged, pid)).value == "DEAD"


def test_plugin_identity_globals():
    import covalent_tpu_plugin_torch.gpu as gpu_mod

    assert gpu_mod.EXECUTOR_PLUGIN_NAME == "GPUExecutor"
    defaults = gpu_mod._EXECUTOR_PLUGIN_DEFAULTS
    assert defaults["transport"] == "local" and defaults["poll_freq"] == 0.5
    assert "remote_workdir" in defaults and GPUExecutor.SHORT_NAME == "gpu"


def test_entry_point_declared_for_covalent_loader():
    setup_src = (REPO / "setup.py").read_text()
    assert "covalent.executor.executor_plugins" in setup_src
    assert re.search(r"gpu\s*=\s*covalent_tpu_plugin_torch\.gpu", setup_src)


_E2E_SCRIPT = r"""
import asyncio, sys

from tests.covalent_stub import FakeRemoteExecutor, install

store = {"executors.gpu.remote_workdir": sys.argv[1] + "/from-covalent-config"}
install(store)

# Imported after the stub: the covalent-present branches load.
from covalent_tpu_plugin_torch import GPUExecutor  # noqa: E402

assert issubclass(GPUExecutor, FakeRemoteExecutor), GPUExecutor.__mro__
# plugin-loader contract: the defaults were merged into covalent's config
assert store["executors.gpu.poll_freq"] == 0.5, store
tmp = sys.argv[1]
ex = GPUExecutor(cache_dir=f"{tmp}/cache", remote_cache=f"{tmp}/remote",
                 python_path=sys.executable, poll_freq=0.1, use_agent=False)
assert ex.template_init_ran
assert ex.remote_workdir == tmp + "/from-covalent-config", ex.remote_workdir
result = asyncio.run(ex.run(lambda a, b: a * b, [6, 7], {}, {"dispatch_id": "cov", "node_id": 0}))
assert result == 42 and ex.last_timings["execute"] >= 0
print("INTEROP-E2E-OK")
"""


def test_electron_end_to_end_on_the_covalent_template(tmp_path):
    """GPUExecutor subclassing Covalent's own RemoteExecutor (the shared stub
    in ``tests/covalent_stub.py``) runs a whole electron."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]),
               COVALENT_TPU_CONFIG=str(tmp_path / "unused.toml"))
    proc = subprocess.run([sys.executable, "-c", _E2E_SCRIPT, str(tmp_path)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "INTEROP-E2E-OK" in proc.stdout
