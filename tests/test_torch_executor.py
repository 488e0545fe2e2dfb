"""The port's executor, harness and package boundary, on the CPU.

``GPUExecutor(transport="local")`` stages an electron, launches the port's
own harness file in a subprocess, polls, fetches and cleans up, exactly as
it does on a GPU host; here the electrons run on CPU tensors.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from covalent_tpu_plugin_torch import GPUExecutor, harness
from covalent_tpu_plugin_torch.gpu import StagedTask

REPO = Path(__file__).resolve().parent.parent


def _executor(tmp_path, **kwargs):
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
    return sorted(
        p.name for d in ("cache", "remote") if (tmp_path / d).exists()
        for p in (tmp_path / d).iterdir()
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
    shipped = {Path(local).name: remote for local, remote in staged.uploads()}
    assert Path(harness.__file__).resolve().parent == REPO / "covalent_tpu_plugin_torch"
    assert shipped["harness.py"] == "remote/harness_op.py"
    assert "import covalent_tpu_plugin" not in Path(harness.__file__).read_text()


def test_executor_refuses_transports_of_later_slices():
    with pytest.raises(NotImplementedError, match="SSH transport"):
        GPUExecutor(transport="ssh")


def test_harness_refuses_spec_keys_of_later_slices(tmp_path):
    result = tmp_path / "result.pkl"
    spec = {"result_file": str(result), "function_file": "unused",
            "distributed": {"num_processes": 2}}
    assert harness.run_task(spec) == 1
    value, error = pickle.loads(result.read_bytes())
    assert value is None and isinstance(error, NotImplementedError)
    assert "distributed" in str(error)


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
    assert pickle.loads(result.read_bytes()) == (5, None)
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
    # the serving modules and the resident session's are among those walked
    assert {f"covalent_tpu_plugin_torch.{m}" for m in (
        "models.decode", "models.serve", "agent", "cache", "resilience", "serving",
        "serving.handle", "serving.supervisor", "transport.process")} <= set(walked.split())
    assert int(count) >= 27
    assert added == "[]"
