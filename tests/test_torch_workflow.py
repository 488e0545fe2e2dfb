"""The port's workflow layer (``covalent_tpu_plugin_torch.workflow``) on the CPU.

Counterparts of ``tests/test_workflow.py`` and of the workflow half of
``tests/test_deps.py``, each run on ``executor="local"`` (in-process) and on
``executor="gpu"`` (``GPUExecutor`` from its config section: every electron
in a harness subprocess, on CPU tensors where it uses torch); then one
lattice through both workflow packages, which must agree on outputs,
statuses and node events, and an MNIST lattice whose losses must equal the
reference's.  Concurrency is shown by electrons that wait for each other,
never by a wall-clock bound.
"""

import json
import os
import shlex
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import covalent_tpu_plugin.workflow as ref_ct
from covalent_tpu_plugin.obs import events as ref_events
import covalent_tpu_plugin_torch.workflow as ct
from covalent_tpu_plugin_torch.gpu import GPUExecutor
from covalent_tpu_plugin_torch.obs import events
from covalent_tpu_plugin_torch.utils import config as config_mod
from covalent_tpu_plugin_torch.workflow import runner
from covalent_tpu_plugin_torch.workflow.deps import wrap_task

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def gpu_config(tmp_path, monkeypatch):
    """``executor="gpu"`` builds a ``GPUExecutor`` from ``[executors.gpu]``:
    point it at this test's directories, this interpreter and the checkout
    (electrons that import the port need it on the worker's path)."""
    monkeypatch.setenv("COVALENT_TPU_CONFIG", str(tmp_path / "config.toml"))
    config_mod._reset_cache_for_tests()
    settings = {
        "cache_dir": str(tmp_path / "cache"),
        "remote_cache": str(tmp_path / "remote"),
        "remote_workdir": str(tmp_path / "work"),
        "python_path": sys.executable,
        "poll_freq": 0.1,
        "task_env": {"PYTHONPATH": str(REPO)},
        # launch mode through nohup + poll; the pool's tests opt in to it
        "use_agent": False,
    }
    for key, value in settings.items():
        config_mod.set_config(f"executors.gpu.{key}", value)
    yield settings
    config_mod._reset_cache_for_tests()


@pytest.fixture(params=["local", "gpu"])
def executor(request):
    if request.param == "gpu":
        request.getfixturevalue("gpu_config")
    return request.param


def _recorder_cmd(record_file) -> str:
    """A fake pip: records its arguments as JSON and exits 0."""
    return (
        f"{shlex.quote(sys.executable)} -c "
        + shlex.quote(f"import json,sys; json.dump(sys.argv[1:], open({str(record_file)!r}, 'w'))")
    )


# --------------------------------------------------------------------------- #
# Tracing the DAG                                                             #
# --------------------------------------------------------------------------- #


def test_electron_and_lattice_direct_calls_run_inline():
    @ct.electron
    def add(a, b):
        return a + b

    @ct.lattice
    def flow(x):
        return add(x, 1)

    assert add(2, 3) == 5
    assert flow(4) == 5


def test_trace_records_nodes_and_edges_in_containers():
    @ct.electron
    def make(x):
        return x

    @ct.electron
    def consume(items, mapping):
        return sum(items) + mapping["k"]

    @ct.lattice
    def flow():
        a = make(1)
        b = make(2)
        return consume([a, b], {"k": a})

    graph = flow.build_graph()
    assert [n.name for n in graph.nodes] == ["make", "make", "consume"]
    assert graph.nodes[2].dependencies() == {0, 1}
    assert isinstance(graph.output, ct.Node)
    with pytest.raises(RuntimeError, match="nested"):
        ct.lattice(lambda: flow.build_graph()).build_graph()


def test_positional_electron_call_keeps_executor():
    marker = object()
    assert ct.electron(lambda: 1, executor=marker).executor is marker


# --------------------------------------------------------------------------- #
# Dispatch on both executors                                                  #
# --------------------------------------------------------------------------- #


def test_dispatch_success_end_to_end(executor):
    @ct.electron(executor=executor)
    def add(a, b):
        return a + b

    @ct.electron(executor=executor)
    def square(a):
        return a * a

    @ct.lattice
    def flow(x, y):
        return square(add(x, y))

    dispatch_id = ct.dispatch(flow)(2, 3)
    result = ct.get_result(dispatch_id, wait=True, timeout=120)
    assert result.status is ct.Status.COMPLETED, result.error
    assert result.result == 25
    assert result.node_outputs == {0: 5, 1: 25}


def test_dispatch_failure_marks_only_the_failing_node(executor):
    @ct.electron(executor=executor)
    def boom():
        raise ValueError("only-here")

    @ct.electron(executor=executor)
    def downstream(x):
        return x

    @ct.lattice
    def flow():
        return downstream(boom())

    result = ct.dispatch_sync(flow)()
    assert result.status is ct.Status.FAILED
    assert list(result.node_errors) == [0]
    assert result.error.count("ValueError: only-here") == 1


def test_independent_electrons_run_concurrently(executor, tmp_path):
    """Four electrons that each wait for all four to arrive: they finish
    only if they run at once."""

    @ct.electron(executor=executor)
    def meet(i, where, n):
        import os
        import time

        open(os.path.join(where, str(i)), "w").close()
        deadline = time.monotonic() + 90
        while len(os.listdir(where)) < n:
            if time.monotonic() > deadline:
                raise TimeoutError("the other electrons never arrived: they did not run at once")
            time.sleep(0.01)
        return i

    @ct.lattice
    def fan_out(where):
        return [meet(i, where, 4) for i in range(4)]

    result = ct.dispatch_sync(fan_out)(str(tmp_path))
    assert result.status is ct.Status.COMPLETED, result.error
    assert result.result == [0, 1, 2, 3]


def test_deps_and_hooks_run_on_the_worker(executor, tmp_path, monkeypatch):
    record = tmp_path / "pip_args.json"
    monkeypatch.setenv("COVALENT_TPU_PIP_CMD", _recorder_cmd(record))
    bash_marker, hook_marker, after_marker = (tmp_path / n for n in ("bash", "before", "after"))

    @ct.electron(
        executor=executor,
        deps_pip=["cloudpickle"],  # a bare list, as upstream accepts
        deps_bash=[f"echo ran > {bash_marker}"],
        call_before=[ct.DepsCall(lambda p: open(p, "w").close(), (str(hook_marker),))],
        call_after=[ct.DepsCall(lambda p: open(p, "w").close(), (str(after_marker),))],
    )
    def task(x, marker):
        import os

        return x * 10, os.path.exists(marker)

    @ct.lattice
    def flow(x):
        return task(x, str(hook_marker))

    result = ct.dispatch_sync(flow)(4)
    assert result.status is ct.Status.COMPLETED, result.error
    assert result.result == (40, True)  # call_before ran before the body
    assert json.loads(record.read_text()) == ["cloudpickle"]
    assert bash_marker.read_text().strip() == "ran" and after_marker.exists()


def test_deps_bash_failure_fails_the_electron(executor):
    @ct.electron(executor=executor, deps_bash=["exit 3"])
    def task():
        return "unreachable"

    @ct.lattice
    def flow():
        return task()

    result = ct.dispatch_sync(flow)()
    assert result.status is ct.Status.FAILED
    assert "DepsBash" in result.error and "exit 3" in result.error


def _proc_gone(pid: int) -> bool:
    """The process has exited (a zombie left unreaped counts as gone)."""
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        return True
    return state in ("Z", "X")


def _wait_for(predicate, what: str, timeout: float = 90.0) -> None:
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def test_cancel_running_dispatch(executor, tmp_path):
    started, release, finished = (tmp_path / n for n in ("started", "release", "finished"))

    @ct.electron(executor=executor)
    def slow(started, release, finished):
        import os
        import time

        with open(started, "w") as f:
            f.write(str(os.getpid()))
        deadline = time.monotonic() + 60
        while not os.path.exists(release) and time.monotonic() < deadline:
            time.sleep(0.05)
        open(finished, "w").close()
        return "done"

    @ct.lattice
    def flow():
        return slow(str(started), str(release), str(finished))

    dispatch_id = ct.dispatch(flow)()
    try:
        _wait_for(lambda: started.exists() and started.read_text(), "the electron to start")
        result = ct.cancel(dispatch_id)
        assert result.status is ct.Status.CANCELLED
        assert not finished.exists()
        if executor == "gpu":  # the harness was killed, not left running
            _wait_for(lambda: _proc_gone(int(started.read_text())), "the worker to die", 30)
    finally:
        release.touch()  # an in-process electron cannot be killed: let it end


def test_cancel_finished_and_fresh_dispatches_return_final_results():
    @ct.electron
    def quick():
        return 5

    @ct.lattice
    def flow():
        return quick()

    dispatch_id = ct.dispatch(flow)()
    assert ct.get_result(dispatch_id, wait=True).status is ct.Status.COMPLETED
    assert ct.cancel(dispatch_id).status is ct.Status.COMPLETED
    # cancel may land before, during or after the run: always final
    result = ct.cancel(ct.dispatch(flow)())
    assert result._done.is_set()
    assert result.status in (ct.Status.CANCELLED, ct.Status.COMPLETED)


# --------------------------------------------------------------------------- #
# Aliases, result store                                                       #
# --------------------------------------------------------------------------- #


def test_unknown_executor_alias_fails_dispatch():
    @ct.electron(executor="warp-drive")
    def task():
        return 1

    @ct.lattice
    def flow():
        return task()

    result = ct.dispatch_sync(flow)()
    assert result.status is ct.Status.FAILED
    assert "warp-drive" in result.error


def test_builtin_aliases(gpu_config):
    assert isinstance(ct.resolve_executor("local"), ct.LocalExecutor)
    executor = ct.resolve_executor("gpu")
    assert isinstance(executor, GPUExecutor)
    assert executor.python_path == sys.executable  # from [executors.gpu]
    assert executor.cache_dir == gpu_config["cache_dir"]
    instance = GPUExecutor(poll_freq=0.3)
    assert ct.resolve_executor(instance) is instance and instance.poll_freq == 0.3
    with pytest.raises(NotImplementedError, match="slice 5"):
        ct.resolve_executor("fleet")


def test_get_result_unknown_id_raises():
    with pytest.raises(ValueError, match="unknown dispatch_id"):
        ct.get_result("nope")


def test_results_store_bounded_retention(monkeypatch):
    from covalent_tpu_plugin_torch.obs.metrics import REGISTRY

    monkeypatch.setenv("COVALENT_TPU_RESULT_RETENTION", "2")

    @ct.electron
    def ident(x):
        return x

    @ct.lattice
    def flow(x):
        return ident(x)

    evicted = REGISTRY.get("covalent_tpu_results_evicted_total")
    evicted0 = evicted.value if evicted else 0.0
    ids = []
    for i in range(5):
        dispatch_id = ct.dispatch(flow)(i)
        assert ct.get_result(dispatch_id, wait=True, timeout=30).result == i
        ids.append(dispatch_id)
    with runner._RESULTS_LOCK:
        terminal = [k for k, r in runner._RESULTS.items() if r._done.is_set()]
    assert len(terminal) <= 2
    with pytest.raises(ValueError, match="unknown dispatch_id"):
        ct.get_result(ids[0])
    assert ct.get_result(ids[-1]).result == 4
    assert REGISTRY.get("covalent_tpu_results_evicted_total").value - evicted0 >= 3


def test_result_retention_invalid_env_falls_back(monkeypatch):
    monkeypatch.setenv("COVALENT_TPU_RESULT_RETENTION", "not-a-number")
    assert runner._result_retention() == runner._DEFAULT_RESULT_RETENTION
    monkeypatch.setenv("COVALENT_TPU_RESULT_RETENTION", "0")
    assert runner._result_retention() == 1


def test_ops_port_is_refused_with_one_warning(tmp_path):
    """The ops endpoint comes with slice 5: the runner says so once."""
    script = (
        "import covalent_tpu_plugin_torch.workflow as ct\n"
        "flow = ct.lattice(lambda: ct.electron(lambda: 7)())\n"
        "print(ct.dispatch_sync(flow)().result, ct.dispatch_sync(flow)().result)\n"
    )
    env = dict(os.environ, COVALENT_TPU_OPS_PORT="0",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["7", "7"]
    assert proc.stderr.count("no ops endpoint yet: it comes with slice 5") == 1


# --------------------------------------------------------------------------- #
# Dependencies (the workflow half of tests/test_deps.py)                      #
# --------------------------------------------------------------------------- #


def test_deps_pip_from_list_string_and_requirements_file(tmp_path):
    assert ct.DepsPip(packages=["numpy==1.23.2", "scikit-learn"]).packages == [
        "numpy==1.23.2", "scikit-learn"]
    assert ct.DepsPip(packages="einops").packages == ["einops"]
    assert ct.DepsPip().packages == []
    reqs = tmp_path / "requirements.txt"
    reqs.write_text("# comment\nnumpy==1.23.2\n\nscikit-learn==1.1.2\n")
    assert ct.DepsPip(reqs_path=str(reqs)).packages == ["numpy==1.23.2", "scikit-learn==1.1.2"]


def test_call_hooks_run_in_order_even_when_the_body_raises():
    events_seen = []

    @ct.electron(call_before=[lambda: events_seen.append("before")],
                 call_after=[lambda: events_seen.append("after")])
    def task(x):
        events_seen.append("body")
        return x + 1

    assert task(1) == 2
    assert events_seen == ["before", "body", "after"]
    events_seen.clear()
    fn = wrap_task(lambda: (_ for _ in ()).throw(ValueError("boom")),
                   call_before=[ct.DepsCall(events_seen.append, ("before",))],
                   call_after=[ct.DepsCall(events_seen.append, ("after",))])
    with pytest.raises(ValueError):
        fn()
    assert events_seen == ["before", "after"]


def test_hooked_task_unpickles_without_the_package(tmp_path):
    """The wrapper pickles by value: a process that cannot import this
    package (as the harness subprocess need not) runs it."""
    import cloudpickle

    marker = tmp_path / "hook_ran"
    fn = wrap_task(lambda x: x * 2,
                   call_before=[ct.DepsCall(lambda p: open(p, "w").close(), (str(marker),))],
                   call_after=[])
    (tmp_path / "fn.pkl").write_bytes(cloudpickle.dumps(fn))
    script = (
        "import sys, cloudpickle\n"
        "fn = cloudpickle.loads(open('fn.pkl', 'rb').read())\n"
        "print(fn(21), any(m.startswith('covalent_tpu_plugin') for m in sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["42", "False"]
    assert marker.exists()


# --------------------------------------------------------------------------- #
# Against the reference workflow package                                      #
# --------------------------------------------------------------------------- #


def _square(x):
    return x * x


def _join(*parts):
    return sum(parts)


def _boom(x):
    raise ValueError(f"boom {x}")


def _plus_one(x):
    return x + 1


def _run_lattice(pkg, events_module):
    """Fan-out, join, a failing node, a skipped downstream and a completed
    one, on ``pkg``'s LocalExecutor; its node events by node."""
    seen = []
    events_module.add_listener(seen.append)
    try:
        square, join, boom, plus_one = (pkg.electron(f) for f in (_square, _join, _boom, _plus_one))

        @pkg.lattice
        def flow(n):
            total = join(*[square(i) for i in range(n)])
            return {"skipped": plus_one(boom(total)), "done": plus_one(total)}

        result = pkg.dispatch_sync(flow)(4)
    finally:
        events_module.remove_listener(seen.append)
    by_node: dict = {}
    for event in seen:
        if event["type"] == "node.state" and event["dispatch_id"] == result.dispatch_id:
            by_node.setdefault(event["node_id"], []).append(
                {k: v for k, v in event.items() if k not in ("ts", "pid", "dispatch_id")})
    return result, by_node


def test_one_lattice_through_both_workflow_packages():
    ref, ref_events_by_node = _run_lattice(ref_ct, ref_events)
    port, port_events_by_node = _run_lattice(ct, events)
    assert port.status.value == ref.status.value == "FAILED"
    assert port.node_outputs == ref.node_outputs == {0: 0, 1: 1, 2: 4, 3: 9, 4: 14, 7: 15}
    assert list(port.node_errors) == list(ref.node_errors) == [5]
    assert port.node_errors[5].splitlines()[-1] == ref.node_errors[5].splitlines()[-1]
    assert port_events_by_node == ref_events_by_node
    assert port_events_by_node[6] == [
        {"type": "node.state", "node_id": 6, "node": "_plus_one", "state": "skipped",
         "upstream_failed": [5]}]


def test_mnist_lattice_on_gpu_executor_matches_the_reference(gpu_config):
    """The slice as a whole on the CPU: a port lattice on ``executor="gpu"``
    (harness subprocess, ``device="cpu"``) trains the MLP from the
    reference's weights; a reference lattice trains the Flax MLP with optax.
    The losses of 5 Adam steps agree at rtol 1e-4."""

    def ref_train(steps):
        import jax
        import optax

        from covalent_tpu_plugin.models.mlp import MLP, synthetic_mnist
        from covalent_tpu_plugin.models.train import classifier_loss

        model = MLP()
        batches = [synthetic_mnist(32, seed=i) for i in range(steps)]
        params = model.init(jax.random.PRNGKey(0), batches[0]["image"])["params"]
        start = jax.tree.map(np.asarray, params)
        tx = optax.adam(1e-3)
        opt = tx.init(params)
        losses = []
        for batch in batches:
            loss, grads = jax.value_and_grad(
                lambda p: classifier_loss(p, model.apply, batch))(params)
            updates, opt = tx.update(grads, opt, params)
            params = optax.apply_updates(params, updates)
            losses.append(float(loss))
        return {"params": start, "losses": losses}

    def port_train(params, steps):
        import os

        from covalent_tpu_plugin_torch.models import (
            MLP, adam, make_classifier_train_step, mlp_params_from_jax, synthetic_mnist)

        model = MLP(device="cpu")
        model.load_state_dict(mlp_params_from_jax(params))
        step = make_classifier_train_step(model, adam(model))
        losses = [float(step(synthetic_mnist(32, seed=i))["loss"]) for i in range(steps)]
        return {"losses": losses, "pid": os.getpid()}

    ref_flow = ref_ct.lattice(lambda steps: ref_ct.electron(ref_train)(steps))
    ref = ref_ct.dispatch_sync(ref_flow)(5)
    assert ref.status is ref_ct.Status.COMPLETED, ref.error
    port_flow = ct.lattice(
        lambda params, steps: ct.electron(port_train, executor="gpu")(params, steps))
    port = ct.dispatch_sync(port_flow)(ref.result["params"], 5)
    assert port.status is ct.Status.COMPLETED, port.error
    assert port.result["pid"] != os.getpid()  # it ran in the harness subprocess
    np.testing.assert_allclose(port.result["losses"], ref.result["losses"], rtol=1e-4)
    assert port.result["losses"][-1] < port.result["losses"][0]
