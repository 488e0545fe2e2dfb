"""The multi-process gang through the executor and the harness, on the CPU.

``GPUExecutor(workers=["w0", "w1"])`` stages one spec per process, each with
its ``distributed`` block; the port's harness joins the gang's
``torch.distributed`` group (gloo here) after the pip install and the
function file's digest check, runs the electron, and only process 0 writes
the result.  The watcher fails a gang whose process 1 dies first, at once,
with that worker blamed.  The gangs rendezvous on a free port
(``coordinator_port=0``), never a fixed one: the tier runs several test
processes at once.

The end-to-end electron trains the small LM of ``dryrun_multichip`` under
``MeshPlan(fsdp=2)``: its losses must equal one process's at the same
global batch within the single-process bound (atol 1e-5).
"""

import hashlib
import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from covalent_tpu_plugin_torch import GPUExecutor, harness
from covalent_tpu_plugin_torch.gpu import StagedTask
from covalent_tpu_plugin_torch.models import train
from covalent_tpu_plugin_torch.parallel import MeshPlan

REPO = Path(__file__).resolve().parent.parent
LOSS_ATOL = 1e-5
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=64,
            dtype=torch.float32, attention="reference")


def _executor(tmp_path, **kwargs):
    kwargs.setdefault("use_agent", False)
    return GPUExecutor(
        transport="local",
        cache_dir=str(tmp_path / "cache"),
        remote_cache=str(tmp_path / "remote"),
        remote_workdir=str(tmp_path / "work"),
        python_path=sys.executable,
        poll_freq=0.2,
        task_env={"PYTHONPATH": str(REPO)},
        **{"workers": ["w0", "w1"], "coordinator_port": 0, **kwargs},
    )


def _leftovers(tmp_path):
    """Staged files left on either side; the pool server's files and the
    harness and function pickle in the worker's CAS (under their digests)
    stay."""
    def content_addressed(p) -> bool:
        return (p.parent.name == "cas" and p.suffix in (".py", ".pkl")
                and p.stem == hashlib.sha256(p.read_bytes()).hexdigest())

    return sorted(p.name for d in ("cache", "remote", "remote/cas") if (tmp_path / d).exists()
                  for p in (tmp_path / d).iterdir()
                  if not p.name.startswith("pool_") and p.name != "cas"
                  and not content_addressed(p))


def _where_am_i(x):
    import os

    import torch
    import torch.distributed as dist

    total = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(total)
    return {"x": x, "rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "sum": float(total), "backend": dist.get_backend(), "env_rank": os.environ["RANK"]}


# -- the harness's distributed key ------------------------------------------------


def _stage(tmp_path, fn, **spec_extra):
    import cloudpickle

    fn_file, result = tmp_path / "fn.pkl", tmp_path / "result.pkl"
    fn_file.write_bytes(cloudpickle.dumps((fn, (), {})))
    spec = {"result_file": str(result), "function_file": str(fn_file), **spec_extra}
    return spec, result


@pytest.fixture()
def gang_env(monkeypatch):
    """The harness exports torch.distributed's variables into this process:
    put them back afterwards."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.setenv(key, "unset")


def _fake_join(calls):
    def join(block):
        calls.append(dict(block))
        return "gloo"
    return join


def test_harness_rank1_leaves_a_done_marker_and_no_result(tmp_path, monkeypatch, gang_env):
    calls = []
    monkeypatch.setattr(harness, "_join_gang", _fake_join(calls))
    block = {"coordinator_address": "127.0.0.1:8476", "num_processes": 2, "process_id": 1}
    spec, result = _stage(tmp_path, lambda: os.environ["RANK"], distributed=block)
    assert harness.run_task(spec) == 0
    assert not result.exists()
    assert (tmp_path / "result.pkl.done.1").read_text() == "done\n"
    assert calls == [block]
    assert (os.environ["RANK"], os.environ["WORLD_SIZE"], os.environ["MASTER_PORT"]) == (
        "1", "2", "8476")


def test_harness_rank1_marks_the_electrons_error_and_logs_it(tmp_path, monkeypatch, gang_env,
                                                            capsys):
    def raises():
        raise MemoryError("rank 1 ran out of memory")

    monkeypatch.setattr(harness, "_join_gang", _fake_join([]))
    block = {"coordinator_address": "127.0.0.1:8476", "num_processes": 2, "process_id": 1}
    spec, result = _stage(tmp_path, raises, distributed=block)
    assert harness.run_task(spec) == 0
    assert not result.exists()
    marker = (tmp_path / "result.pkl.done.1").read_text()
    assert marker.startswith("error ") and "rank 1 ran out of memory" in marker
    assert "Traceback" in capsys.readouterr().err


def test_harness_rank0_writes_the_result_and_its_rendezvous(tmp_path, monkeypatch, gang_env):
    monkeypatch.setattr(harness, "_join_gang", _fake_join([]))
    block = {"coordinator_address": "127.0.0.1:8476", "num_processes": 2, "process_id": 0}
    spec, result = _stage(tmp_path, lambda: "replicated", distributed=block)
    assert harness.run_task(spec) == 0
    value, error, times = pickle.loads(result.read_bytes())
    assert (value, error, times["backend"]) == ("replicated", None, "gloo")
    assert times["rendezvous"] >= 0
    assert not (tmp_path / "result.pkl.done.0").exists()


def test_harness_checks_the_function_digest_before_the_rendezvous(tmp_path, monkeypatch,
                                                                  gang_env):
    calls = []
    monkeypatch.setattr(harness, "_join_gang", _fake_join(calls))
    block = {"coordinator_address": "127.0.0.1:1", "num_processes": 2, "process_id": 0}
    spec, result = _stage(tmp_path, lambda: 1, distributed=block, function_digest="0" * 64)
    assert harness.run_task(spec) == 1
    value, error = pickle.loads(result.read_bytes())
    assert value is None and "content digest" in str(error)
    assert calls == []  # never joined


def test_harness_opens_gloo_without_cards(monkeypatch):
    import torch.distributed as dist

    seen = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    backend = harness._join_gang({"coordinator_address": "127.0.0.1:4321",
                                  "num_processes": 2, "process_id": 1})
    assert backend == seen["backend"] == "gloo"
    assert (seen["init_method"], seen["world_size"], seen["rank"]) == (
        "tcp://127.0.0.1:4321", 2, 1)


def test_staged_gang_files_are_per_process(tmp_path):
    staged = StagedTask("op", tmp_path, "remote", processes=2)
    assert staged.rank(0)["done"] == "remote/result_op.pkl"
    assert staged.rank(1) == {
        "spec": str(tmp_path / "spec_op_1.json"), "remote_spec": "remote/spec_op_1.json",
        "log": "remote/log_op_1.txt", "pid": "remote/pid_op.1",
        "done": "remote/result_op.pkl.done.1",
        "telemetry": "remote/telemetry_op.1.jsonl", "hb": "remote/pid_op.1.hb"}
    assert "remote/result_op.pkl.done.1" in staged.remote_files()
    single = StagedTask("op", tmp_path, "remote")
    assert single.rank(0)["spec"] == single.spec_file and single.rank(0)["pid"] == "remote/pid_op"


def test_a_gang_never_takes_the_rpc_road(tmp_path):
    ex = _executor(tmp_path, dispatch_mode="rpc", use_agent=True)
    assert ex._num_processes() == 2
    assert ex._rpc_preselect({}) is False
    assert ex._coordinator_address().startswith("127.0.0.1:")


def test_the_gang_defaults_come_from_the_config(tmp_path):
    ex = GPUExecutor(transport="local", cache_dir=str(tmp_path / "c"))
    assert (ex.workers, ex.coordinator_port) == ([], 8476)
    assert ex._num_processes() == 1


# -- gangs end to end ----------------------------------------------------------------


def test_a_two_process_electron_returns_rank_zeros_result(tmp_path, run_async):
    ex = _executor(tmp_path)
    out = run_async(ex.run(_where_am_i, [5], {}, {"dispatch_id": "g", "node_id": 0}))
    assert out == {"x": 5, "rank": 0, "world_size": 2, "sum": 3.0, "backend": "gloo",
                   "env_rank": "0"}
    assert ex.last_dispatch_mode == "launch"
    assert ex.last_timings["rendezvous"] >= 0
    assert _leftovers(tmp_path) == []


def test_a_rank1_pip_failure_fails_the_gang_fast_and_blames_worker_1(
        tmp_path, run_async, monkeypatch):
    # the stub pip fails on process 1 only: the harness exports RANK first
    monkeypatch.setenv("COVALENT_TPU_PIP_CMD", "sh -c 'test \"$RANK\" != 1' --")
    ex = _executor(tmp_path)
    with pytest.raises(RuntimeError) as err:
        run_async(ex.run(_where_am_i, [1], {}, {"dispatch_id": "g", "node_id": 1,
                                               "pip_deps": ["anything"]}))
    assert "process 1 (worker 'w1')" in str(err.value) and "DEAD" in str(err.value)
    assert "pip dependency install failed" in str(err.value)
    # process 0 waited in the rendezvous and was killed with the gang
    assert ex.last_timings["total"] < 60
    assert _leftovers(tmp_path) == []


def _fails_on_rank_1():
    import torch
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise MemoryError("rank 1 ran out of memory")
    total = torch.ones(1)
    dist.all_reduce(total)  # process 1 never joins it
    return float(total)


def test_an_electron_raising_on_rank_1_fails_the_gang_and_blames_worker_1(tmp_path,
                                                                          run_async):
    ex = _executor(tmp_path)
    with pytest.raises(RuntimeError) as err:
        run_async(ex.run(_fails_on_rank_1, [], {}, {"dispatch_id": "g", "node_id": 3}))
    assert "process 1 (worker 'w1')" in str(err.value) and "DEAD" in str(err.value)
    assert "MemoryError: rank 1 ran out of memory" in str(err.value)
    assert ex.last_timings["total"] < 60
    assert _leftovers(tmp_path) == []


def test_a_gang_trains_the_lm_like_one_process(tmp_path, run_async):
    """BASELINE config 5's path at a small size: ``train_lm`` under
    ``MeshPlan(fsdp=2)`` as a two-process gang electron, forked from the
    pool's zygote, against the same electron in one process."""
    kwargs = dict(steps=3, batch_size=4, seq_len=16, seed=0, device="cpu", **TINY)
    ex = _executor(tmp_path, use_agent="pool", pool_preload="cloudpickle")

    async def run():
        try:
            return await ex.run(train.train_lm, [], dict(kwargs, mesh_plan=MeshPlan(fsdp=2)),
                                {"dispatch_id": "g", "node_id": 2})
        finally:
            await ex.close()

    out = run_async(run())
    alone = train.train_lm(**kwargs)
    np.testing.assert_allclose(out["losses"], alone["losses"], rtol=0, atol=LOSS_ATOL)
    assert out["world_size"] == 2 and out["backend"] == "gloo"
    assert out["mesh"] == {"data": 1, "fsdp": 2, "tensor": 1, "seq": 1, "pipe": 1}
    assert [r["rank"] for r in out["ranks"]] == [0, 1]
    assert all(r["device"] == "cpu" for r in out["ranks"])
    assert ex.last_dispatch_mode == "launch"


def test_the_harness_refuses_a_spec_key_it_does_not_know(tmp_path, gang_env):
    spec = {"result_file": str(tmp_path / "r.pkl"), "function_file": "unused",
            "distributed": {"num_processes": 2, "process_id": 0,
                            "coordinator_address": "127.0.0.1:1"},
            "events_file": str(tmp_path / "events.jsonl")}
    assert harness.run_task(spec) == 1
    value, error = pickle.loads((tmp_path / "r.pkl").read_bytes())
    assert value is None and "events_file" in str(error)


def test_spec_files_carry_the_distributed_blocks(tmp_path):
    ex = _executor(tmp_path, coordinator_port=9123)
    staged = ex._write_function_files("op", _where_am_i, (1,), {}, str(tmp_path / "w"))
    specs = [json.loads(Path(staged.rank(i)["spec"]).read_text()) for i in range(2)]
    assert [s["distributed"] for s in specs] == [
        {"coordinator_address": "127.0.0.1:9123", "num_processes": 2, "process_id": i}
        for i in range(2)]
    assert specs[0]["pid_file"] != specs[1]["pid_file"]
    assert len({s["function_digest"] for s in specs}) == 1
