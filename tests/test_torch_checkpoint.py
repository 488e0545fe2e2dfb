"""The port's checkpoints against the JAX package's, on the CPU.

* The manifest: the same saves (steps out of order, ``keep_n=2``) through
  both harnesses' ``_write_checkpoint_bundle``: the manifests' histories
  (steps, in order) and the bundles left on disk agree.  Digests differ
  (the payloads are each package's pickles), so they are not compared.
* ``utils/checkpoint.py``: the reference's cases (``tests/test_checkpoint.py``)
  on the port's functions, torch tensors in place of jax arrays.
* A state sharded by FSDP2 (``DTensor`` leaves) over a two-process gloo
  gang goes through ``torch.distributed.checkpoint`` (a directory a step,
  each rank writing its shards), is restored by one process with no
  template, and placed by ``reshard_tree`` onto a one-process mesh: every
  parameter equal to the gang's.
* The harness's checkpointer: a hook's step high-water mark, the error
  event, and the preemption save that never waits.
"""

import hashlib
import json
import os
import sys
import threading
from pathlib import Path

import cloudpickle
import numpy as np
import pytest
import torch

from covalent_tpu_plugin import harness as jax_harness
from covalent_tpu_plugin_torch import harness
from covalent_tpu_plugin_torch.parallel.launch import run_gang
from covalent_tpu_plugin_torch.utils import (
    checkpoint_dir,
    host_tree,
    latest_step,
    prune_checkpoints,
    register_snapshot,
    reshard_tree,
    restore_checkpoint,
    resume_state,
    save_checkpoint,
    unregister_snapshot,
)
from covalent_tpu_plugin_torch.utils import checkpoint as ckpt_mod

SAVE_ORDERS = {
    "in_order": [1, 2, 3, 4],
    "out_of_order": [5, 2, 9, 3, 7],
    "a_step_saved_twice": [4, 6, 4, 2],
    "straggler_after_resume": [8, 10, 6, 12, 9],
}


def _history(directory: Path, lineage: str, module) -> list:
    path = Path(module._ckpt_manifest_path(str(directory), lineage))
    return json.loads(path.read_text())["history"]


@pytest.mark.parametrize("name", sorted(SAVE_ORDERS))
def test_manifest_histories_match_the_reference(name, tmp_path):
    lineage = "disp_0"
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    for i, step in enumerate(SAVE_ORDERS[name]):
        tree = {"w": np.full(3, float(step)), "i": i}
        path, digest, nbytes = harness._write_checkpoint_bundle(str(port_dir), lineage, step,
                                                                tree, keep_n=2)
        jax_harness._write_checkpoint_bundle(str(ref_dir), lineage, step, tree, keep_n=2)
        assert os.path.basename(path) == f"{digest}.ckpt"
        # a save that falls off the history at once is unlinked at once
        assert not os.path.exists(path) or nbytes == os.path.getsize(path)
    port, ref = _history(port_dir, lineage, harness), _history(ref_dir, lineage, jax_harness)
    assert [h["step"] for h in port] == [h["step"] for h in ref]
    assert len(port) == 2 and [h["step"] for h in port] == sorted(
        {h["step"] for h in port}, reverse=True)
    # the bundles left hold the same saves in both (a step saved twice
    # leaves its first bundle behind in both: the GC drops only what falls
    # off the history)
    def left(directory):
        out = []
        for bundle in directory.glob("*.ckpt"):
            with open(bundle, "rb") as f:
                payload = cloudpickle.load(f)
            out.append((payload["step"], payload["tree"]["i"]))
        return sorted(out)

    assert left(port_dir) == left(ref_dir)
    assert {h["step"] for h in port} <= {step for step, _ in left(port_dir)}
    for h in port:
        assert ckpt_mod.verify_bundle_file(h["file"], h["digest"])
        with open(h["file"], "rb") as f:
            assert cloudpickle.load(f)["step"] == h["step"]


def test_save_restore_roundtrip(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "step": 7, "name": "mlp"}
    save_checkpoint(tree, step=7, base=tmp_path)
    restored = restore_checkpoint(step=7, base=tmp_path)
    assert torch.equal(restored["w"], tree["w"])
    assert restored["step"] == 7 and restored["name"] == "mlp"


def test_latest_step_and_default_restore(tmp_path):
    assert latest_step(tmp_path) is None
    for step in (1, 5, 3):
        save_checkpoint({"s": step}, step=step, base=tmp_path)
    assert latest_step(tmp_path) == 5
    assert restore_checkpoint(base=tmp_path)["s"] == 5


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(base=tmp_path)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(step=9, base=tmp_path)


def test_tensors_materialise_to_detached_host_copies(tmp_path):
    p = torch.ones(4, 4, requires_grad=True) * 2
    save_checkpoint({"p": p}, step=0, base=tmp_path)
    restored = restore_checkpoint(step=0, base=tmp_path)
    assert not restored["p"].requires_grad and torch.equal(restored["p"], p.detach())
    # a host copy, even of a host tensor: the optimizer updates in place
    state = torch.zeros(2)
    copy = host_tree({"s": state})["s"]
    state.add_(1)
    assert torch.equal(copy, torch.zeros(2))


def test_checkpoint_dir_honors_the_workdir_contract(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    save_checkpoint({"x": 1}, step=2)
    assert (tmp_path / "checkpoints" / "step_2").exists()
    assert restore_checkpoint()["x"] == 1
    assert checkpoint_dir() == tmp_path / "checkpoints"


def test_format_mismatch_raises_a_descriptive_error(tmp_path):
    """A step in one layout is never clobbered by, nor read as, the other."""
    (tmp_path / "step_1").mkdir()
    (tmp_path / "step_1" / ".metadata").write_bytes(b"")
    with pytest.raises(RuntimeError, match="torch.distributed.checkpoint directory"):
        save_checkpoint({"x": torch.ones(1)}, step=1, base=tmp_path)


def test_a_sharded_state_refuses_a_single_file_step(tmp_path, monkeypatch):
    save_checkpoint({"x": torch.ones(1)}, step=1, base=tmp_path)
    shard = object()  # stands for a DTensor leaf: only the test below reads it
    monkeypatch.setattr(ckpt_mod, "_is_dtensor", lambda leaf: leaf is shard)
    with pytest.raises(RuntimeError, match="single-file checkpoint"):
        save_checkpoint({"x": shard}, step=1, base=tmp_path)


def test_a_process_other_than_0_skips_the_write(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt_mod, "_process_index", lambda: 1)
    target = save_checkpoint({"x": 1}, step=3, base=tmp_path)
    assert not target.exists()
    target = save_checkpoint({"x": 1}, step=3, base=tmp_path / "proc1", per_process=True)
    assert target.exists()


def test_keep_n_prunes_old_steps(tmp_path):
    for step in range(6):
        save_checkpoint({"s": step}, step=step, base=tmp_path, keep_n=3)
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                   if p.name.startswith("step_"))
    assert steps == [3, 4, 5]
    (tmp_path / ".tmp_step_9.123.deadbeef").write_bytes(b"torn")
    assert latest_step(tmp_path) == 5
    assert prune_checkpoints(tmp_path, keep_n=1) == [4, 3]
    assert latest_step(tmp_path) == 5


def test_snapshot_registry_roundtrip():
    assert ckpt_mod.take_snapshot() is None
    state = {"acc": 1.5}
    register_snapshot(lambda: (dict(state), 4))
    try:
        tree, step = ckpt_mod.take_snapshot()
        assert tree == {"acc": 1.5} and step == 4
        with pytest.raises(TypeError):
            register_snapshot("not-callable")
    finally:
        unregister_snapshot()
    assert ckpt_mod.take_snapshot() is None


def test_resume_state_env_contract(tmp_path, monkeypatch):
    payload = cloudpickle.dumps({"v": 1, "step": 11, "tree": {"w": torch.ones(3)}, "meta": {}})
    bundle = tmp_path / "bundle.ckpt"
    bundle.write_bytes(payload)
    monkeypatch.delenv(ckpt_mod.RESUME_PATH_ENV, raising=False)
    assert resume_state() is None  # a cold start: nothing shipped
    monkeypatch.setenv(ckpt_mod.RESUME_PATH_ENV, str(bundle))
    monkeypatch.setenv(ckpt_mod.RESUME_DIGEST_ENV, hashlib.sha256(payload).hexdigest())
    step, tree = resume_state(map_location="cpu")
    assert step == 11 and torch.equal(tree["w"], torch.ones(3))
    bundle.write_bytes(payload[: len(payload) // 2])  # torn: None, never garbage
    assert resume_state() is None


def _tiny_config():
    from covalent_tpu_plugin_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                             max_seq=32, dtype=torch.float32, param_dtype=torch.float32,
                             logits_dtype=torch.float32)


def _save_fsdp2(path: str, config) -> dict:
    """On each rank of a two-process gang: the LM sharded by FSDP2, one
    AdamW step, its state saved through torch.distributed.checkpoint."""
    import torch

    from covalent_tpu_plugin_torch.models import train as tr
    from covalent_tpu_plugin_torch.models.data import synthetic_lm_batches
    from covalent_tpu_plugin_torch.models.transformer import TransformerLM
    from covalent_tpu_plugin_torch.parallel import MeshPlan
    from covalent_tpu_plugin_torch.parallel.mesh import make_mesh
    from covalent_tpu_plugin_torch.utils import checkpoint as ckpt

    model = TransformerLM(config, device="cpu", generator=torch.Generator().manual_seed(0))
    mesh = make_mesh(MeshPlan(fsdp=2), device_type="cpu")
    model, optimizer, shardings = tr.make_sharded_train_state(model, tr.adamw, mesh)
    step = tr.make_train_step(model, optimizer, mesh=mesh)
    step(next(iter(synthetic_lm_batches(1, 4, 17, config.vocab_size, seed=1))))
    state = model.state_dict()
    path_saved = ckpt.save_checkpoint({"model": state, "step": 1}, 1, path, keep_n=2)
    return {"kinds": sorted({type(v).__name__ for v in state.values()}),
            "full": ckpt.host_tree(state), "shardings": shardings,
            "is_dir": path_saved.is_dir()}


def _restore_on_one(path: str, shardings: dict) -> dict:
    """One process: the directory restored with no template, then placed
    onto a one-process mesh by reshard_tree."""
    from covalent_tpu_plugin_torch.parallel import MeshPlan
    from covalent_tpu_plugin_torch.parallel.mesh import make_mesh
    from covalent_tpu_plugin_torch.utils import checkpoint as ckpt

    tree = ckpt.restore_checkpoint(base=path)
    mesh = make_mesh(MeshPlan(fsdp=1), device_type="cpu")
    placed = ckpt.reshard_tree(tree["model"], mesh, shardings={
        k: shardings.get(k) for k in tree["model"]})
    replicated = ckpt.reshard_tree(tree["model"], mesh)
    return {"step": tree["step"], "full": {k: v.full_tensor() for k, v in placed.items()},
            "replicated": {k: v.full_tensor() for k, v in replicated.items()},
            "kinds": sorted({type(v).__name__ for v in placed.values()})}


def test_an_fsdp2_state_saves_by_dcp_and_restores_resharded_on_one_process(tmp_path):
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        saved = run_gang(_save_fsdp2, 2, (str(tmp_path), _tiny_config()), timeout_s=240)
        assert saved[0]["kinds"] == ["DTensor"] and saved[0]["is_dir"]
        assert sorted(p.name for p in (tmp_path / "step_1").iterdir()) == [
            ".metadata", "__0_0.distcp", "__1_0.distcp"]  # each rank its shards
        restored = run_gang(_restore_on_one, 1, (str(tmp_path), saved[0]["shardings"]),
                            timeout_s=240)[0]
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    want = saved[0]["full"]
    assert all(torch.equal(saved[1]["full"][k], want[k]) for k in want)  # ranks agree
    assert restored["step"] == 1 and restored["kinds"] == ["DTensor"]
    for name in want:
        assert torch.equal(restored["full"][name], want[name]), name
        assert torch.equal(restored["replicated"][name], want[name]), name
    # and with no process group at all: full host tensors
    plain = restore_checkpoint(base=tmp_path)
    assert all(torch.equal(plain["model"][k], want[k]) for k in want)


def test_reshard_tree_reads_placements_or_mesh_axes():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("data", "fsdp")
        ndim = 2

    assert ckpt_mod._placements(None, Mesh(), 2) == [Replicate(), Replicate()]
    assert ckpt_mod._placements((None, "fsdp"), Mesh(), 2) == [Replicate(), Shard(1)]
    assert ckpt_mod._placements((("data", "fsdp"),), Mesh(), 2) == [Shard(0), Shard(0)]
    assert ckpt_mod._placements([Shard(1), Replicate()], Mesh(), 2) == [Shard(1), Replicate()]
    with pytest.raises(ValueError, match="tensor"):
        ckpt_mod._placements((None, None, "data"), Mesh(), 2)
    with pytest.raises(ValueError, match="mesh axis"):
        ckpt_mod._placements(("seq",), Mesh(), 1)
    assert reshard_tree({"n": 3, "s": "x"}, Mesh()) == {"n": 3, "s": "x"}


# -- the harness's checkpointer ---------------------------------------------


def _checkpointer(tmp_path, monkeypatch, interval: float = 3600.0):
    spec = {"operation_id": "op", "telemetry_file": str(tmp_path / "telemetry.jsonl"),
            "checkpoint": {"dir": str(tmp_path / "cas"), "lineage": "lin_0",
                           "interval_s": interval, "keep_n": 2}}
    monkeypatch.setitem(sys.modules, harness._CHECKPOINT_MODULE, ckpt_mod)
    stop, save_now = harness._start_checkpointer(spec)
    return spec, stop, save_now


def _events(tmp_path):
    path = tmp_path / "telemetry.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def test_the_checkpointer_saves_only_newer_steps(tmp_path, monkeypatch):
    spec, stop, save_now = _checkpointer(tmp_path, monkeypatch)
    try:
        assert save_now("interval") is None  # no hook registered
        state = {"step": 2}
        register_snapshot(lambda: ({"w": torch.full((2,), float(state["step"]))},
                                   state["step"]))
        assert save_now("interval") == 2
        assert save_now("interval") is None  # nothing new
        state["step"] = 5
        assert save_now("preempt") == 5
    finally:
        unregister_snapshot()
        stop.set()
    saved = [e for e in _events(tmp_path) if e["type"] == "worker.checkpoint_saved"]
    assert [(e["step"], e["trigger"]) for e in saved] == [(2, "interval"), (5, "preempt")]
    assert all(e["lineage"] == "lin_0" and e["bytes"] > 0 and e["save_s"] >= 0 for e in saved)
    assert [h["step"] for h in _history(tmp_path / "cas", "lin_0", harness)] == [5, 2]


def test_a_failing_hook_is_an_error_event_not_a_failed_task(tmp_path, monkeypatch):
    spec, stop, save_now = _checkpointer(tmp_path, monkeypatch)

    def broken():
        raise ValueError("torn state")

    register_snapshot(broken)
    try:
        assert save_now("interval") is None
    finally:
        unregister_snapshot()
        stop.set()
    errors = [e for e in _events(tmp_path) if e["type"] == "worker.checkpoint_error"]
    assert len(errors) == 1 and "torn state" in errors[0]["error"]


def test_the_preemption_save_gives_up_on_a_hook_in_flight(tmp_path, monkeypatch):
    """While the interval thread is inside the hook (it may wait on the
    step the SIGTERM handler interrupted), the handler waits at most
    PREEMPT_TAKE_WAIT_S, then dies with nothing saved."""
    spec, stop, save_now = _checkpointer(tmp_path, monkeypatch)
    monkeypatch.setattr(harness, "PREEMPT_TAKE_WAIT_S", 0.1)
    entered, release = threading.Event(), threading.Event()

    def slow_hook():
        entered.set()
        release.wait(30)
        return {"w": torch.zeros(1)}, 1

    register_snapshot(slow_hook)
    worker = threading.Thread(target=save_now, args=("interval",))
    try:
        worker.start()
        assert entered.wait(30)
        assert save_now("preempt") is None  # did not wait for the hook to return
    finally:
        release.set()
        worker.join(30)
        unregister_snapshot()
        stop.set()
    assert [e["trigger"] for e in _events(tmp_path)
            if e["type"] == "worker.checkpoint_saved"] == ["interval"]


def test_the_preemption_save_waits_for_a_bundle_being_written(tmp_path, monkeypatch):
    """A save in flight that is writing its bundle finishes on its own: the
    handler waits for it, then saves the newer step it finds."""
    spec, stop, save_now = _checkpointer(tmp_path, monkeypatch)
    writing, release = threading.Event(), threading.Event()
    write = harness._write_checkpoint_bundle

    def slow_write(*args):
        if args[2] == 1:
            writing.set()
            release.wait(30)
        return write(*args)

    monkeypatch.setattr(harness, "_write_checkpoint_bundle", slow_write)
    # Each save's record leaves after it releases the lock (as the
    # reference's does), so the preempt's record could overtake the
    # interval's on a busy machine; the executor files records by step, so
    # their order is not the point: hold the preempt's until the interval's
    # is out.
    emit, interval_saved = harness._emit_worker_event, threading.Event()

    def ordered_emit(spec, kind, **fields):
        if kind == "worker.checkpoint_saved" and fields.get("trigger") == "preempt":
            interval_saved.wait(30)
        emit(spec, kind, **fields)
        if kind == "worker.checkpoint_saved" and fields.get("trigger") == "interval":
            interval_saved.set()

    monkeypatch.setattr(harness, "_emit_worker_event", ordered_emit)
    state = {"step": 1}
    register_snapshot(lambda: ({"w": torch.full((1,), float(state["step"]))}, state["step"]))
    interval = threading.Thread(target=save_now, args=("interval",))
    got = {}
    preempt = threading.Thread(target=lambda: got.update(step=save_now("preempt")))
    try:
        interval.start()
        assert writing.wait(30)
        state["step"] = 2
        preempt.start()
        release.set()
        interval.join(30)
        preempt.join(30)
    finally:
        release.set()
        unregister_snapshot()
        stop.set()
    assert got == {"step": 2}
    assert [(e["step"], e["trigger"]) for e in _events(tmp_path)
            if e["type"] == "worker.checkpoint_saved"] == [(1, "interval"), (2, "preempt")]


def test_no_checkpoint_block_means_no_checkpointer(tmp_path):
    assert harness._start_checkpointer({"operation_id": "op"}) == (None, None)
    gang_rank = {"checkpoint": {"dir": str(tmp_path), "interval_s": 1.0},
                 "distributed": {"process_id": 1}}
    assert harness._start_checkpointer(gang_rank) == (None, None)


def test_a_new_run_of_the_lineage_drops_the_earlier_runs_saves(tmp_path):
    """The same node dispatched again is new work: its first save drops
    the earlier run's history and bundles from the manifest's directory."""
    for step in (7, 9):
        harness._write_checkpoint_bundle(str(tmp_path), "disp_0", step, {"s": step}, 2,
                                         run="disp_0_aaaa")
    path, _, _ = harness._write_checkpoint_bundle(str(tmp_path), "disp_0", 1, {"s": 1}, 2,
                                                  run="disp_0_bbbb")
    manifest = json.loads(Path(harness._ckpt_manifest_path(str(tmp_path), "disp_0")).read_text())
    assert manifest["run"] == "disp_0_bbbb" and [h["step"] for h in manifest["history"]] == [1]
    assert [p.name for p in tmp_path.glob("*.ckpt")] == [os.path.basename(path)]
