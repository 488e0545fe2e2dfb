"""Elastic electrons on the CPU: checkpoint-resume under preemption, stalls
and a dying resident worker, through the port's executor with real harness
subprocesses (the reference's ``tests/test_elastic.py``), then the LM across
a resume against the JAX package's uninterrupted training.

Every trigger is an event: the preemption is armed by the dispatcher's
record of a checkpoint (:class:`PreemptAfterCheckpoint`, a listener on
``worker.checkpoint_saved`` that raises the reference-shaped plan's
``preempt_after``), the electrons hold at a step until the SIGTERM lands,
a stall is a SIGSTOP the electron sends itself after writing a marker, a
save that silences the worker is one whose pickling stops the process
until the test continues it, and the pool server is killed once the
electron's marker exists.  Every wait is bounded.
"""

import asyncio
import json
import os
import signal
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from covalent_tpu_plugin_torch import GPUExecutor
from covalent_tpu_plugin_torch import harness as harness_mod
from covalent_tpu_plugin_torch.models import convert, data
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.obs import events as obs_events
from covalent_tpu_plugin_torch.obs import heartbeat as hb_mod
from covalent_tpu_plugin_torch.obs.metrics import REGISTRY
from covalent_tpu_plugin_torch.transport import ChaosPlan, LocalTransport
from covalent_tpu_plugin_torch.utils.checkpoint import verify_bundle_file

from .test_torch_train import LOSS_ATOL, TINY, _jax_steps, _setup

REPO = Path(__file__).resolve().parent.parent


def counter_value(name: str, **labels) -> float:
    metric = REGISTRY.get(name)
    if metric is None:
        return 0.0
    return (metric.labels(**labels) if labels else metric).value


def saves_total() -> float:
    metric = REGISTRY.get("covalent_tpu_checkpoint_saves_total")
    return 0.0 if metric is None else sum(child.value for _, child in metric._series())


class EventLog:
    def __init__(self):
        self.events: list = []

    def __enter__(self):
        obs_events.add_listener(self.events.append)
        return self

    def __exit__(self, *exc):
        obs_events.remove_listener(self.events.append)

    def of(self, kind: str) -> list:
        return [e for e in self.events if e.get("type") == kind]


class PreemptAfterCheckpoint:
    """Arms a plan's preemption once the dispatcher records a checkpoint of
    ``lineage`` at ``min_step`` or later: the plan starts with
    ``preempt_after`` 0 (nothing), and the ``worker.checkpoint_saved``
    event raises it to 1, so the notice lands on the channel's next op.  A
    count of ops alone races the first save."""

    def __init__(self, plan, lineage, min_step):
        self.plan, self.lineage, self.min_step = plan, lineage, min_step
        self.step = None

    def __call__(self, event):
        step = event.get("step")
        if (self.step is None and event.get("type") == "worker.checkpoint_saved"
                and event.get("lineage") == self.lineage and isinstance(step, int)
                and step >= self.min_step):
            self.step = step
            self.plan.preempt_after = 1

    def __enter__(self):
        obs_events.add_listener(self)
        return self

    def __exit__(self, *exc):
        obs_events.remove_listener(self)


def _executor(tmp_path, **kwargs):
    kwargs.setdefault("use_agent", False)
    kwargs.setdefault("checkpoint_interval_s", 0.15)
    kwargs.setdefault("checkpoint_keep_n", 2)
    # no beats unless a test watches for stalls: the checkpoint records
    # ride the telemetry file either way
    kwargs.setdefault("heartbeat_interval", 0.0)
    return GPUExecutor(
        transport="local", cache_dir=str(tmp_path / "cache"),
        remote_cache=str(tmp_path / "remote"), remote_workdir=str(tmp_path / "work"),
        python_path=sys.executable, poll_freq=0.1, task_env={"PYTHONPATH": str(REPO)},
        **kwargs)


def _run(ex, fn, args, metadata, timeout=240):
    async def flow():
        try:
            return await asyncio.wait_for(ex.run(fn, list(args), {}, metadata), timeout)
        finally:
            await ex.close()

    return asyncio.run(flow())


def elastic_train(steps, hold_at, progress_path, each_step_snapped=False):
    """A checkpoint-cooperative electron (the reference's, with a hold):
    each executed step is appended to ``progress_path``; it resumes from a
    shipped bundle; a fresh start holds after step ``hold_at`` until it is
    preempted (bounded: 120 s).  Each step publishes a new dict, so a
    snapshot is consistent from any thread.  ``each_step_snapped`` makes
    every step wait (bounded) until the checkpointer has taken it."""
    import threading
    import time

    from covalent_tpu_plugin_torch.utils import checkpoint as ckpt

    state = {"acc": 0.0, "step": -1}
    start = 0
    resumed = ckpt.resume_state()
    if resumed is not None:
        step0, tree = resumed
        state.update(tree)
        start = int(step0) + 1

    snapped = {"step": -1, "event": threading.Event()}

    def snap():
        current = state
        if current["step"] < 0:
            return None
        snapped["step"] = current["step"]
        snapped["event"].set()
        return dict(current), current["step"]

    ckpt.register_snapshot(snap)
    try:
        for step in range(start, steps):
            with open(progress_path, "a") as f:
                f.write(f"{step}\n")
            state = {"acc": state["acc"] + step, "step": step}
            while each_step_snapped and snapped["step"] < step:
                snapped["event"].clear()
                snapped["event"].wait(30)
            if resumed is None and step == hold_at:
                time.sleep(120)  # held until the preemption's SIGTERM
    finally:
        ckpt.unregister_snapshot()
    return state["acc"], start


def test_interval_checkpoints_are_published_to_the_cas(tmp_path):
    """No faults: sha256-named bundles and a manifest bounded by keep_n, the
    saves counted through the telemetry."""
    ex = _executor(tmp_path, checkpoint_interval_s=0.1)
    before = saves_total()
    progress = tmp_path / "progress.txt"
    with EventLog() as log:
        acc, start = _run(ex, elastic_train, [10, -1, str(progress), True],
                          {"dispatch_id": "ckpt-pub", "node_id": 0})
    assert acc == sum(range(10)) and start == 0
    cas = tmp_path / "remote" / "cas"
    manifest = json.loads((cas / "ckpt_ckpt-pub_0.json").read_text())
    history = manifest["history"]
    assert 1 <= len(history) <= 2 and manifest["lineage"] == "ckpt-pub_0"
    for entry in history:
        assert verify_bundle_file(entry["file"], entry["digest"])
    assert len(list(cas.glob("*.ckpt"))) == len(history)
    saved = log.of("worker.checkpoint_saved")
    assert saved and saves_total() - before == len({e["digest"] for e in saved})
    assert all(e.get("backhaul") and e["lineage"] == "ckpt-pub_0" for e in saved)


def test_a_preemption_resumes_instead_of_recomputing(tmp_path):
    """The preemption is armed by a recorded checkpoint of step 7, where the
    electron holds, so it lands there: the retry resumes from step 7 with
    one worker_preempted retry, a task.resumed, the restore counted, no
    step recomputed."""
    steps, hold = 12, 7
    plan = ChaosPlan(preempt_grace=30.0, max_faults=1)
    ex = _executor(tmp_path, max_task_retries=2, retry_base_delay=0.05, retry_max_delay=0.1,
                   chaos=plan)
    progress = tmp_path / "progress.txt"
    restores = counter_value("covalent_tpu_checkpoint_restores_total")
    preempted = counter_value("covalent_tpu_task_retries_total", reason="worker_preempted")
    with EventLog() as log, PreemptAfterCheckpoint(plan, "ckpt-resume_0", hold) as arm:
        acc, start = _run(ex, elastic_train, [steps, hold, str(progress)],
                          {"dispatch_id": "ckpt-resume", "node_id": 0})
    assert acc == sum(range(steps))
    assert plan.faults_injected == 1 and arm.step == hold
    executed = [int(x) for x in progress.read_text().split()]
    assert executed == list(range(steps)) and start == hold + 1  # nothing recomputed
    assert counter_value("covalent_tpu_task_retries_total",
                         reason="worker_preempted") == preempted + 1
    assert counter_value("covalent_tpu_checkpoint_restores_total") == restores + 1
    assert [e["reason"] for e in log.of("task.retry")] == ["worker_preempted"]
    resumed = log.of("task.resumed")
    assert len(resumed) == 1 and resumed[0]["lineage"] == "ckpt-resume_0"
    assert resumed[0]["step"] == hold and resumed[0]["attempt"] == 1
    assert log.of("task.resume_planned")[0]["step"] == hold
    assert log.of("worker.preempt_notice")
    assert hold in [e["step"] for e in log.of("worker.checkpoint_saved")]
    assert log.of("task.state")[-1]["state"] == "completed" and ex.last_attempts == 2


def test_a_torn_checkpoint_is_skipped_for_the_previous_complete_one(tmp_path):
    ex = _executor(tmp_path)
    cas_dir = tmp_path / "remote" / "cas"
    lineage = "torn-lineage_0"
    harness_mod._write_checkpoint_bundle(str(cas_dir), lineage, 3, {"acc": 3.0, "step": 3},
                                         keep_n=4)
    path, digest, _ = harness_mod._write_checkpoint_bundle(
        str(cas_dir), lineage, 7, {"acc": 21.0, "step": 7}, keep_n=4)
    data_bytes = Path(path).read_bytes()
    Path(path).write_bytes(data_bytes[: len(data_bytes) // 2])  # killed mid-write

    async def flow():
        conn = LocalTransport()
        try:
            with EventLog() as log:
                plan = await ex._discover_resume(lineage, [conn])
            return plan, log.of("task.resume_skipped_torn")
        finally:
            await conn.close()
            await ex.close()

    plan, torn = asyncio.run(asyncio.wait_for(flow(), 60))
    assert plan is not None and plan["step"] == 3
    assert torn and torn[0]["step"] == 7 and torn[0]["digest"] == digest
    assert verify_bundle_file(plan["local"], plan["digest"])


def test_a_run_never_resumes_from_an_earlier_run_of_the_node(tmp_path):
    ex = _executor(tmp_path)
    cas_dir = tmp_path / "remote" / "cas"
    harness_mod._write_checkpoint_bundle(str(cas_dir), "node_0", 11, {"step": 11}, 2,
                                         run="node_0_earlier")

    async def flow(run):
        conn = LocalTransport()
        try:
            return await ex._discover_resume("node_0", [conn], run)
        finally:
            await conn.close()

    assert asyncio.run(asyncio.wait_for(flow("node_0_this"), 60)) is None
    plan = asyncio.run(asyncio.wait_for(flow("node_0_earlier"), 60))
    assert plan is not None and plan["step"] == 11
    asyncio.run(ex.close())


def test_no_checkpoint_interval_means_no_checkpoint_block(tmp_path):
    ex = _executor(tmp_path, checkpoint_interval_s=0.0, heartbeat_interval=0.0)
    staged = ex._write_function_files("nockpt", lambda: 1, (), {}, str(tmp_path / "wd"),
                                      lineage="nockpt")
    spec = json.loads(Path(staged.spec_file).read_text())
    assert not {"checkpoint", "resume", "telemetry_file", "heartbeat_s"} & set(spec)
    ex2 = _executor(tmp_path / "b", checkpoint_interval_s=5.0, dispatch_mode="auto",
                    use_agent="pool", heartbeat_interval=0.5)
    assert ex2._rpc_preselect({}) is False  # checkpointing pins the launch road
    staged2 = ex2._write_function_files(
        "ckpt", lambda: 1, (), {}, str(tmp_path / "wd"), lineage="base",
        resume={"step": 4, "digest": "d" * 64, "local": str(tmp_path / "x.ckpt")},
        trace={"trace_id": "t", "span_id": "s", "attempt": 1}, run="base_1234")
    spec2 = json.loads(Path(staged2.spec_file).read_text())
    assert spec2["checkpoint"]["lineage"] == "base" and spec2["checkpoint"]["interval_s"] == 5.0
    assert spec2["checkpoint"]["run"] == "base_1234"
    assert spec2["checkpoint"]["dir"] == f"{tmp_path / 'b' / 'remote'}/cas"
    assert spec2["resume"] == {"file": f"{tmp_path / 'b' / 'remote'}/resume_ckpt.ckpt",
                               "step": 4, "digest": "d" * 64}
    assert spec2["heartbeat_s"] == 0.5 and spec2["telemetry_file"].endswith(
        "telemetry_ckpt.0.jsonl")
    assert staged2.resume_artifact[1] in staged2.remote_files()
    assert set(spec2) <= harness_mod._SPEC_KEYS


def stall_once(marker):
    """Attempt 1 writes the marker, then stops its own process group."""
    import os
    import signal
    import time

    if os.path.exists(marker):
        return "second"
    with open(marker, "w") as f:
        f.write(str(os.getpid()))
    time.sleep(0.5)  # a beat or two
    os.killpg(os.getpgid(0), signal.SIGSTOP)
    time.sleep(120)


def _pid_running(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(") ", 1)[1].split()[0]
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False
    return state not in ("Z", "X", "x")


@pytest.mark.parametrize("use_agent", [False, "pool"])
def test_a_stall_is_detected_escalated_and_retried(tmp_path, use_agent):
    """A stopped worker's beats stop: the poll (nohup) or the pool
    channel's side-band (pool) finds it stalled before any timeout, the
    escalation KILLs it (TERM cannot land on a stopped process), and the
    retry completes."""
    marker = tmp_path / "marker"
    kwargs = {"pool_preload": "cloudpickle"} if use_agent else {}
    ex = _executor(tmp_path, use_agent=use_agent, checkpoint_interval_s=0.0,
                   heartbeat_interval=0.5, stall_threshold=3.0, max_task_retries=1,
                   retry_base_delay=0.05, retry_max_delay=0.1, **kwargs)
    before = counter_value("covalent_tpu_task_retries_total", reason="worker_stalled")
    with EventLog() as log:
        assert _run(ex, stall_once, [str(marker)],
                    {"dispatch_id": f"stall-{bool(use_agent)}", "node_id": 0}) == "second"
    assert counter_value("covalent_tpu_task_retries_total",
                         reason="worker_stalled") == before + 1
    escalated = log.of("task.escalated")
    assert [(e["reason"], e["survivors"], e["stopped"]) for e in escalated] == [("stall", 0, 1)]
    assert log.of("task.stall_escalated")
    assert not _pid_running(int(marker.read_text()))


def rpc_once(marker):
    """Attempt 1 writes the marker and waits to be killed with its server."""
    import os
    import time

    if os.path.exists(marker):
        return ("second", os.getpid())
    with open(marker, "w") as f:
        f.write(str(os.getpid()))
    time.sleep(120)


def test_an_rpc_electron_whose_server_dies_is_retried_on_a_fresh_server(tmp_path):
    ex = _executor(tmp_path, use_agent="pool", dispatch_mode="rpc", pool_preload="cloudpickle",
                   checkpoint_interval_s=0.0, heartbeat_interval=0.0, max_task_retries=1,
                   retry_base_delay=0.05, retry_max_delay=0.1)
    marker = tmp_path / "marker"
    before = counter_value("covalent_tpu_task_retries_total", reason="rpc_channel")

    async def flow():
        task = asyncio.ensure_future(ex.run(rpc_once, [str(marker)], {},
                                            {"dispatch_id": "rpc-retry", "node_id": 0}))
        try:
            while not marker.exists():
                await asyncio.sleep(0.05)
            first = ex._agents["localhost"]
            first._process._proc.kill()
            out = await task
            return out, first, ex._agents.get("localhost")
        finally:
            await ex.close()

    with EventLog() as log:
        (word, pid), first, second = asyncio.run(asyncio.wait_for(flow(), 240))
    assert word == "second" and pid != int(marker.read_text())
    assert second is not None and second is not first
    assert counter_value("covalent_tpu_task_retries_total", reason="rpc_channel") == before + 1
    assert [e["reason"] for e in log.of("task.retry")] == ["rpc_channel"]
    assert ex.last_dispatch_mode == "rpc" and ex.last_attempts == 2


def stop_in_save(marker):
    """Attempt 1 registers a snapshot whose pickling stops the process once
    (a save that keeps the beat thread from running), and returns once the
    test has continued it and written ``<marker>.go``; a later attempt
    returns at once.  The stop is sent to the pickling thread itself: sent
    to the process, it is taken by whichever thread the kernel wakes for it
    (the main thread, asleep in this function), and the save can finish
    before the process stops."""
    import os
    import signal
    import threading
    import time

    from covalent_tpu_plugin_torch.utils import checkpoint as ckpt

    if os.path.exists(marker):
        return "second"

    class StopsThePickler:
        def __reduce__(self):
            if not os.path.exists(marker):
                with open(marker, "w") as f:
                    f.write(str(os.getpid()))
                signal.pthread_kill(threading.get_ident(), signal.SIGSTOP)
            return (dict, ())

    ckpt.register_snapshot(lambda: ({"state": StopsThePickler()}, 0))
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(f"{marker}.go") and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        ckpt.unregister_snapshot()
    return "first"


class StallChecks:
    """Every stall verdict (``GPUExecutor._stall_verdict``) given while a
    worker was silent past its threshold, and what it answered."""

    def __init__(self, monkeypatch):
        self.seen: list = []
        real = GPUExecutor._stall_verdict

        async def verdict(ex, operation_id, *args):
            out = await real(ex, operation_id, *args)
            for worker, last in hb_mod.MONITOR.last(operation_id).items():
                if last["age_s"] > hb_mod.MONITOR.effective_stall_after(operation_id, worker):
                    self.seen.append((worker, last["age_s"], list(out)))
            return out

        monkeypatch.setattr(GPUExecutor, "_stall_verdict", verdict)


def _continue(marker):
    try:
        os.kill(int(marker.read_text()), signal.SIGCONT)
    except (OSError, ValueError):
        pass


def test_a_save_that_silences_the_worker_is_not_a_stall(tmp_path, monkeypatch):
    """The save announces itself (``worker.checkpoint_started``), so the
    dispatcher holds the stall clock: stall verdicts see the stopped worker
    silent past its threshold (three beats) and answer nothing; continued,
    the save lands and the one attempt completes."""
    marker = tmp_path / "marker"
    ex = _executor(tmp_path, checkpoint_interval_s=0.1, heartbeat_interval=0.5,
                   max_task_retries=0)
    checks = StallChecks(monkeypatch)

    async def flow():
        task = asyncio.ensure_future(ex.run(stop_in_save, [str(marker)], {},
                                            {"dispatch_id": "held", "node_id": 0}))
        try:
            while not checks.seen and not task.done():
                await asyncio.sleep(0.05)
            _continue(marker)
            Path(f"{marker}.go").write_text("")
            return await task
        finally:
            _continue(marker)
            await ex.close()

    with EventLog() as log:
        assert asyncio.run(asyncio.wait_for(flow(), 120)) == "first"
    assert checks.seen and all(answer == [] for _, _, answer in checks.seen)
    assert ex.last_attempts == 1 and not log.of("task.retry")
    assert [e["step"] for e in log.of("worker.checkpoint_started")] == [0]
    assert [e["step"] for e in log.of("worker.checkpoint_saved")] == [0]


def test_a_stall_verdict_reads_the_telemetry_the_side_band_has_not_brought(tmp_path,
                                                                           monkeypatch):
    """The interleaving that failed before the verdict read the worker's
    telemetry itself: on the pool road the side-band forwards the worker's
    records at its own pace, so a save's ``worker.checkpoint_started`` can
    still be on its way when the silence passes the threshold.  Here the
    side-band never forwards (its watch is not started), the worker stops
    inside its save, and the verdict, which read only the heartbeat
    snapshot, called it stalled; it now reads the telemetry file up to now,
    finds the save's start, and holds."""
    marker = tmp_path / "marker"
    ex = _executor(tmp_path, use_agent="pool", pool_preload="cloudpickle",
                   checkpoint_interval_s=0.1, heartbeat_interval=0.5, max_task_retries=0)

    async def no_side_band(self, client, staged, worker):
        return None

    monkeypatch.setattr(GPUExecutor, "_start_backhaul", no_side_band)
    checks = StallChecks(monkeypatch)

    async def flow():
        task = asyncio.ensure_future(ex.run(stop_in_save, [str(marker)], {},
                                            {"dispatch_id": "unforwarded", "node_id": 0}))
        try:
            while not checks.seen and not task.done():
                await asyncio.sleep(0.05)
            _continue(marker)
            Path(f"{marker}.go").write_text("")
            return await task
        finally:
            _continue(marker)
            await ex.close()

    with EventLog() as log:
        assert asyncio.run(asyncio.wait_for(flow(), 120)) == "first"
    assert checks.seen and all(answer == [] for _, _, answer in checks.seen)
    assert ex.last_attempts == 1 and not log.of("task.stall_escalated")
    assert [e["step"] for e in log.of("worker.checkpoint_started")] == [0]


def test_a_save_past_the_hold_cap_is_a_stall(tmp_path):
    """A save that never ends holds the stall clock only up to
    ``SAVE_HOLD_S``: then the worker is stalled (silent at least the cap),
    KILLed while stopped, and the retry completes."""
    marker = tmp_path / "marker"
    ex = _executor(tmp_path, checkpoint_interval_s=0.1, heartbeat_interval=0.5,
                   max_task_retries=1, retry_base_delay=0.05, retry_max_delay=0.1)
    ex.SAVE_HOLD_S = 3.0
    try:
        with EventLog() as log:
            assert _run(ex, stop_in_save, [str(marker)],
                        {"dispatch_id": "hold-cap", "node_id": 0}) == "second"
    finally:
        _continue(marker)
    assert [e["reason"] for e in log.of("task.retry")] == ["worker_stalled"]
    assert [(e["survivors"], e["stopped"]) for e in log.of("task.escalated")] == [(0, 1)]
    assert log.of("worker.checkpoint_started") and not log.of("worker.checkpoint_saved")
    failed = [e for e in log.of("task.failed") if e.get("status") == "STALLED"]
    assert failed and max(v["age_s"] for v in failed[0]["last_heartbeats"].values()) >= 3.0
    assert not _pid_running(int(marker.read_text()))


class Clock:
    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


def test_a_restore_announces_itself_and_holds_the_stall_clock(tmp_path, monkeypatch):
    """``resume_state`` brackets the bundle's unpickle with
    ``worker.restore_started``/``_done`` in the telemetry file the harness
    names; fed to the executor, they hold and then release the worker's
    stall clock."""
    from covalent_tpu_plugin_torch import gpu as gpu_mod
    from covalent_tpu_plugin_torch.utils import checkpoint as ckpt

    path, digest, _ = harness_mod._write_checkpoint_bundle(
        str(tmp_path / "cas"), "restore_0", 5, {"w": torch.arange(3.0)}, keep_n=2)
    telemetry = tmp_path / "telemetry.jsonl"
    for name in (*harness_mod._RESUME_ENV, harness_mod._RESUME_EVENTS_ENV):
        monkeypatch.setenv(name, "")  # restored when the test ends
    harness_mod._apply_resume({"operation_id": "op", "telemetry_file": str(telemetry),
                               "resume": {"file": path, "step": 5, "digest": digest}}, 0)
    step, tree = ckpt.resume_state()
    assert step == 5 and torch.equal(tree["w"], torch.arange(3.0))
    records = [json.loads(line) for line in telemetry.read_text().splitlines()]
    assert [r["type"] for r in records] == [
        "worker.resume_available", "worker.restore_started", "worker.restore_done"]
    assert records[-1]["step"] == 5

    clock = Clock()
    monitor = hb_mod.HeartbeatMonitor(clock=clock)
    monkeypatch.setattr(gpu_mod, "MONITOR", monitor)
    ex = _executor(tmp_path / "ex", heartbeat_interval=1.0)
    monitor.watch("op", 3.0, interval=1.0)
    monitor.record("op", "localhost", {"seq": 1})
    ex._handle_backhaul("op", "localhost", records[1])
    clock.now += 10.0
    assert monitor.stalled("op") == []
    ex._handle_backhaul("op", "localhost", records[2])
    assert monitor.stalled("op") == []
    clock.now += 3.0
    assert monitor.stalled("op") == [("localhost", 3.0)]
    asyncio.run(ex.close())


SELECTIONS = [({}, "auto"), ({}, "rpc"), ({"dispatch_mode": "rpc"}, "auto"),
              ({"dispatch_mode": "auto"}, "rpc"), ({"dispatch_mode": "launch"}, "rpc")]


@pytest.mark.parametrize("chaos,interval", [(True, 0.0), (False, 5.0), (True, 5.0)])
def test_the_rpc_road_is_chosen_as_the_reference_chooses_it(tmp_path, chaos, interval):
    """Under a chaos plan or with checkpoints on, ``auto`` takes the launch
    road and an explicit ``rpc`` pin keeps the fast path, in both
    packages (tpu.py:3430-3439)."""
    from covalent_tpu_plugin import TPUExecutor
    from covalent_tpu_plugin.transport.chaos import ChaosPlan as JaxChaosPlan

    for metadata, mode in SELECTIONS:
        common = dict(transport="local", use_agent="pool", dispatch_mode=mode,
                      checkpoint_interval_s=interval, cache_dir=str(tmp_path / "cache"),
                      remote_cache=str(tmp_path / "remote"))
        port = GPUExecutor(chaos=ChaosPlan(max_faults=1) if chaos else None, **common)
        ref = TPUExecutor(chaos=JaxChaosPlan(max_faults=1) if chaos else None, **common)
        assert port._rpc_preselect(metadata) == ref._rpc_preselect(metadata), (metadata, mode)


def tell_pid():
    import os

    return os.getpid()


@pytest.mark.parametrize("case", ["rpc_pin_with_checkpoints", "auto_under_chaos"])
def test_an_electron_takes_the_road_the_reference_gives_it(tmp_path, case):
    """End to end: an electron pinned to ``rpc`` with checkpoints on runs in
    the pool server (not checkpointed); an ``auto`` electron under a chaos
    plan runs in a process of its own."""
    if case == "rpc_pin_with_checkpoints":
        ex = _executor(tmp_path, use_agent="pool", pool_preload="cloudpickle",
                       dispatch_mode="rpc", checkpoint_interval_s=5.0)
        want = "rpc"
    else:
        ex = _executor(tmp_path, use_agent="pool", pool_preload="cloudpickle",
                       dispatch_mode="auto", checkpoint_interval_s=0.0,
                       chaos=ChaosPlan(max_faults=1))
        want = "launch"

    async def flow():
        try:
            pid = await ex.run(tell_pid, [], {}, {"dispatch_id": f"road-{case}", "node_id": 0})
            return pid, ex.last_dispatch_mode, ex._agents["localhost"]._banner["pid"]
        finally:
            await ex.close()

    with EventLog() as log:
        pid, mode, server = asyncio.run(asyncio.wait_for(flow(), 120))
    assert mode == want and (pid == server) == (want == "rpc")
    assert not log.of("task.rpc_fallback") and not log.of("worker.checkpoint_saved")


# -- the LM across a resume, against the JAX package -------------------------

LM_STEPS, LM_HOLD = 6, 3


def lm_train(state, config, batches, hold_at, progress_path):
    """The small LM's checkpoint-cooperative training electron: AdamW from
    ``state``; snapshots are host copies taken under the step's lock, and
    the handler (main thread) takes one only when the lock is free."""
    import threading
    import time

    from covalent_tpu_plugin_torch.models import train as tr
    from covalent_tpu_plugin_torch.models.transformer import TransformerLM
    from covalent_tpu_plugin_torch.utils import checkpoint as ckpt

    model = TransformerLM(config, device="cpu")
    model.load_state_dict(state)
    optimizer = tr.adamw(model)
    step_fn = tr.make_train_step(model, optimizer)
    losses, start = {}, 0
    resumed = ckpt.resume_state()
    if resumed is not None:
        step0, tree = resumed
        model.load_state_dict(tree["model"])
        optimizer.load_state_dict(tree["optimizer"])
        losses.update(tree["losses"])
        start = step0 + 1
    lock, done = threading.Lock(), {"step": start - 1}

    def snap():
        main = threading.current_thread() is threading.main_thread()
        if not lock.acquire(blocking=not main):
            return None
        try:
            if done["step"] < 0:
                return None
            return ({"model": ckpt.host_tree(model.state_dict()),
                     "optimizer": ckpt.host_tree(optimizer.state_dict()),
                     "losses": dict(losses)}, done["step"])
        finally:
            lock.release()

    ckpt.register_snapshot(snap)
    try:
        for i in range(start, len(batches)):
            with lock:
                losses[i] = float(step_fn(batches[i])["loss"])
                done["step"] = i
            with open(progress_path, "a") as f:
                f.write(f"{i}\n")
            if resumed is None and i == hold_at:
                time.sleep(120)  # held until the preemption's SIGTERM
    finally:
        ckpt.unregister_snapshot()
    return [losses[i] for i in range(len(batches))], start


@pytest.fixture(scope="module")
def lm_case():
    jmodel, params, model, tcfg = _setup()
    batches = list(data.synthetic_lm_batches(steps=LM_STEPS, batch_size=2, seq_len=33,
                                             vocab_size=TINY["vocab_size"], seed=3))
    _, jax_losses = _jax_steps(jmodel, params, batches)
    state = {k: v.clone() for k, v in convert.params_from_jax(params, tcfg).items()}
    return state, tcfg, batches, jax_losses


def test_the_lm_resumed_matches_the_reference_and_its_uninterrupted_run(lm_case, tmp_path):
    state, tcfg, batches, jax_losses = lm_case
    plan = ChaosPlan(preempt_grace=30.0, max_faults=1)
    ex = _executor(tmp_path / "resumed", max_task_retries=2, retry_base_delay=0.05,
                   retry_max_delay=0.1, chaos=plan)
    progress = tmp_path / "progress.txt"
    with EventLog() as log, PreemptAfterCheckpoint(plan, "lm-resume_0", LM_HOLD):
        losses, start = _run(ex, lm_train, [state, tcfg, batches, LM_HOLD, str(progress)],
                             {"dispatch_id": "lm-resume", "node_id": 0})
    assert plan.faults_injected == 1 and start == LM_HOLD + 1
    assert [int(x) for x in progress.read_text().split()] == list(range(LM_STEPS))
    assert [e["reason"] for e in log.of("task.retry")] == ["worker_preempted"]
    np.testing.assert_allclose(losses, jax_losses, rtol=0, atol=LOSS_ATOL)
    twin = _executor(tmp_path / "twin", checkpoint_interval_s=0.0, heartbeat_interval=0.0)
    twin_losses, twin_start = _run(twin, lm_train, [state, tcfg, batches, -1,
                                                    str(tmp_path / "twin.txt")],
                                   {"dispatch_id": "lm-twin", "node_id": 0})
    assert twin_start == 0
    assert losses == twin_losses  # bit-equal across the resume
