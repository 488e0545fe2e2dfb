"""The gang's lifecycle against the JAX package's executor, on the CPU.

``prewarm`` (single-flight, off under a chaos plan or by config, the
workflow runner's prewarm of a blocked node, on ``executor="gpu"`` too),
``is_warm`` and ``gang_state``, ``teardown_gang`` (refused while an
electron is in flight or a session is live, then a fresh dial),
``health_canary`` on a live and a killed pool server, the heartbeat's feed
of the health monitor, and straggler detection: ``_note_gang_stragglers``
flags the same worker with the same differential as the reference's on the
same exit times (drawn from a seed), a three-process gang whose last rank
leaves late is flagged end to end, and with ``COVALENT_TPU_STRAGGLER_REDIAL``
its channel is dropped and the next electron dials afresh.  The cases
follow ``tests/test_fastpath.py`` and ``tests/test_health.py``.
"""

from __future__ import annotations

import asyncio
import sys
from pathlib import Path

import numpy as np
import pytest

import covalent_tpu_plugin_torch.workflow as ct
from covalent_tpu_plugin_torch import GPUExecutor
from covalent_tpu_plugin_torch.fleet.health import HEALTH
from covalent_tpu_plugin_torch.obs import events as obs_events
from covalent_tpu_plugin_torch.obs.metrics import REGISTRY
from covalent_tpu_plugin_torch.serving import open_session
from covalent_tpu_plugin_torch.transport import ChaosPlan
from covalent_tpu_plugin_torch.utils import config as config_mod

from .test_torch_session import make_factory

REPO = Path(__file__).resolve().parent.parent
METADATA = {"dispatch_id": "life", "node_id": 0}


def metric(name: str, **labels) -> float:
    family = REGISTRY.get(name)
    if family is None:
        return 0.0
    if labels:
        return family.labels(**labels).value
    return sum(child.value for _, child in family._series())


def _executor(tmp_path, name: str = "ex", **kwargs) -> GPUExecutor:
    kwargs.setdefault("use_agent", "pool")
    return GPUExecutor(
        transport="local", cache_dir=str(tmp_path / name / "cache"),
        remote_cache=str(tmp_path / name / "remote"), remote_workdir=str(tmp_path / "work"),
        python_path=sys.executable, poll_freq=0.05, pool_preload="cloudpickle",
        task_env={"PYTHONPATH": str(REPO)}, **kwargs)


class Events:
    def __init__(self) -> None:
        self.events: list = []

    def __enter__(self):
        obs_events.add_listener(self.events.append)
        return self

    def __exit__(self, *exc):
        obs_events.remove_listener(self.events.append)

    def of(self, kind: str) -> list:
        return [e for e in self.events if e.get("type") == kind]


# --------------------------------------------------------------------------
# prewarm, is_warm, gang_state


def test_prewarm_dials_once_and_skips_when_warm(tmp_path, run_async):
    ex = _executor(tmp_path)
    warmed = metric("covalent_tpu_prewarm_total", result="warmed")

    async def flow():
        try:
            cold = ex.is_warm
            first, second = await ex.prewarm(), await ex.prewarm()
            client = ex._agents.get("localhost")
            return cold, first, second, ex.is_warm, ex.gang_state(), client is not None
        finally:
            await ex.close()

    with Events() as log:
        cold, first, second, warm, state, pooled = run_async(flow())
    assert (cold, first, second, warm, pooled) == (False, True, False, True, True)
    assert state == {"warm": True, "workers": ["localhost"], "breakers": {"localhost": "closed"}}
    assert metric("covalent_tpu_prewarm_total", result="warmed") == warmed + 1
    assert len(log.of("executor.prewarm")) == 1
    spans = [e for e in log.events if e.get("type") == "span"
             and e.get("name") == "executor.prewarm"]
    assert len(spans) == 1 and spans[0]["duration_s"] > 0


def test_prewarm_is_off_under_a_chaos_plan_and_by_config(tmp_path, run_async):
    chaotic = _executor(tmp_path, "chaos", chaos=ChaosPlan(drop_after=100))
    disabled = _executor(tmp_path, "off", prewarm=False)

    async def flow():
        try:
            return await chaotic.prewarm(), await disabled.prewarm()
        finally:
            await chaotic.close()
            await disabled.close()

    assert run_async(flow()) == (False, False)
    assert chaotic._chaos.faults_injected == 0
    assert not chaotic._transports and not disabled._transports


def test_a_failed_prewarm_is_swallowed_and_tried_again(tmp_path, run_async):
    ex = _executor(tmp_path)
    failed = metric("covalent_tpu_prewarm_total", result="failed")

    async def broken(dialed=None):
        raise OSError("no route to the worker")

    ex.lease_gang = broken

    async def flow():
        try:
            return await ex.prewarm(), ex._prewarmed
        finally:
            await ex.close()

    with Events() as log:
        assert run_async(flow()) == (False, False)
    assert metric("covalent_tpu_prewarm_total", result="failed") == failed + 1
    assert "no route" in log.of("executor.prewarm_failed")[0]["error"]


class PrewarmLanded:
    """Set once an executor's prewarm has warmed its gang: the upstream
    node below waits on it, so the downstream node starts after the
    prewarm, whatever the machine's load."""

    def __init__(self) -> None:
        import threading

        self.event = threading.Event()
        self.order: list = []

    def __call__(self, event) -> None:
        kind = event.get("type")
        if kind == "executor.prewarm":
            self.event.set()
        if kind in ("executor.prewarm", "task.state"):
            self.order.append((kind, event.get("state")))


def _blocked_lattice(ex_or_alias, landed: PrewarmLanded):
    @ct.electron
    def upstream():
        assert landed.event.wait(120), "the downstream executor was never prewarmed"
        return 2

    @ct.electron(executor=ex_or_alias)
    def downstream(x):
        return x * 21

    @ct.lattice
    def flow():
        return downstream(upstream())

    return flow


def _dispatch_blocked(ex_or_alias):
    """The blocked lattice: its result, the prewarms it warmed, the pool's
    fresh dials over the whole dispatch, and the order of the prewarm and
    the downstream electron's start."""
    landed = PrewarmLanded()
    warmed = metric("covalent_tpu_prewarm_total", result="warmed")
    misses = metric("covalent_tpu_pool_acquires_total", result="miss")
    obs_events.add_listener(landed)
    try:
        result = ct.dispatch_sync(_blocked_lattice(ex_or_alias, landed))()
    finally:
        obs_events.remove_listener(landed)
    return (result, metric("covalent_tpu_prewarm_total", result="warmed") - warmed,
            metric("covalent_tpu_pool_acquires_total", result="miss") - misses, landed.order)


def test_the_runner_prewarms_a_blocked_node(tmp_path):
    """The downstream node's executor is dialed while its upstream node
    waits: the dispatch dials once, in the prewarm, before the downstream
    electron starts, which then finds its channel warm."""
    result, warmed, dials, order = _dispatch_blocked(_executor(tmp_path))
    assert result.status.value == "COMPLETED", result.error
    assert result.result == 42
    assert warmed == 1 and dials == 1
    assert order.index(("executor.prewarm", None)) < order.index(("task.state", "starting"))


def test_a_lattice_on_the_gpu_alias_prewarms_its_blocked_node(tmp_path, monkeypatch):
    monkeypatch.setenv("COVALENT_TPU_CONFIG", str(tmp_path / "config.toml"))
    config_mod._reset_cache_for_tests()
    try:
        for key, value in {"cache_dir": str(tmp_path / "cache"),
                           "remote_cache": str(tmp_path / "remote"),
                           "remote_workdir": str(tmp_path / "work"),
                           "python_path": sys.executable, "poll_freq": 0.1,
                           "task_env": {"PYTHONPATH": str(REPO)},
                           "pool_preload": "cloudpickle"}.items():
            config_mod.set_config(f"executors.gpu.{key}", value)
        result, warmed, dials, order = _dispatch_blocked("gpu")
    finally:
        config_mod._reset_cache_for_tests()
    assert result.status.value == "COMPLETED", result.error
    assert result.result == 42
    assert warmed == 1 and dials == 1
    assert order.index(("executor.prewarm", None)) < order.index(("task.state", "starting"))


def test_gang_state_before_any_dial_equals_the_references(tmp_path):
    from covalent_tpu_plugin import TPUExecutor

    settings = dict(transport="ssh", workers=["alice@w0:2222", "w1"],
                    cache_dir=str(tmp_path / "c"), use_agent=False)
    ours, theirs = GPUExecutor(**settings), TPUExecutor(**settings)
    ours._breakers.get("w1").record_failure()
    theirs._breakers.get("w1").record_failure()
    assert ours.gang_state() == theirs.gang_state()
    assert ours.is_warm is theirs.is_warm is False


# --------------------------------------------------------------------------
# teardown_gang and health_canary


def hold_until(path):
    """An electron that returns once ``path`` exists (at most a minute)."""

    def electron():
        import os as os_mod
        import time

        deadline = time.monotonic() + 60
        while not os_mod.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.02)
        return "released"

    return electron


def test_teardown_waits_for_the_electron_in_flight_then_redials(tmp_path, run_async):
    ex = _executor(tmp_path)
    gate = tmp_path / "gate"

    async def flow():
        try:
            task = asyncio.ensure_future(ex.run(hold_until(str(gate)), [], {}, METADATA))
            while not ex._pids:
                await asyncio.sleep(0.02)
            during = await ex.teardown_gang()
            gate.write_text("")
            value = await task
            misses = metric("covalent_tpu_pool_acquires_total", result="miss")
            after = await ex.teardown_gang()
            cold = ex.is_warm, dict(ex._agents)
            again = await ex.teardown_gang()
            await ex.run(lambda: 1, [], {}, {**METADATA, "node_id": 1})
            dialed = metric("covalent_tpu_pool_acquires_total", result="miss") - misses
            return during, value, after, cold, again, dialed
        finally:
            await ex.close()

    with Events() as log:
        during, value, after, cold, again, dialed = run_async(flow())
    assert (during, value, after, again) == (False, "released", True, False)
    assert cold == (False, {})
    assert dialed == 1  # the next electron dialed afresh
    assert len(log.of("executor.gang_teardown")) == 1


def test_teardown_is_refused_while_a_session_is_live(tmp_path, run_async):
    ex = _executor(tmp_path)

    async def flow():
        try:
            handle = await open_session(ex, make_factory())
            live = await ex.teardown_gang()
            await handle.close()
            closed = await ex.teardown_gang()
            return live, closed
        finally:
            await ex.close()

    assert run_async(flow()) == (False, True)


def test_the_canary_pings_a_live_runtime_and_fails_on_a_dead_one(tmp_path, run_async):
    ex = _executor(tmp_path)

    async def flow():
        try:
            none_yet = await ex.health_canary("localhost")
            await ex.prewarm()
            live = await ex.health_canary("localhost")
            client = ex._agents["localhost"]
            client._process._proc.kill()
            for _ in range(200):
                if not client.alive:
                    break
                await asyncio.sleep(0.02)
            dead = await ex.health_canary("localhost")
            return none_yet, live, dead, await ex.health_canary("nowhere")
        finally:
            await ex.close()

    assert run_async(flow()) == (False, True, False, False)


def test_heartbeats_feed_the_health_monitor_and_the_status_view(tmp_path, run_async):
    HEALTH.drop("localhost")
    ex = _executor(tmp_path, use_agent=False, heartbeat_interval=0.2)

    def beats():
        import time

        time.sleep(1.2)
        return "ok"

    async def flow():
        try:
            return await ex.run(beats, [], {}, METADATA), ex._status_snapshot()
        finally:
            await ex.close()

    value, status = run_async(flow())
    assert value == "ok"
    assert "localhost" in HEALTH.snapshot()
    assert "localhost" in status["health"] and status["warm"] is True
    assert status["heartbeat_interval_s"] == 0.2 and status["in_flight"] == {}
    HEALTH.drop("localhost")


# --------------------------------------------------------------------------
# stragglers


@pytest.mark.parametrize("seed", range(6))
def test_stragglers_are_flagged_as_the_reference_flags_them(monkeypatch, seed):
    """The same exit times (a seeded gang of 2-5 processes, a seeded budget)
    through both executors' ``_note_gang_stragglers``: the same worker, the
    same differential, or nothing from either."""
    from covalent_tpu_plugin.fleet import health as jax_health
    from covalent_tpu_plugin.tpu import TPUExecutor

    rng = np.random.default_rng(seed)
    size = int(rng.integers(2, 6))
    exit_at = {i: float(100.0 + rng.exponential(2.0)) for i in range(size)}
    if seed % 2:
        exit_at[size - 1] += float(rng.uniform(3.0, 12.0))
    budget = ["5", "0", "2.5", "", "1", "5"][seed]
    monkeypatch.setenv("COVALENT_TPU_STRAGGLER_BUDGET_S", budget)
    monkeypatch.delenv("COVALENT_TPU_STRAGGLER_REDIAL", raising=False)
    addresses = [f"w{i}" for i in range(size)]
    flagged: dict = {"ours": [], "theirs": []}
    monkeypatch.setattr(HEALTH, "flag_straggler",
                        lambda w, d, **kw: flagged["ours"].append((w, d, kw)))
    monkeypatch.setattr(jax_health.HEALTH, "flag_straggler",
                        lambda w, d, **kw: flagged["theirs"].append((w, d, kw)))
    GPUExecutor.__new__(GPUExecutor)._note_gang_stragglers("op", addresses, dict(exit_at))
    TPUExecutor.__new__(TPUExecutor)._note_gang_stragglers("op", addresses, dict(exit_at))
    assert flagged["ours"] == flagged["theirs"]


def test_a_gang_of_two_is_never_flagged(monkeypatch):
    """The reference's median of an even gang is its upper middle: in a gang
    of two it is the slower process itself."""
    monkeypatch.setenv("COVALENT_TPU_STRAGGLER_BUDGET_S", "1")
    seen = []
    monkeypatch.setattr(HEALTH, "flag_straggler", lambda *a, **k: seen.append(a))
    GPUExecutor.__new__(GPUExecutor)._note_gang_stragglers(
        "op", ["w0", "w1"], {0: 1.0, 1: 500.0})
    assert seen == []


def late_rank(delay: float, barrier: str):
    """A gang electron whose last rank leaves ``delay`` seconds after the
    others (the harness exports the rank before the electron runs).  Every
    rank first waits until all ranks have entered the electron (a file each
    in ``barrier``), so the ranks' start-up, which differs under load, does
    not order their exits: the early ranks leave together, only the last
    one waits."""

    def electron():
        import os as os_mod
        import time

        rank, world = int(os_mod.environ["RANK"]), int(os_mod.environ["WORLD_SIZE"])
        open(os_mod.path.join(barrier, f"in.{rank}"), "w").close()
        deadline = time.monotonic() + 120.0
        while len(os_mod.listdir(barrier)) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank {rank}: the gang never gathered in {barrier}")
            time.sleep(0.01)
        if rank == world - 1:
            time.sleep(delay)
        return rank

    return electron


def test_a_late_rank_is_flagged_and_its_channel_redialed(tmp_path, monkeypatch, run_async):
    """Three local processes, the last leaving 2 s after the others, a 0.5 s
    budget: the executor flags worker ``w2`` with a differential of about
    2 s, and with ``COVALENT_TPU_STRAGGLER_REDIAL`` drops its channel, so the
    next electron dials it afresh.  The ranks gather on a barrier before
    they leave, and the second electron, which only counts the dials, runs
    with the detection off: no exit order comes from the machine's load."""
    monkeypatch.setenv("COVALENT_TPU_STRAGGLER_BUDGET_S", "0.5")
    monkeypatch.setenv("COVALENT_TPU_STRAGGLER_REDIAL", "1")
    HEALTH.drop("w2")
    ex = _executor(tmp_path, use_agent=False, workers=["w0", "w1", "w2"], coordinator_port=0)
    barriers = [tmp_path / "barrier0", tmp_path / "barrier1"]
    for barrier in barriers:
        barrier.mkdir()

    async def flow():
        try:
            first = await ex.run(late_rank(2.0, str(barriers[0])), [], {}, METADATA)
            await asyncio.gather(*list(ex._cleanup_tasks))
            dropped = ex._pool_key("w2") not in ex._transports
            misses = metric("covalent_tpu_pool_acquires_total", result="miss")
            monkeypatch.setenv("COVALENT_TPU_STRAGGLER_BUDGET_S", "0")
            second = await ex.run(late_rank(0.0, str(barriers[1])), [], {},
                                  {**METADATA, "node_id": 1})
            return (first, second, dropped,
                    metric("covalent_tpu_pool_acquires_total", result="miss") - misses)
        finally:
            await ex.close()

    with Events() as log:
        first, second, dropped, dialed = run_async(flow())
    assert first == second == 0
    (flag,) = log.of("fleet.straggler")
    assert flag["worker"] == "w2" and 0.5 < flag["differential"] < 30.0
    assert flag["gang_size"] == 3
    assert [e["worker"] for e in log.of("fleet.straggler_redial")] == ["w2"]
    assert dropped and dialed == 1
    assert HEALTH.snapshot()["w2"]["fault_score"] < 1.0
    HEALTH.drop("w2")
