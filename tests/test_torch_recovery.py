"""Dispatcher crash recovery and the warm handoff of the port, on the CPU.

The three dispatcher-side cases of ``tests/test_recovery.py`` on the port: a
first executor incarnation journals its world and "crashes" (channels torn
down with no close, supervision cancelled), a second incarnation replays
the journal, re-dials, adopts the orphaned pool server through the
rendezvous and the ``--attach`` relay, and resumes the in-flight stream
from its journaled high-water mark, exactly once; with journaling off the
pass touches nothing; a re-adopted session serves new requests.  (The
reference's adapter case waits for slice 3.)  Then the handoff and
preemption cases of ``tests/test_serving.py``: a planned ``handoff()`` and
a SIGTERM notice to the pool server, each with every stream byte-equal and
exactly once, and a replay that differs counted under its own road.  The
engines are the reference tests' stubs, pickled by value; the pool servers
preload only ``cloudpickle``.
"""

import asyncio
import os
import signal
import sys
import time

import pytest

from covalent_tpu_plugin_torch import GPUExecutor
from covalent_tpu_plugin_torch.fleet import journal as journal_mod
from covalent_tpu_plugin_torch.fleet import recovery as recovery_mod
from covalent_tpu_plugin_torch.obs.metrics import REGISTRY
from covalent_tpu_plugin_torch.serving import open_session
from covalent_tpu_plugin_torch.serving.supervisor import ServeRequest

from .test_recovery_worker import _make_factory as make_factory
from .test_torch_session_protocol import gated_factory

RESULT_S = 60.0


def make_executor(tmp_path, **kwargs):
    return GPUExecutor(transport="local", cache_dir=str(tmp_path / "cache"),
                       remote_cache=str(tmp_path / "remote"), python_path=sys.executable,
                       use_agent="pool", pool_preload="cloudpickle", **kwargs)


def counter_value(name: str, **labels) -> float:
    metric = REGISTRY.get(name)
    if metric is None:
        return 0.0
    return sum(series.value for series_labels, series in metric._series()
               if all(series_labels.get(k) == v for k, v in labels.items()))


def crash_dispatcher(ex) -> None:
    """Tear the first incarnation down as SIGKILL would: supervision
    cancelled, each channel's pipes dropped cold, no close handshake; the
    worker sees a bare stdin EOF, the orphan-mode trigger."""
    for handle in list(ex._serve_handles.values()):
        task = getattr(handle, "_supervisor", None)
        if task is not None:
            task.cancel()
    for client in list(ex._agents.values()):
        client._process._writer.close()
        client._reader.cancel()
    ex._serve_handles.clear()
    ex._agents.clear()
    ex._transports.clear()


async def orphaned(tmp_path, timeout: float = 30.0) -> None:
    """Until the pool server has published its orphan rendezvous: a
    successor that dials sooner finds no orphan and starts afresh."""
    path = tmp_path / "remote" / "pool_orphan.json"
    deadline = time.monotonic() + timeout
    while not path.exists():
        assert time.monotonic() < deadline, "the pool server never orphaned"
        await asyncio.sleep(0.05)


@pytest.fixture()
def journal_dir(tmp_path, monkeypatch):
    path = tmp_path / "journal"
    monkeypatch.setenv("COVALENT_TPU_JOURNAL_DIR", str(path))
    monkeypatch.setenv("COVALENT_TPU_ORPHAN_TTL_S", "90")
    journal_mod.reset()
    yield str(path)
    journal_mod.reset()


def test_recover_is_noop_without_journal(tmp_path, run_async, monkeypatch):
    monkeypatch.delenv("COVALENT_TPU_JOURNAL_DIR", raising=False)
    journal_mod.reset()

    async def flow():
        ex = make_executor(tmp_path)
        try:
            return await ex.recover()
        finally:
            await ex.close()

    report = run_async(flow())
    assert report["recovered"] is False and report["adopted_sessions"] == []
    assert recovery_mod.last_report() is not None
    assert not (tmp_path / "remote").exists()  # nothing was started


def test_recover_adopts_orphan_and_resumes_stream_exactly_once(tmp_path, run_async,
                                                               journal_dir):
    adopted0 = counter_value("covalent_tpu_recovery_adopted_total")
    orphaned0 = counter_value("covalent_tpu_recovery_orphaned_total")

    async def flow():
        journal_mod.configure(journal_dir)
        assert journal_mod.epoch() == 1
        ex_a = make_executor(tmp_path)
        handle = await open_session(ex_a, gated_factory(), stats_interval_s=0.1)
        sid = handle.sid
        gate = tmp_path / "gate"
        # held after its first token until the gate opens, after the crash
        req_a = await handle.request([100], params={"max_new_tokens": 30, "hold": str(gate)})
        deadline = time.monotonic() + 20
        while not req_a.tokens:
            assert time.monotonic() < deadline, "stream never started"
            await asyncio.sleep(0.05)
        # a journaled session no worker holds: recovery reaps it
        journal_mod.record("session", sid="ghost", sid_g="serve-ghost.g0",
                           address="ghost-host", digest="x", payload="", slots=1, sync=True)
        crash_dispatcher(ex_a)
        prefix = list(req_a.tokens)
        await orphaned(tmp_path)
        # incarnation 2 replays the dead one's world and bumps the epoch
        journal_mod.reset()
        journal = journal_mod.configure(journal_dir)
        assert journal.epoch == 2
        assert sid in (journal.recovered.get("sessions") or {})
        ex_b = make_executor(tmp_path)
        try:
            report = await ex_b.recover()
            gate.touch()
            rid = next(r for s, r in report.requests if s == sid)
            resumed = await report.requests[(sid, rid)].result(timeout=RESULT_S)
            banner = ex_b._agents["localhost"]._banner
        finally:
            await ex_b.close()
        return sid, prefix, report, resumed, banner

    sid, prefix, report, resumed, banner = run_async(flow())
    assert banner.get("reattach") is True and banner.get("epoch") == 2
    assert report["recovered"] is True and report["epoch"] == 2
    assert sid in report["adopted_sessions"] and "ghost" in report["orphaned_sessions"]
    entry = next(r for r in report["resumed_streams"] if r["sid"] == sid)
    assert entry["state"] in ("streaming", "done")
    assert entry["from"] == len(prefix)  # the journaled mark is the splice point
    assert prefix + resumed == [100 + i + 1 for i in range(30)]
    assert counter_value("covalent_tpu_recovery_adopted_total") == adopted0 + 1
    assert counter_value("covalent_tpu_recovery_orphaned_total") >= orphaned0 + 1
    last = recovery_mod.last_report()
    assert last is not None and last["recovered"] is True and last["duration_s"] > 0


def test_recovered_session_serves_new_requests(tmp_path, run_async, journal_dir):
    async def flow():
        journal_mod.configure(journal_dir)
        ex_a = make_executor(tmp_path)
        handle = await open_session(ex_a, make_factory(step_delay=0.1, chunk=2, default_cap=6),
                                    stats_interval_s=0.1)
        sid = handle.sid
        req_a = await handle.request([100], params={"max_new_tokens": 20})
        while len(req_a.tokens) < 2:
            await asyncio.sleep(0.05)
        crash_dispatcher(ex_a)
        await orphaned(tmp_path)
        journal_mod.reset()
        journal_mod.configure(journal_dir)
        ex_b = make_executor(tmp_path)
        try:
            report = await ex_b.recover()
            sup = report.supervisors[sid]
            fresh = ServeRequest("r-fresh", [500], {"max_new_tokens": 3}, 0.0, "")
            await sup.submit(fresh)
            fresh_tokens = await fresh.result(timeout=RESULT_S)
            closed = await sup.close()
            state = journal_mod.get_journal().state
        finally:
            await ex_b.close()
        return fresh_tokens, closed, sid, state

    fresh_tokens, closed, sid, state = run_async(flow())
    assert fresh_tokens == [501, 502, 503]
    assert isinstance(closed, dict)
    # the close is journaled: a later replay does not resurrect the session
    assert sid not in state.sessions


def adapter_gated_factory():
    """:func:`gated_factory`'s engine with an adapter surface: it keeps the
    content digest of every bundle it is handed (the serving engine's
    ``attach_adapter``/``adapter_digests``), so recovery's re-attach is
    seen by the worker's inventory."""
    inner = gated_factory()

    def factory():
        engine = inner()
        engine.adapter_digests = {}

        def attach_adapter(name, payload):
            engine.adapter_digests[name] = str(payload["digest"])
            return payload["digest"]

        engine.attach_adapter = attach_adapter
        return engine

    return factory


def test_journaled_adapters_are_refused_by_name_until_slice_3(tmp_path, run_async,
                                                              journal_dir):
    """A journal whose session names LoRA adapters: the session is adopted,
    ``recover()`` re-attaches a journaled adapter from the dispatcher's CAS
    bundle before the stream resumes (``attached``), reports one whose bundle
    is gone ``error``, and counts both by state; the stream resumes exactly
    once.  (Until this slice the adapters were refused by name.)"""
    from covalent_tpu_plugin_torch.serving.registry import pack_adapter

    counts0 = {state: counter_value("covalent_tpu_recovery_adapters_total", state=state)
               for state in ("attached", "error", "resident")}
    wire = [[[0.5, -0.25]], [[1.0], [2.0]]]
    data = pack_adapter(wire, name="tone", rank=1)
    bundle = tmp_path / "tone.lora"
    bundle.write_bytes(data)
    digest = __import__("hashlib").sha256(data).hexdigest()

    async def flow():
        journal_mod.configure(journal_dir)
        ex_a = make_executor(tmp_path)
        handle = await open_session(ex_a, adapter_gated_factory())
        gate = tmp_path / "gate"
        req = await handle.request([10], params={"max_new_tokens": 12, "hold": str(gate)})
        while not req.tokens:
            await asyncio.sleep(0.05)
        journal_mod.record("session_adapter", sid=handle.sid, adapter="tone", digest=digest,
                           path=str(bundle), content="c", sync=True)
        journal_mod.record("session_adapter", sid=handle.sid, adapter="lost", digest="d",
                           path=str(tmp_path / "missing.lora"), content="c2", sync=True)
        crash_dispatcher(ex_a)
        prefix = list(req.tokens)
        await orphaned(tmp_path)
        journal_mod.reset()
        journal_mod.configure(journal_dir)
        ex_b = make_executor(tmp_path)
        try:
            report = await ex_b.recover()
            adopted = report.supervisors[handle.sid]
            gate.touch()
            (key, resumed), = report.requests.items()
            tail = await resumed.result(timeout=RESULT_S)
            inventory = await adopted._client.serve_inventory()
        finally:
            await ex_b.close()
        return report, prefix, tail, adopted.adapters, inventory

    report, prefix, tail, held, inventory = run_async(flow())
    states = {a["adapter"]: a["state"] for a in report["reattached_adapters"]}
    assert states == {"tone": "attached", "lost": "error"}
    content = __import__("cloudpickle").loads(data)["digest"]
    assert held == {"tone": content}
    (entry,) = inventory["sessions"]
    assert entry["adapters"] == {"tone": content}
    assert counter_value("covalent_tpu_recovery_adapters_total", state="attached") == \
        counts0["attached"] + 1
    assert counter_value("covalent_tpu_recovery_adapters_total", state="error") == \
        counts0["error"] + 1
    assert prefix + tail == [10 + i + 1 for i in range(12)]


# -- the warm handoff and the preemption notice ---------------------------------


def test_serve_warm_handoff_zero_dropped_tokens(tmp_path, run_async):
    async def flow():
        ex = make_executor(tmp_path)
        try:
            handle = await open_session(ex, make_factory(step_delay=0.1, default_cap=12))
            requests = [await handle.request([100 * i]) for i in range(3)]
            for _ in range(200):
                if all(len(r.tokens) >= 4 for r in requests):
                    break
                await asyncio.sleep(0.05)
            assert all(len(r.tokens) >= 4 for r in requests)
            moved = await handle.handoff(reason="test")
            results = [await r.result(timeout=RESULT_S) for r in requests]
            stats = (moved, handle.handoffs, handle.generation, handle.reconnects,
                     handle.state, dict(handle.supervisor.replay_mismatches_by_road))
            late = await handle.request([7], params={"max_new_tokens": 3})
            late_result = await late.result(timeout=RESULT_S)
            await handle.close()
        finally:
            await ex.close()
        return results, stats, late_result

    results, stats, late_result = run_async(flow())
    moved, handoffs, generation, reconnects, state, roads = stats
    assert moved is True
    for i, tokens in enumerate(results):
        assert tokens == [100 * i + j + 1 for j in range(12)], tokens
    assert (handoffs, generation, reconnects, state) == (1, 2, 0, "open")
    assert roads["handoff"] == 0 and sum(roads.values()) == 0
    assert late_result == [8, 9, 10]


def test_serve_preempt_notice_triggers_auto_handoff(tmp_path, run_async):
    async def flow():
        ex = make_executor(tmp_path)
        try:
            handle = await open_session(ex, make_factory(step_delay=0.1, default_cap=12))
            requests = [await handle.request([100 * i]) for i in range(3)]
            for _ in range(200):
                if all(len(r.tokens) >= 4 for r in requests):
                    break
                await asyncio.sleep(0.05)
            os.kill(ex._agents["localhost"]._process._proc.pid, signal.SIGTERM)
            for _ in range(200):
                if handle.handoffs:
                    break
                await asyncio.sleep(0.05)
            results = [await r.result(timeout=RESULT_S) for r in requests]
            stats = (handle.handoffs, handle.state, handle.reconnects)
            await handle.close()
        finally:
            await ex.close()
        return results, stats

    results, (handoffs, state, reconnects) = run_async(flow())
    for i, tokens in enumerate(results):
        assert tokens == [100 * i + j + 1 for j in range(12)], tokens
    assert (handoffs, state, reconnects) == (1, "open", 0)


def test_handoff_replays_that_differ_are_counted_on_their_road(tmp_path, run_async):
    """An engine whose second generation streams other tokens: the caller
    keeps what was delivered, and the differing replayed tokens count
    under ``handoff`` (a preemption notice's under ``preempt``)."""

    def drifting_factory():
        import os as os_mod

        def factory():
            import time as time_mod

            shift = 0 if not os_mod.path.exists(marker) else 1000
            open(marker, "a").close()
            # the first generation holds after 4 tokens until the gate opens
            hold = None if shift else gate

            class Engine:
                slots = 2

                def __init__(self):
                    self.lanes = {}

                def admit(self, rid, prompt, params):
                    self.lanes[rid] = [shift + int(prompt[-1]) + i + 1 for i in range(10)]

                def step(self):
                    time_mod.sleep(0.05)
                    events = []
                    for rid in list(self.lanes):
                        if (hold and len(self.lanes[rid]) <= 6
                                and not os_mod.path.exists(hold)):
                            continue
                        taken, self.lanes[rid] = self.lanes[rid][:2], self.lanes[rid][2:]
                        if not self.lanes[rid]:
                            del self.lanes[rid]
                        events.append({"rid": rid, "tokens": taken, "done": rid not in self.lanes})
                    return events

                def cancel(self, rid):
                    self.lanes.pop(rid, None)

            return Engine()

        marker = str(tmp_path / "second_generation")
        gate = str(tmp_path / "gate")
        return factory

    async def flow():
        ex = make_executor(tmp_path)
        try:
            handle = await open_session(ex, drifting_factory())
            req = await handle.request([0])
            while len(req.tokens) < 4:
                await asyncio.sleep(0.05)
            delivered = len(req.tokens)
            moving = asyncio.ensure_future(handle.handoff())
            while not handle.handoffs:
                await asyncio.sleep(0.01)
            (tmp_path / "gate").touch()  # the old generation drains for its close
            assert await moving is True
            out = await req.result(timeout=RESULT_S)
            roads = dict(handle.supervisor.replay_mismatches_by_road)
            await handle.close()
        finally:
            await ex.close()
        return out, delivered, roads

    out, delivered, roads = run_async(flow())
    assert out[:delivered] == list(range(1, delivered + 1))
    assert out[delivered:] == [1000 + t for t in range(delivered + 1, 11)]
    assert roads == {"reconnect": 0, "reroute": 0, "hedge": 0, "handoff": delivered,
                     "preempt": 0}
