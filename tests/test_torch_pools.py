"""Fleet ``Pool`` targets: the port's ``fleet/pools.py`` against the reference's.

Spec strings (the compact form, JSON, ``COVALENT_TPU_POOLS``) must parse to
the reference's specs field for field, and bad ones fail as the
reference's do; TPU-VM discovery is refused by name.  Then what a pool is
for in the port: slots that sessions pin (bin-packing in a replica set's
placement, a disaggregated set's tiers by role), the local fallback, and
on pool servers on the CPU: ``open_session(pool, ...)`` pinning a slot for
the session's life, and a warm handoff from one pool to another whose
streams resume exactly once.
"""

import asyncio
import sys
from dataclasses import asdict
from pathlib import Path

import pytest

from covalent_tpu_plugin.fleet import pools as ref_pools
from covalent_tpu_plugin_torch import GPUExecutor
from covalent_tpu_plugin_torch.fleet import pools
from covalent_tpu_plugin_torch.fleet.pools import POOL_SLOTS, Pool, PoolRegistry, PoolSpec
from covalent_tpu_plugin_torch.obs import events as obs_events
from covalent_tpu_plugin_torch.serving import open_session
from covalent_tpu_plugin_torch.serving.disagg import DisaggregatedSet
from covalent_tpu_plugin_torch.serving.replicas import ReplicaSet

from .test_torch_session import make_factory

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 60.0

SPEC_STRINGS = [
    "a=10.0.0.1+10.0.0.2@4;cpu=local@2",
    "edge=ubuntu@10.0.0.9",
    "edge=ubuntu@10.0.0.9@cap3",
    "pre=h1@2!prefill;dec=h2@cap4!decode!spot",
    "cheap=h3!spot!decode",
    " ; solo=h4 ; ",
    '[{"name": "v", "workers": ["w1", "w2"], "capacity": 3, "role": "decode"}]',
    '{"name": "x", "fallback": true, "executor": {"poll_freq": 0.5}}',
    "",
]
BAD_STRINGS = ["noequals", "a=h@cap", "a=@3", "=h1", '[{"name": "v", "gpus": 2}]']


def specs(parse, text):
    return [asdict(spec) for spec in parse(text)]


@pytest.mark.parametrize("text", SPEC_STRINGS)
def test_a_spec_string_parses_to_the_references_specs(text):
    assert specs(pools.parse_pool_specs, text) == specs(ref_pools.parse_pool_specs, text)


@pytest.mark.parametrize("text", BAD_STRINGS)
def test_a_bad_spec_string_fails_as_the_references(text):
    with pytest.raises(ValueError):
        ref_pools.parse_pool_specs(text)
    with pytest.raises(ValueError):
        pools.parse_pool_specs(text)


def test_the_environment_form_registers_the_references_pools(monkeypatch):
    monkeypatch.setenv(pools.POOLS_ENV, SPEC_STRINGS[0] + ";" + SPEC_STRINGS[3])
    port = PoolRegistry.from_environment()
    ref = ref_pools.PoolRegistry.from_environment()
    assert [asdict(p.spec) for p in port.pools()] == [asdict(p.spec) for p in ref.pools()]
    assert port.total_capacity() == ref.total_capacity() == 4 + 2 + 2 + 4
    assert port.fallback_pool().name == "cpu" and not port.get("a").started


def test_the_config_form_is_read_when_the_environment_is_unset(monkeypatch):
    monkeypatch.delenv(pools.POOLS_ENV, raising=False)
    monkeypatch.setattr(pools, "get_config",
                        lambda key, default=None: "g=w1@3" if key == "fleet.pools" else default)
    registry = PoolRegistry.from_environment()
    assert [(p.name, p.spec.workers, p.capacity) for p in registry.pools()] == [
        ("g", ("w1",), 3)]


def test_tpu_discovery_is_refused_by_name():
    with pytest.raises(NotImplementedError, match="discovery.py"):
        pools.parse_pool_specs("spare=tpu:my-v5e-8@2")
    with pytest.raises(NotImplementedError, match="discovery.py"):
        PoolRegistry().register_tpu("my-v5e-8")
    pool = PoolRegistry().register({"name": "t", "tpu_name": "my-v5e-8"})
    with pytest.raises(NotImplementedError, match="discovery.py"):
        pool.executor


def _slots(name: str) -> dict:
    return {labels["state"]: child.value for labels, child in POOL_SLOTS._series()
            if labels["pool"] == name}


def test_slots_are_counted_and_published():
    pool = Pool(PoolSpec(name="count", capacity=2))
    assert _slots("count") == {"in_use": 0.0, "free": 2.0}
    pool.place()
    pool.place()
    pool.place()  # over capacity: placed, no slot free
    assert (pool.in_use, pool.free_slots, pool.placed_total) == (3, 0, 3)
    assert _slots("count") == {"in_use": 3.0, "free": 0.0}
    for _ in range(4):
        pool.release()
    assert pool.in_use == 0 and _slots("count") == {"in_use": 0.0, "free": 2.0}
    assert Pool(PoolSpec(name="floor", capacity=0)).capacity == 1


def test_the_fallback_is_a_local_pool_built_on_first_use(tmp_path):
    registry = PoolRegistry()
    fallback = registry.ensure_fallback(cache_dir=str(tmp_path / "c"))
    assert registry.ensure_fallback() is fallback and registry.fallback_pool() is fallback
    assert (fallback.name, fallback.capacity, fallback.fallback) == ("local-fallback", 2, True)
    assert not fallback.started and not fallback.warm
    executor = fallback.executor
    assert isinstance(executor, GPUExecutor) and executor.transport_kind == "local"
    assert fallback.status()["serve_sessions"] == {} and fallback.status()["workers"] == ["local"]


class _Stub:
    """A stand-in executor: identity only."""

    def __init__(self, role: str = ""):
        self.serve_role = role


def test_replica_placement_spreads_then_packs_into_free_slots():
    roomy = Pool(PoolSpec(name="roomy", capacity=4), executor=_Stub())
    tight = Pool(PoolSpec(name="tight", capacity=1), executor=_Stub())
    bare = _Stub()
    rset = ReplicaSet([tight, bare, roomy], make_factory())
    assert [t[1] for t in rset._rank_targets()] == [roomy, tight, None]
    rset._placements["r0"] = (roomy.executor, roomy)
    assert rset._rank_targets()[0][1] is tight  # spread first
    rset._placements["r1"] = (tight.executor, tight)
    assert rset._rank_targets()[0] == (bare, None)


def test_a_disaggregated_set_places_each_tier_on_its_role():
    pre = Pool(PoolSpec(name="pre", role="prefill"), executor=_Stub())
    dec = Pool(PoolSpec(name="dec", role="decode"), executor=_Stub())
    plain = Pool(PoolSpec(name="plain"), executor=_Stub())
    dset = DisaggregatedSet([dec, plain, pre], make_factory(), prefill_replicas=1,
                            decode_replicas=2)
    dset._opening_role = "prefill"
    assert [t[1].name for t in dset._rank_targets()] == ["pre", "plain", "dec"]
    dset._opening_role = "decode"
    assert [t[1].name for t in dset._rank_targets()] == ["dec", "plain", "pre"]


# ---------------------------------------------------------------------------
# Sessions on pools, on pool servers
# ---------------------------------------------------------------------------


def _executor(root: Path, name: str) -> GPUExecutor:
    return GPUExecutor(transport="local", cache_dir=str(root / name / "cache"),
                       remote_cache=str(root / name / "remote"), python_path=sys.executable,
                       use_agent="pool", pool_preload="cloudpickle",
                       task_env={"PYTHONPATH": str(REPO)})


@pytest.fixture(scope="module")
def moved(tmp_path_factory):
    root = tmp_path_factory.mktemp("pool_sessions")
    registry = PoolRegistry()
    a = registry.register(PoolSpec(name="pa", capacity=2), executor=_executor(root, "a"))
    b = registry.register(PoolSpec(name="pb", capacity=2), executor=_executor(root, "b"))
    out = {"a": a, "b": b}
    seen: list = []

    async def flow():
        try:
            # every stream holds after its first token until the move is
            # done, however long the replacement's open takes
            hold = root / "moved"
            handle = await a.open_session(make_factory(step_delay=0.02, slots=3, chunk=1,
                                                       default_cap=30, hold=str(hold)))
            out["pinned"] = (a.in_use, b.in_use, handle.pool is a)
            out["status"] = a.status()
            await b.executor.lease_gang()  # b's pool server up: the move is the open
            requests = [await handle.request([100 * i]) for i in range(3)]
            while not all(r.tokens for r in requests):
                await asyncio.sleep(0.01)
            out["before"] = [len(r.tokens) for r in requests]
            out["moved"] = await handle.handoff(target=b)
            out["replayed"] = [e for e in seen if e.get("type") == "serve.handoff_complete"]
            hold.touch()
            out["after_move"] = (a.in_use, b.in_use, handle.pool is b,
                                 handle.executor is b.executor,
                                 sorted(a.executor._serve_handles),
                                 sorted(b.executor._serve_handles) == [handle.sid])
            out["results"] = [await r.result(timeout=WAIT_S) for r in requests]
            out["handle"] = (handle.handoffs, handle.reconnects, handle.replay_mismatches,
                             handle.generation)
            await handle.close()
            out["closed"] = (a.in_use, b.in_use)
            # a pool target through serving.open_session, without a handoff
            other = await open_session(b, make_factory())
            out["second"] = (b.in_use, await (await other.request([7])).result(timeout=WAIT_S))
            await other.close()
            out["second_closed"] = b.in_use
        finally:
            await registry.close()

    obs_events.add_listener(seen.append)
    try:
        asyncio.run(flow())
    finally:
        obs_events.remove_listener(seen.append)
    return out


def test_a_session_on_a_pool_pins_a_slot(moved):
    assert moved["pinned"] == (1, 0, True)
    assert list(moved["status"]["serve_sessions"]) and moved["status"]["in_use"] == 1
    assert moved["second"][0] == 1 and moved["second_closed"] == 0


def test_a_handoff_to_another_pool_moves_the_session_and_its_slot(moved):
    assert moved["moved"] is True
    assert moved["after_move"] == (0, 1, True, True, [], True)
    assert moved["closed"] == (0, 0)


def test_every_stream_resumes_exactly_once_across_pools(moved):
    assert all(0 < n < 30 for n in moved["before"])
    # every stream was in flight at the swap and was replayed on the new pool
    assert [e["replayed"] for e in moved["replayed"]] == [3]
    assert moved["results"] == [list(range(100 * i + 1, 100 * i + 31)) for i in range(3)]
    handoffs, reconnects, mismatches, generation = moved["handle"]
    assert (handoffs, reconnects, mismatches, generation) == (1, 0, 0, 2)
