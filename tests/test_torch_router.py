"""The replica router, the fair work queue and the health monitor, against
the reference's, on a fake clock.

``covalent_tpu_plugin_torch.serving.replicas.ReplicaRouter`` with its
``fleet.queue.FairWorkQueue`` and ``fleet.health.HealthMonitor`` are own
copies of the reference's.  Each test drives one script of operations
through both packages' objects, built from the same arguments on the same
fake clock, and records what they did: the order items leave the queue,
which replica each request is placed on and why, which submits are shed,
and the health scores and states after each signal.  The two records must
be equal, and each script checks that it reached what it is named for.
"""

import pytest

from covalent_tpu_plugin.fleet import health as ref_health
from covalent_tpu_plugin.fleet import queue as ref_queue
from covalent_tpu_plugin.serving import replicas as ref_replicas
from covalent_tpu_plugin_torch.fleet import health as port_health
from covalent_tpu_plugin_torch.fleet import queue as port_queue
from covalent_tpu_plugin_torch.serving import replicas as port_replicas

PACKAGES = {"reference": (ref_queue, ref_health, ref_replicas),
            "port": (port_queue, port_health, port_replicas)}


class Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _item(queue_mod, name: str, tenant: str = "", **meta):
    return queue_mod.WorkItem(fn=None, args=(), kwargs={},
                              task_metadata={"dispatch_id": name, "node_id": 0, **meta},
                              tenant=tenant or queue_mod.DEFAULT_TENANT)


def _name(item) -> str:
    return item.task_metadata["dispatch_id"]


def both(script):
    """Run ``script(queue_mod, health_mod, replicas_mod, clock)`` for each
    package; returns {package: its record}, asserting they are equal."""
    records = {}
    for package, mods in PACKAGES.items():
        records[package] = script(*mods, Clock())
    assert records["port"] == records["reference"]
    return records["port"]


# ---------------------------------------------------------------------------
# FairWorkQueue
# ---------------------------------------------------------------------------


def test_drr_dequeues_by_weight_and_stamps_waits():
    def script(qm, _hm, _rm, clock):
        q = qm.FairWorkQueue(weights={"heavy": 3.0, "light": 1.0}, clock=clock)
        for i in range(12):
            q.put(_item(qm, f"h{i}", "heavy"))
            clock.now += 0.5
        for i in range(4):
            q.put(_item(qm, f"l{i}", "light"))
        record = [("backlog", q.backlog(), q.oldest_age())]
        record += [_name(q.pop()) for _ in range(8)]
        record.append(("removed", [_name(i) for i in q.remove(lambda i: _name(i) == "h7")]))
        record += [_name(q.pop()) for _ in range(len(q))]
        record.append(q.pop())
        return record

    record = both(script)
    order = record[1:9]
    assert sum(n.startswith("h") for n in order) == 6  # a 3:1 share
    assert record[-1] is None


@pytest.mark.parametrize("policy", ["reject", "shed_oldest"])
def test_the_depth_bound_rejects_or_sheds_alike(policy):
    def script(qm, _hm, _rm, clock):
        q = qm.FairWorkQueue(max_depth=3, policy=policy, clock=clock)
        record = []
        for i, tenant in enumerate(["a", "b", "a", "b", "a"]):
            try:
                shed = q.put(_item(qm, f"x{i}", tenant))
                record.append(("put", f"x{i}", [_name(v) for v in shed]))
            except qm.QueueFullError as err:
                record.append(("full", f"x{i}", err.fault_label, err.fault_transient))
        record.append([_name(i) for i in q.drain()])
        return record

    record = both(script)
    if policy == "reject":
        assert [r[0] for r in record[:-1]] == ["put", "put", "put", "full", "full"]
    else:
        # the oldest goes, whoever's it is; what is left drains lane by lane
        assert record[3:5] == [("put", "x3", ["x0"]), ("put", "x4", ["x1"])]
        assert record[-1] == ["x2", "x4", "x3"]


# ---------------------------------------------------------------------------
# HealthMonitor
# ---------------------------------------------------------------------------


def test_health_scores_and_states_follow_the_same_signals():
    """A straggler among three peers degrades, and with faults on top is
    quarantined; after the cooldown one canary slot opens, a failed probe
    lengthens the dwell, a passed one readmits it to probation; a replica
    with a few faults heals with successes."""

    def script(_qm, hm, _rm, clock):
        monitor = hm.HealthMonitor(clock=clock)
        record = []

        def look(tag):
            record.append((tag, {k: (round(monitor.score(k), 9), monitor.state(k))
                                 for k in ("r0", "r1", "r2")}))

        for step in range(12):
            monitor.record_latency("r0", 0.10, group="set")
            monitor.record_latency("r1", 0.11, group="set")
            monitor.record_latency("r2", 2.0 if step > 3 else 0.1, group="set")
            clock.now += 1.0
            look(f"latency{step}")
        for _ in range(4):
            monitor.record_fault("r2", label="rpc_channel", group="set")
        look("straggler_faults")
        for _ in range(2):
            monitor.record_fault("r1", label="engine_error", group="set")
        look("faults")
        for _ in range(6):
            monitor.record_success("r1", group="set")
        monitor.record_queue_depth("r0", 3.0, group="set")
        look("healed")
        record.append(("probe_early", monitor.allow_probe("r2")))
        clock.now += 60.0
        record.append(("probe", monitor.allow_probe("r2"), monitor.allow_probe("r2")))
        monitor.record_probe("r2", False)
        look("probe_failed")
        clock.now += 1000.0
        record.append(("probe_again", monitor.allow_probe("r2")))
        monitor.record_probe("r2", True)
        look("probe_passed")
        record.append(("rank", [monitor.rank(k) for k in ("r0", "r1", "r2")]))
        return record

    record = both(script)
    states = {r[0]: r[1] for r in record if len(r) == 2 and isinstance(r[1], dict)}
    assert states["latency11"]["r2"][1] == "degraded"
    assert states["straggler_faults"]["r2"][1] == "quarantined"
    assert states["probe_passed"]["r2"][1] == "probation"
    assert ("probe", True, False) in record


# ---------------------------------------------------------------------------
# ReplicaRouter
# ---------------------------------------------------------------------------


def _views(rm, spec: dict) -> dict:
    """{replica id: (open, load, capacity, alive, degraded, quarantined)}."""
    views = {}
    for rid, (is_open, load, cap, *rest) in spec.items():
        alive, degraded, quarantined = (rest + [None, False, False][len(rest):])
        views[rid] = rm.ReplicaView(rid, open=is_open, load=load, capacity=cap, alive=alive,
                                    degraded=degraded, quarantined=quarantined)
    return views


def _placed(assignments) -> list:
    return [(_name(item), rid, outcome) for item, rid, outcome in assignments]


def test_least_loaded_rotates_ties_and_spreads_a_burst():
    def script(qm, _hm, rm, clock):
        router = rm.ReplicaRouter(clock=clock)
        views = _views(rm, {"r0": (True, 0, 4), "r1": (True, 0, 4), "r2": (True, 2, 4)})
        for i in range(6):
            router.submit(_item(qm, f"q{i}"))
        record = _placed(router.pump(views))
        record.append(router.queued)
        return record

    record = both(script)
    replicas = [rid for _, rid, _ in record[:-1]]
    # the burst levels the loads (r2 started with 2), ties rotating
    assert sorted([replicas.count("r0"), replicas.count("r1"), 2 + replicas.count("r2")]) == [
        2, 3, 3]
    assert replicas[:2] in (["r0", "r1"], ["r1", "r0"]) and record[-1] == 0


def test_sticky_pins_wait_out_a_reconnect_and_repin_after_death():
    def script(qm, _hm, rm, clock):
        router = rm.ReplicaRouter(sticky_ttl_s=30.0, clock=clock)
        open_views = _views(rm, {"r0": (True, 0, 4), "r1": (True, 0, 4)})
        record = []
        router.submit(_item(qm, "a1", sticky="user"))
        record += _placed(router.pump(open_views))
        pinned = record[0][1]
        other = "r1" if pinned == "r0" else "r0"
        # its replica reconnecting: the pinned request waits for it
        reconnecting = _views(rm, {pinned: (False, 0, 4, True), other: (True, 0, 4)})
        router.submit(_item(qm, "a2", sticky="user"))
        router.submit(_item(qm, "b1"))
        record += _placed(router.pump(reconnecting))
        record.append(("queued", router.queued))
        record += _placed(router.pump(open_views))
        # its replica dead: a fresh placement, pinned anew
        dead = _views(rm, {pinned: (False, 0, 4, False), other: (True, 0, 4)})
        router.submit(_item(qm, "a3", sticky="user"))
        record += _placed(router.pump(dead))
        record.append(("pin", router.sticky_target("user")))
        clock.now += 31.0
        record.append(("expired", router.sticky_target("user"), router.sticky_count()))
        return record

    record = both(script)
    pinned = record[0][1]
    assert record[0][2] == "least_loaded"
    assert record[1][0] == "b1" and record[2] == ("queued", 1)
    assert record[3] == ("a2", pinned, "sticky")
    assert record[4][1] != pinned and record[5] == ("pin", record[4][1])
    assert record[6] == ("expired", None, 0)


def test_prefix_affinity_ranks_below_sticky_and_above_least_loaded():
    def script(qm, _hm, rm, clock):
        router = rm.ReplicaRouter(clock=clock)
        views = _views(rm, {"r0": (True, 0, 4), "r1": (True, 0, 4)})
        record = []
        router.submit(_item(qm, "p1", prefix_key="abc"))
        record += _placed(router.pump(views))
        site = record[0][1]
        busy = _views(rm, {site: (True, 3, 4), ("r1" if site == "r0" else "r0"): (True, 0, 4)})
        router.submit(_item(qm, "p2", prefix_key="abc"))
        record += _placed(router.pump(busy))
        router.pin("user", "r1" if site == "r0" else "r0")
        router.submit(_item(qm, "p3", prefix_key="abc", sticky="user"))
        record += _placed(router.pump(views))
        full = _views(rm, {site: (True, 4, 4), ("r1" if site == "r0" else "r0"): (True, 0, 4)})
        router.submit(_item(qm, "p4", prefix_key="abc"))
        record += _placed(router.pump(full))
        router.forget_replica(site)
        record.append(("site", router.prefix_site("abc")))
        return record

    record = both(script)
    # the sticky placement moved the prefix's site, so p4 follows it there
    assert [r[2] for r in record[:4]] == ["least_loaded", "prefix_affinity", "sticky",
                                          "prefix_affinity"]
    assert record[3][1] == record[2][1] != record[0][1]


def test_drr_decides_whose_request_goes_when_lanes_are_short():
    def script(qm, _hm, rm, clock):
        router = rm.ReplicaRouter(weights={"gold": 3.0, "free": 1.0}, clock=clock)
        for i in range(9):
            router.submit(_item(qm, f"g{i}", "gold"))
            router.submit(_item(qm, f"f{i}", "free"))
        record = []
        for _ in range(4):
            record.append(_placed(router.pump(_views(rm, {"r0": (True, 6, 8),
                                                          "r1": (True, 7, 8)}))))
            record.append(router.backlog())
        return record

    record = both(script)
    first_wave = [n for batch in record[0::2] for n, _, _ in batch]
    assert len(first_wave) == 12 and sum(n.startswith("g") for n in first_wave) == 9


def test_shedding_degraded_and_quarantined_replicas():
    def script(qm, _hm, rm, clock):
        router = rm.ReplicaRouter(queue_max=2, clock=clock)
        record = []
        for i in range(3):
            try:
                router.submit(_item(qm, f"s{i}"))
                record.append(("queued", f"s{i}"))
            except qm.QueueFullError as err:
                record.append(("shed", f"s{i}", err.fault_label))
        views = _views(rm, {"healthy": (True, 3, 4), "slow": (True, 0, 4, True, True, False),
                            "sick": (True, 0, 4, True, False, True)})
        record += _placed(router.pump(views))
        router.set_queue_max(0)
        for i in range(4):
            router.submit(_item(qm, f"t{i}"))
        record += _placed(router.pump(views))
        record.append(("left", router.queued, [_name(i) for i in router.drain()]))
        return record

    record = both(script)
    assert record[2] == ("shed", "s2", "admission_shed")
    placed = [r for r in record if len(r) == 3 and r[0][0] in "st" and r[0] != "shed"]
    assert all(rid != "sick" for _, rid, _ in placed)
    assert [rid for _, rid, _ in placed][:1] == ["healthy"]  # the healthy lane first
