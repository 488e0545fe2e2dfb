"""The port's serving families and request spans against the reference's.

Every family of ``serving/metrics.py`` the port has must carry the
reference's name, type, help, labels and buckets (read from both
packages' registries).  Then a small session on the pool server (a stub
engine) and a one-replica set: the request, token and TTFT families count
what was served, the per-session and per-replica series exist while the
session lives and are reaped when it closes, and every request is one
trace, from the dispatcher's ``serve.request`` root through the worker's
queue, admission and decode spans (their ids kept end to end) to the
tiling segments.
"""

import asyncio
import sys
from pathlib import Path

import pytest

from covalent_tpu_plugin.obs.metrics import REGISTRY as REF_REGISTRY
from covalent_tpu_plugin.serving import metrics as ref_metrics  # noqa: F401 - registers
from covalent_tpu_plugin_torch import GPUExecutor
from covalent_tpu_plugin_torch.fleet import pools  # noqa: F401 - registers its gauge
from covalent_tpu_plugin_torch.obs import events as obs_events
from covalent_tpu_plugin_torch.obs.metrics import REGISTRY
from covalent_tpu_plugin_torch.serving import metrics as m
from covalent_tpu_plugin_torch.serving import open_replica_set, open_session

from .test_torch_session import make_factory

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 60.0

#: Every serving family the port has: this slice's per-session families and
#: the replica-set, KV, hedge and handoff families of earlier slices.
FAMILIES = sorted(
    metric.name for metric in vars(m).values()
    if getattr(metric, "name", "").startswith("covalent_tpu_serve_"))


def test_the_port_has_this_slices_families():
    assert {"covalent_tpu_serve_requests_total", "covalent_tpu_serve_tokens_total",
            "covalent_tpu_serve_sessions", "covalent_tpu_serve_queue_depth",
            "covalent_tpu_serve_tokens_per_s", "covalent_tpu_serve_reconnects_total",
            "covalent_tpu_serve_ttft_seconds", "covalent_tpu_serve_request_seconds",
            "covalent_tpu_serve_worker_slots", "covalent_tpu_serve_replica_requests_total",
            "covalent_tpu_serve_replica_in_flight", "covalent_tpu_serve_prefix_hits",
            "covalent_tpu_serve_prefix_misses", "covalent_tpu_serve_prefill_positions",
            "covalent_tpu_serve_handoffs_total"} <= set(FAMILIES)


@pytest.mark.parametrize("name", FAMILIES + ["covalent_tpu_pool_slots"])
def test_a_family_is_the_references(name):
    port, ref = REGISTRY.get(name), REF_REGISTRY.get(name)
    assert port is not None and ref is not None
    assert (port.kind, port.help, port.label_names) == (ref.kind, ref.help, ref.label_names)
    assert getattr(port, "buckets", None) == getattr(ref, "buckets", None)


def _value(metric, **labels) -> float:
    if labels:
        return dict((tuple(sorted(k.items())), c.value) for k, c in metric._series()).get(
            tuple(sorted(labels.items())), 0.0)
    return metric.value


def _series(metric) -> list:
    return [labels for labels, _ in metric._series()]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("metrics")
    spans: list = []

    def listener(event):
        if event.get("type") == "span":
            spans.append(event)

    obs_events.add_listener(listener)

    async def flow():
        ex = GPUExecutor(transport="local", cache_dir=str(root / "cache"),
                         remote_cache=str(root / "remote"), python_path=sys.executable,
                         use_agent="pool", pool_preload="cloudpickle",
                         task_env={"PYTHONPATH": str(REPO)})
        out = {"before": {"ok": _value(m.SERVE_REQUESTS_TOTAL, outcome="ok"),
                          "tokens": m.SERVE_TOKENS_TOTAL.value,
                          "ttft": m.SERVE_TTFT_SECONDS.count,
                          "latency": m.SERVE_REQUEST_SECONDS.count,
                          "sessions": m.SERVE_SESSIONS.value}}
        try:
            handle = await open_session(ex, make_factory(step_delay=0.01), stats_interval_s=0.05)
            requests = [await handle.request([10 * i], params={"max_new_tokens": 3 + i})
                        for i in range(4)]
            out["results"] = [await r.result(timeout=WAIT_S) for r in requests]
            out["traces"] = {r.rid: (r.span.trace_id, r.span.span_id) for r in requests}
            while handle.stats.get("served", 0) < 4:
                await asyncio.sleep(0.02)
            await asyncio.sleep(0.1)  # one more stats record
            out["live"] = {"sessions": m.SERVE_SESSIONS.value,
                           "queue": _series(m.SERVE_QUEUE_DEPTH),
                           "tokens_per_s": _value(m.SERVE_TOKENS_PER_S, session=handle.sid),
                           "slots": {labels["state"]: c.value
                                     for labels, c in m.SERVE_WORKER_SLOTS._series()},
                           "sid": handle.sid}
            await handle.close()
            out["closed"] = {"sessions": m.SERVE_SESSIONS.value,
                             "queue": _series(m.SERVE_QUEUE_DEPTH),
                             "slots": _series(m.SERVE_WORKER_SLOTS)}
            rset = await open_replica_set([ex], make_factory(), replicas=1, name="mset")
            request = await rset.request([5], params={"max_new_tokens": 2})
            out["replica_result"] = await request.result(timeout=WAIT_S)
            out["replica_live"] = {
                "requests": _value(m.SERVE_REPLICA_REQUESTS_TOTAL, set="mset", replica="r0"),
                "in_flight": _value(m.SERVE_REPLICA_IN_FLIGHT, set="mset", replica="r0")}
            await rset.close()
            out["replica_closed"] = [s for s in _series(m.SERVE_REPLICA_REQUESTS_TOTAL)
                                     + _series(m.SERVE_REPLICA_IN_FLIGHT)
                                     if s.get("set") == "mset"]
            out["after"] = {"ok": _value(m.SERVE_REQUESTS_TOTAL, outcome="ok"),
                            "tokens": m.SERVE_TOKENS_TOTAL.value,
                            "ttft": m.SERVE_TTFT_SECONDS.count,
                            "latency": m.SERVE_REQUEST_SECONDS.count}
        finally:
            await ex.close()
        return out

    try:
        out = asyncio.run(flow())
    finally:
        obs_events.remove_listener(listener)
    out["spans"] = spans
    return out


def test_the_request_families_count_what_was_served(served):
    before, after = served["before"], served["after"]
    assert served["results"] == [[1, 2, 3], [11, 12, 13, 14], [21, 22, 23, 24, 25],
                                 [31, 32, 33, 34, 35, 36]]
    assert after["ok"] - before["ok"] == 5  # four requests and the replica's one
    assert after["tokens"] - before["tokens"] == 3 + 4 + 5 + 6 + 2
    assert after["ttft"] - before["ttft"] == 5 and after["latency"] - before["latency"] == 5


def test_the_session_series_live_with_the_session_and_go_with_it(served):
    live, closed, sid = served["live"], served["closed"], served["live"]["sid"]
    assert live["sessions"] == served["before"]["sessions"] + 1
    assert {"session": sid} in live["queue"] and live["tokens_per_s"] > 0
    assert live["slots"] == {"sessions": 1.0, "slots": 2.0, "busy": 0.0, "queued": 0.0}
    assert closed["sessions"] == served["before"]["sessions"]
    assert {"session": sid} not in closed["queue"] and closed["slots"] == []


def test_the_replica_series_live_with_the_replica_and_go_with_it(served):
    assert served["replica_result"] == [6, 7]
    assert served["replica_live"] == {"requests": 1.0, "in_flight": 0.0}
    assert served["replica_closed"] == []


def test_every_request_is_one_trace_from_dispatcher_to_worker(served):
    spans = served["spans"]
    for rid, (trace_id, root_id) in served["traces"].items():
        mine = [s for s in spans if s.get("trace_id") == trace_id]
        names = {s["name"] for s in mine}
        assert {"serve.request", "serve.worker.queue_wait", "serve.worker.admission",
                "serve.worker.decode", "serve.route", "serve.dispatch", "serve.ttft_wait",
                "serve.decode_stream"} <= names, (rid, names)
        root = next(s for s in mine if s["name"] == "serve.request")
        assert root["span_id"] == root_id and root["parent_id"] is None
        assert root["attributes"]["rid"] == rid
        # the worker's spans and the segments hang under the root, their ids
        # kept across the process boundary
        children = [s for s in mine if s is not root]
        assert all(s["parent_id"] == root_id for s in children)
        worker = [s for s in children if s["name"].startswith("serve.worker.")]
        assert all(s["attributes"]["rid"] == rid for s in worker)
        assert len({s["span_id"] for s in mine}) == len(mine)
