"""The port's observability copy (``obs/metrics.py``, ``obs/trace.py``,
``obs/events.py``) against the JAX package's, on the CPU.

The same operations on both packages' objects must give the same state: the
registries' JSON snapshots and Prometheus text (timestamps aside), and a
span tree's stage accounting under one scripted clock.
"""

import itertools
import json

import pytest

from covalent_tpu_plugin.obs import events as ref_events
from covalent_tpu_plugin.obs import metrics as ref_metrics
from covalent_tpu_plugin.obs import trace as ref_trace
from covalent_tpu_plugin_torch.obs import events, metrics, trace


def _drive(registry) -> None:
    """One fixed script of metric operations."""
    tasks = registry.counter("covalent_tpu_tasks_total", "Electron outcomes", ("outcome",))
    tasks.labels(outcome="completed").inc()
    tasks.labels(outcome="completed").inc(2)
    tasks.labels(outcome='fail"ed\n').inc()
    active = registry.gauge("covalent_tpu_active_electrons", "In flight")
    active.inc(3)
    active.dec()
    registry.gauge("covalent_tpu_queue_depth", "Depth", ("tenant",)).labels(tenant="a").set(7.5)
    hist = registry.histogram("covalent_tpu_span_duration_seconds", "Spans", ("span",))
    for value, trace_id in ((0.0004, "t1"), (0.03, None), (0.7, "t2"), (400.0, "t3")):
        hist.labels(span="executor.poll").observe(value, trace_id=trace_id)
    registry.histogram("covalent_tpu_custom_seconds", "", buckets=(1.0, 0.1)).observe(0.5)
    registry.counter("covalent_tpu_unused_total")


def _without_clocks(snapshot: dict) -> dict:
    snapshot = json.loads(json.dumps(snapshot))
    snapshot.pop("ts")
    for metric in snapshot["metrics"].values():
        for series in metric["series"]:
            for exemplar in series.get("exemplars", {}).values():
                exemplar.pop("ts")
    return snapshot


def test_registries_give_equal_snapshots_and_text():
    ref, port = ref_metrics.Registry(), metrics.Registry()
    _drive(ref)
    _drive(port)
    assert _without_clocks(port.snapshot()) == _without_clocks(ref.snapshot())
    assert port.prometheus_text() == ref.prometheus_text()
    # OpenMetrics exemplars carry the observation's clock: compare without it.
    strip = [line.rsplit(" ", 1)[0] if " # {" in line else line
             for text in (ref.prometheus_text(openmetrics=True),
                          port.prometheus_text(openmetrics=True))
             for line in text.splitlines()]
    half = len(strip) // 2
    assert strip[:half] == strip[half:] and strip[-1] == "# EOF"
    assert 'outcome="fail\\"ed\\n"' in port.prometheus_text()


@pytest.mark.parametrize("call", [
    lambda r: r.histogram("covalent_tpu_tasks_total"),
    lambda r: r.counter("covalent_tpu_tasks_total", label_names=("other",)),
    lambda r: r.histogram("covalent_tpu_custom_seconds", buckets=(2.0,)),
    lambda r: r.counter("covalent_tpu_tasks_total").labels(wrong="x"),
    lambda r: r.counter("covalent_tpu_tasks_total", label_names=("outcome",)).inc(),
    lambda r: r.counter("covalent_tpu_unused_total").inc(-1),
])
def test_registries_refuse_the_same_misuse(call):
    for module in (ref_metrics, metrics):
        registry = module.Registry()
        _drive(registry)
        with pytest.raises(ValueError):
            call(registry)


class _Clock:
    """A scripted clock: each read advances by the next step."""

    def __init__(self, steps):
        self._steps, self._now = itertools.cycle(steps), 1000.0

    def perf_counter(self) -> float:
        self._now += next(self._steps)
        return self._now

    def time(self) -> float:
        return 1.7e9


def _span_tree(module) -> "module.Span":
    with module.Span("executor.task") as root:
        with module.Span("executor.stage"):
            with module.Span("executor.stage.pickle"):
                pass
        for _ in range(2):
            with module.Span("executor.upload"):
                pass
        with module.Span("executor.execute"):
            assert module.current_span().name == "executor.execute"
        with module.Span("executor.profile"):
            pass
    return root


def test_span_trees_give_equal_stage_accounting(monkeypatch):
    steps = [0.0, 0.25, 0.5, 0.125, 1.0, 0.375, 0.0625, 2.0, 0.75, 4.0, 0.03125, 0.5]
    roots = []
    for module in (ref_trace, trace):
        monkeypatch.setattr(module, "time", _Clock(steps))
        roots.append(_span_tree(module))
    ref_root, port_root = roots
    assert port_root.stage_durations == ref_root.stage_durations
    assert set(port_root.stage_durations) == {"stage", "upload", "execute", "profile"}
    assert port_root.summary() == ref_root.summary()
    exclude = ("execute", "profile")
    assert port_root.overhead(exclude=exclude) == ref_root.overhead(exclude=exclude)
    assert port_root.overhead(exclude=exclude) == pytest.approx(
        port_root.stage_durations["stage"] + port_root.stage_durations["upload"])
    assert port_root.total() == ref_root.total()
    assert trace.current_span() is None


def test_spans_record_errors_and_record_span_emits(monkeypatch):
    seen = []
    events.add_listener(seen.append)
    try:
        with pytest.raises(KeyError):
            with trace.Span("executor.task") as root:
                raise KeyError("x")
        span_id = trace.record_span("executor.execute", trace_id=root.trace_id,
                                    parent_id=root.span_id, start_ts=5.0, duration_s=-1)
    finally:
        events.remove_listener(seen.append)
    assert root.status == "ERROR" and "KeyError" in root.attributes["error"]
    spans = [e for e in seen if e["type"] == "span"]
    assert [e["name"] for e in spans] == ["executor.task", "executor.execute"]
    assert spans[1]["span_id"] == span_id and spans[1]["parent_id"] == root.span_id
    assert spans[1]["duration_s"] == 0.0  # clamped, as the reference's


def _emit_many(sink, n: int) -> None:
    for i in range(n):
        sink.emit("task.state", operation_id=f"op{i:03d}", state="running")


def test_events_rotate_at_the_bound(tmp_path):
    path = tmp_path / "events.jsonl"
    sink = events.EventSink(str(path), max_bytes=400, backups=2)
    _emit_many(sink, 40)
    sink.close()
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["events.jsonl", "events.jsonl.1", "events.jsonl.2"]
    for name in files[1:]:
        size = (tmp_path / name).stat().st_size
        assert 400 <= size < 400 + 200  # rotated right after crossing the bound
    # the newest generations survive, in order
    kept = [json.loads(line)["operation_id"] for name in reversed(files)
            for line in (tmp_path / name).read_text().splitlines()]
    assert kept == sorted(kept) and kept[-1] == "op039"


def test_events_rotate_like_the_reference(tmp_path, monkeypatch):
    for module in (events, ref_events):
        monkeypatch.setattr(module, "time", _Clock([0.0]))  # one ts for every line
    counts = []
    for name, module in (("ref", ref_events), ("port", events)):
        path = tmp_path / name / "events.jsonl"
        sink = module.EventSink(str(path), max_bytes=300, backups=0)
        _emit_many(sink, 25)
        sink.close()
        counts.append(sorted((p.name, len(p.read_text().splitlines()))
                             for p in path.parent.iterdir()))
    assert counts[0] == counts[1] and counts[1][0][0] == "events.jsonl"


def test_event_sink_env_configure_and_reset(tmp_path, monkeypatch):
    env_path = tmp_path / "env.jsonl"
    monkeypatch.setenv("COVALENT_TPU_EVENTS_PATH", str(env_path))
    try:
        assert events.reset().path == str(env_path)
        other = tmp_path / "other.jsonl"
        events.configure(str(other))
        events.emit("node.state", node_id=1, state="running")
        events.reset()
        events.emit("node.state", node_id=2, state="completed")
        events.get_sink().close()
    finally:
        monkeypatch.delenv("COVALENT_TPU_EVENTS_PATH")
        events.reset()
    assert [json.loads(x)["node_id"] for x in other.read_text().splitlines()] == [1]
    assert [json.loads(x)["node_id"] for x in env_path.read_text().splitlines()] == [2]
    assert events.emit("node.state") is None  # disabled and unobserved
