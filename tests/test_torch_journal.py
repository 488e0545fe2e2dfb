"""The port's write-ahead journal against the reference's.

The cases of ``tests/test_journal.py`` on ``covalent_tpu_plugin_torch``'s
own copy (framing, fsync batching, rotation, the replay fuzz: replay never
raises on a damaged log, a torn tail truncates, a bit-flipped record
skips, a snapshot plus its tail replays to the state of the full log),
then the two packages side by side: the same records give the same
segment bytes, and each package replays the other's log to the same
state.
"""

import json
import os
import struct

import pytest

from covalent_tpu_plugin.fleet import journal as ref_journal_mod
from covalent_tpu_plugin_torch.fleet import journal as journal_mod
from covalent_tpu_plugin_torch.fleet.journal import Journal, JournalState


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    monkeypatch.delenv("COVALENT_TPU_JOURNAL_DIR", raising=False)
    journal_mod.reset()
    ref_journal_mod.reset()
    yield
    journal_mod.reset()
    ref_journal_mod.reset()


def _open(tmp_path, **kwargs):
    kwargs.setdefault("fsync_ms", 0)
    return Journal.open(str(tmp_path / "wal"), **kwargs)


def _segments(journal):
    return journal._scan()[0]


# -- framing + append --------------------------------------------------------


def test_append_and_replay_roundtrip(tmp_path):
    j = _open(tmp_path)
    j.record("pool", name="tpu-a", spec={"capacity": 4})
    j.record("session", sid="s1", address="w0", sid_g="s1.g0")
    j.record("stream", sid="s1", rid="r1", prompt=[1, 2, 3])
    j.record("stream_hwm", sid="s1", rid="r1", hwm=7)
    j.record("task", op="op-1", pool="tpu-a", attempt=1)
    epoch = j.epoch
    j.close()

    j2 = Journal.open(j.directory, fsync_ms=0)
    assert j2.epoch == epoch + 1  # reopen bumps the fence
    assert j2.state.pools["tpu-a"] == {"capacity": 4}
    assert j2.state.sessions["s1"]["address"] == "w0"
    assert j2.state.streams[("s1", "r1")]["hwm"] == 7
    assert j2.state.tasks["op-1"]["pool"] == "tpu-a"
    assert j2.replay_skipped == 0 and j2.replay_truncated == 0
    j2.close()


def test_terminal_records_clear_state(tmp_path):
    j = _open(tmp_path)
    j.record("session", sid="s1", address="w0")
    j.record("stream", sid="s1", rid="r1")
    j.record("stream_done", sid="s1", rid="r1", outcome="ok")
    j.record("task", op="op-1")
    j.record("task_terminal", op="op-1", outcome="ok")
    j.record("session_closed", sid="s1")
    j.close()

    j2 = Journal.open(j.directory, fsync_ms=0)
    assert not j2.state.sessions
    assert not j2.state.streams
    assert not j2.state.tasks
    j2.close()


def test_hwm_is_monotonic(tmp_path):
    j = _open(tmp_path)
    j.record("stream", sid="s", rid="r")
    j.record("stream_hwm", sid="s", rid="r", hwm=9)
    j.record("stream_hwm", sid="s", rid="r", hwm=4)  # stale update
    assert j.state.streams[("s", "r")]["hwm"] == 9
    j.close()


# -- fuzz: torn tail ---------------------------------------------------------


def _live_segment(j):
    segs = _segments(j)
    assert segs
    return segs[-1][1]


def test_torn_tail_truncates_cleanly(tmp_path):
    j = _open(tmp_path)
    for i in range(5):
        j.record("task", op=f"op-{i}")
    j.close()
    path = _live_segment(j)
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size - 11)  # rip mid-record

    j2 = Journal.open(j.directory, fsync_ms=0)
    assert j2.replay_truncated == 1
    assert j2.replay_applied >= 4  # epoch + first four tasks survive
    assert "op-3" in j2.state.tasks and "op-4" not in j2.state.tasks
    # Post-truncation appends land on a clean boundary and replay fine.
    j2.record("task", op="op-new")
    j2.close()
    j3 = Journal.open(j.directory, fsync_ms=0)
    assert "op-new" in j3.state.tasks
    assert j3.replay_truncated == 0
    j3.close()


def test_truncated_length_prefix(tmp_path):
    j = _open(tmp_path)
    j.record("task", op="op-0")
    j.close()
    path = _live_segment(j)
    with open(path, "ab") as fh:
        fh.write(b"\x00\x00")  # two bytes of a would-be length prefix

    j2 = Journal.open(j.directory, fsync_ms=0)
    assert j2.replay_truncated == 1
    assert "op-0" in j2.state.tasks
    j2.close()


def test_garbage_length_treated_as_torn(tmp_path):
    j = _open(tmp_path)
    j.record("task", op="op-0")
    j.close()
    path = _live_segment(j)
    with open(path, "ab") as fh:
        fh.write(struct.pack(">I", 0x7FFFFFFF) + os.urandom(40))

    j2 = Journal.open(j.directory, fsync_ms=0)
    assert j2.replay_truncated == 1
    assert "op-0" in j2.state.tasks
    j2.close()


# -- fuzz: bit flips ---------------------------------------------------------


def test_bit_flip_skips_record_and_continues(tmp_path):
    j = _open(tmp_path)
    j.record("task", op="op-keep-1")
    j.record("task", op="op-flip")
    j.record("task", op="op-keep-2")
    j.close()
    path = _live_segment(j)
    data = bytearray(open(path, "rb").read())
    at = data.find(b"op-flip")
    assert at > 0
    data[at] ^= 0x40
    open(path, "wb").write(bytes(data))

    j2 = Journal.open(j.directory, fsync_ms=0)
    assert j2.replay_skipped == 1
    assert j2.replay_truncated == 0
    assert "op-keep-1" in j2.state.tasks and "op-keep-2" in j2.state.tasks
    assert "op-flip" not in j2.state.tasks
    j2.close()


def test_random_corruption_never_raises(tmp_path):
    import random

    rng = random.Random(18)
    j = _open(tmp_path)
    for i in range(50):
        j.record("stream", sid=f"s{i % 3}", rid=f"r{i}", prompt=[i])
    j.close()
    path = _live_segment(j)
    pristine = open(path, "rb").read()
    for trial in range(25):
        data = bytearray(pristine)
        for _ in range(rng.randrange(1, 6)):
            data[rng.randrange(len(data))] ^= 1 << rng.randrange(8)
        if rng.random() < 0.5:
            data = data[: rng.randrange(len(data))]
        open(path, "wb").write(bytes(data))
        j2 = Journal.open(j.directory, fsync_ms=0)  # must not raise
        j2.close()
        open(path, "wb").write(pristine)


# -- rotation + snapshot compaction ------------------------------------------


def test_rotation_compacts_behind_snapshot(tmp_path):
    j = _open(tmp_path, max_segment_bytes=600)
    for i in range(60):
        j.record("task", op=f"op-{i}", pool="p", attempt=1)
        j.record("task_terminal", op=f"op-{i}")
    j.record("task", op="op-live")
    j.close()
    segs, snaps = j._scan()
    assert snaps, "rotation must have written a snapshot"
    assert len(segs) <= 2, "covered segments must be compacted away"

    j2 = Journal.open(j.directory, fsync_ms=0)
    assert j2.state.tasks == {"op-live": {"op": "op-live"}}
    j2.close()


def test_snapshot_plus_tail_equals_full_log(tmp_path):
    # Same record sequence, rotated vs unrotated, must replay equal.
    recs = []
    for i in range(40):
        recs.append({"t": "session", "sid": f"s{i % 4}", "address": f"w{i}"})
        recs.append({"t": "stream", "sid": f"s{i % 4}", "rid": f"r{i}"})
        if i % 3 == 0:
            recs.append({"t": "stream_hwm", "sid": f"s{i % 4}",
                         "rid": f"r{i}", "hwm": i})
        if i % 5 == 0:
            recs.append({"t": "session_closed", "sid": f"s{(i + 2) % 4}"})

    j_small = Journal.open(str(tmp_path / "small"), fsync_ms=0,
                           max_segment_bytes=400)
    j_big = Journal.open(str(tmp_path / "big"), fsync_ms=0,
                         max_segment_bytes=1 << 30)
    for rec in recs:
        j_small.append(dict(rec))
        j_big.append(dict(rec))
    j_small.close()
    j_big.close()
    assert len(j_small._scan()[1]) >= 1  # compaction actually happened

    r_small = Journal.open(j_small.directory, fsync_ms=0)
    r_big = Journal.open(j_big.directory, fsync_ms=0)
    try:
        small, big = r_small.state.to_dict(), r_big.state.to_dict()
        # Epochs differ only by open() count on each dir; mask them.
        small.pop("epoch"), big.pop("epoch")
        assert small == big
    finally:
        r_small.close()
        r_big.close()


def test_corrupt_snapshot_falls_back(tmp_path):
    j = _open(tmp_path, max_segment_bytes=400)
    for i in range(40):
        j.record("pool", name=f"p{i}", spec={"capacity": i})
    j.close()
    _, snaps = j._scan()
    assert snaps
    # Corrupt the newest snapshot's embedded state.
    path = snaps[-1][1]
    doc = json.load(open(path))
    doc["state"]["pools"]["p0"] = {"capacity": 999}
    json.dump(doc, open(path, "w"))

    j2 = Journal.open(j.directory, fsync_ms=0)
    # Digest mismatch → snapshot rejected. Compaction deleted the covered
    # segments, so only the tail replays — but replay must not raise, and
    # the tail's records must be present.
    assert f"p39" in j2.state.pools
    assert j2.state.pools.get("p0") != {"capacity": 999}
    j2.close()


def test_interleaved_rotation_replay(tmp_path):
    """Writes striped across many rotations replay in order."""
    j = _open(tmp_path, max_segment_bytes=300)
    for i in range(30):
        j.record("stream", sid="s", rid=f"r{i}")
        j.record("stream_hwm", sid="s", rid=f"r{i}", hwm=i + 1)
        if i >= 2:
            j.record("stream_done", sid="s", rid=f"r{i - 2}")
    j.close()

    j2 = Journal.open(j.directory, fsync_ms=0)
    live = {rid for (_sid, rid) in j2.state.streams}
    assert live == {"r28", "r29"}
    assert j2.state.streams[("s", "r29")]["hwm"] == 30
    j2.close()


# -- epoch + singleton -------------------------------------------------------


def test_epoch_monotonic_across_opens(tmp_path):
    seen = []
    for _ in range(3):
        j = _open(tmp_path)
        seen.append(j.epoch)
        j.close()
    assert seen == sorted(seen) and len(set(seen)) == 3


def test_singleton_noop_when_unconfigured(tmp_path):
    assert journal_mod.get_journal() is None
    journal_mod.record("task", op="ignored")  # must be a silent no-op
    assert journal_mod.epoch() == 0


def test_singleton_configures_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("COVALENT_TPU_JOURNAL_DIR", str(tmp_path / "envwal"))
    journal_mod.record("task", op="op-env")
    j = journal_mod.get_journal()
    assert j is not None
    assert "op-env" in j.state.tasks
    assert journal_mod.epoch() == j.epoch >= 1


def test_fsync_batching_flusher(tmp_path):
    j = Journal.open(str(tmp_path / "wal"), fsync_ms=5)
    j.record("task", op="op-batched")
    import time

    deadline = time.time() + 2.0
    while j._dirty and time.time() < deadline:
        time.sleep(0.01)
    assert not j._dirty, "background flusher never fsynced"
    j.close()


# -- the port against the reference ------------------------------------------

#: Records of every kind the reducer knows, with nested fields, floats,
#: unicode and a key order that sort_keys must normalise.
MIXED_RECORDS = [
    {"t": "pool", "name": "gpu-a", "spec": {"capacity": 4, "labels": ["x", "y"]}},
    {"t": "pool_target", "name": "gpu-a", "capacity": 3},
    {"t": "replica_set", "name": "rs", "replicas": 2},
    {"t": "replica", "set": "rs", "sid": "rs:r0", "replica": 0},
    {"t": "replica", "set": "rs", "sid": "rs:r1", "replica": 1},
    {"t": "session", "sid": "s1", "sid_g": "s1.g0", "address": "localhost", "slots": 8,
     "digest": "ab" * 32, "payload": "/c/serve.pkl", "default_deadline_s": 0.0,
     "replica_of": ["rs", "r0"]},
    {"t": "stream", "sid": "s1", "rid": "r1", "prompt": [1, 2, 3],
     "params": {"max_new_tokens": 128}, "deadline_s": 2.5, "tenant": "t\u00e9",
     "resumed_from": 0},
    {"t": "stream_hwm", "sid": "s1", "rid": "r1", "hwm": 32},
    {"t": "stream", "sid": "s1", "rid": "r2", "prompt": [4], "params": {}},
    {"t": "stream_done", "sid": "s1", "rid": "r2", "outcome": "ok"},
    {"t": "task", "op": "d_0_1", "dispatch_id": "d", "node": 0, "t_dispatch": 1.25},
    {"t": "task", "op": "d_0_1", "operation_id": "d_0_1", "attempt": 1, "mode": "rpc"},
    {"t": "task", "op": "d_1_2", "dispatch_id": "d", "node": 1},
    {"t": "task_terminal", "op": "d_1_2", "outcome": "ok"},
    {"t": "replica", "set": "rs", "sid": "rs:r1", "state": "closed"},
    {"t": "some_future_kind", "z": 1, "a": [None, True]},
]


def _write(module, directory, records, **kwargs):
    journal = module.Journal.open(str(directory), fsync_ms=0, **kwargs)
    for rec in records:
        journal.append(dict(rec))
    journal.close()
    return journal


def _segment_bytes(directory) -> dict:
    return {p.name: p.read_bytes() for p in sorted(directory.iterdir())
            if p.name.startswith("journal.")}


def test_port_segments_are_byte_equal_to_the_reference(tmp_path):
    """The same records (the epoch record of open included) give the same
    segment files, byte for byte, rotation included."""
    for rotate in (1 << 30, 500):
        port_dir, ref_dir = tmp_path / f"port{rotate}", tmp_path / f"ref{rotate}"
        _write(journal_mod, port_dir, MIXED_RECORDS * 3, max_segment_bytes=rotate)
        _write(ref_journal_mod, ref_dir, MIXED_RECORDS * 3, max_segment_bytes=rotate)
        port, ref = _segment_bytes(port_dir), _segment_bytes(ref_dir)
        assert port and port == ref
        snaps = sorted(p.name for p in port_dir.iterdir() if p.name.startswith("snapshot."))
        assert snaps == sorted(p.name for p in ref_dir.iterdir()
                               if p.name.startswith("snapshot."))
        for name in snaps:
            port_doc = json.loads((port_dir / name).read_text())
            ref_doc = json.loads((ref_dir / name).read_text())
            assert port_doc == ref_doc


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_each_package_replays_the_others_log(tmp_path, writer, reader):
    """A log written by one package (rotated, with a snapshot, and a torn
    tail) replays in the other to the state the writer itself replays."""
    modules = {"port": journal_mod, "reference": ref_journal_mod}
    directory = tmp_path / "wal"
    _write(modules[writer], directory, MIXED_RECORDS * 4, max_segment_bytes=700)
    live = sorted(p for p in directory.iterdir() if p.name.startswith("journal."))[-1]
    with open(live, "ab") as fh:
        fh.write(struct.pack(">I", 40) + b"torn")
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    for p in directory.iterdir():
        (mirror / p.name).write_bytes(p.read_bytes())
    got = modules[reader].Journal.open(str(directory), fsync_ms=0)
    want = modules[writer].Journal.open(str(mirror), fsync_ms=0)
    try:
        assert got.recovered == want.recovered
        assert got.recovered["sessions"]["s1"]["sid_g"] == "s1.g0"
        assert got.recovered["streams"] == {"s1\x00r1": {
            "hwm": 32, "sid": "s1", "rid": "r1", "prompt": [1, 2, 3],
            "params": {"max_new_tokens": 128}, "deadline_s": 2.5, "tenant": "t\u00e9",
            "resumed_from": 0}}
        assert set(got.recovered["tasks"]) == {"d_0_1"}
        assert got.epoch == want.epoch
        assert (got.replay_applied, got.replay_skipped, got.replay_truncated) == \
            (want.replay_applied, want.replay_skipped, want.replay_truncated)
        assert got.replay_truncated == 1
    finally:
        got.close()
        want.close()


def test_state_reducer_matches_the_reference_record_for_record():
    """The two reducers agree after every record, unknown kinds included."""
    port, ref = JournalState(), ref_journal_mod.JournalState()
    for rec in MIXED_RECORDS * 2:
        port.apply(dict(rec))
        ref.apply(dict(rec))
        assert port.to_dict() == ref.to_dict()
        assert port.applied == ref.applied
    assert JournalState.from_dict(ref.to_dict()).to_dict() == ref.to_dict()
