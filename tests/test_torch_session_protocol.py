"""The port's resident runtime against the reference's, on one command script.

``python covalent_tpu_plugin/harness.py --serve`` and the port's
``python covalent_tpu_plugin_torch/harness.py --serve`` run as subprocesses
and are fed the same commands: a ping, a request to an unknown session, a
digest mismatch, an open, a duplicate open, requests that fill a bounded
queue and shed, a cancel of a queued and of a running request, a deadline
spent queued and one spent running, a prefill the engine cannot run and
one for an unknown session, a request carrying a KV bundle whose digest
does not match (it degrades to a full prefill), an engine refusal,
malformed and unknown commands, two closes, a frames negotiation and a
shutdown.  The engine is a deterministic stub pickled by value whose lanes
can be held on a file, so every event happens at a known point of the
script.  Both runtimes must answer with the same events, in the same order
per request: only pid, timestamps, the values of the seq numbers and the
timing fields (``gen_s``, ``tokens_per_s``) may differ.

The script runs twice: on JSON lines, and on binary frames negotiated
first (``frames`` arm), where every command is a frame, bytes ride frame
bodies, and tokens come back coalesced in ``telemetry_batch`` frames,
which the comparison unpacks record by record.
"""

import base64
import hashlib
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import cloudpickle
import pytest

from covalent_tpu_plugin.transport import frames as ref_frames

REPO = Path(__file__).resolve().parent.parent
RUNTIMES = {
    "reference": REPO / "covalent_tpu_plugin" / "harness.py",
    "port": REPO / "covalent_tpu_plugin_torch" / "harness.py",
}
WAIT_S = 60.0


def gated_factory():
    """A one-slot stub engine.  A lane emits its first token at the first
    step, then two a step; a lane whose params name a ``hold`` file emits
    nothing after its first token until that file exists.  Closure-local,
    so cloudpickle ships it by value."""

    def factory():
        import os as os_mod
        import time as time_mod

        class Engine:
            slots = 1

            def __init__(self):
                self.lanes = {}

            def admit(self, rid, prompt, params):
                if not prompt:
                    raise ValueError("prompt needs at least one token")
                cap = int(params.get("max_new_tokens", 4))
                self.lanes[rid] = {"left": [prompt[-1] + i + 1 for i in range(cap)],
                                   "hold": params.get("hold"), "sent": 0}

            def step(self):
                time_mod.sleep(0.005)
                events = []
                for rid, lane in list(self.lanes.items()):
                    if lane["sent"] and lane["hold"] and not os_mod.path.exists(lane["hold"]):
                        continue
                    n = 1 if lane["sent"] == 0 else 2
                    taken, lane["left"] = lane["left"][:n], lane["left"][n:]
                    lane["sent"] += len(taken)
                    done = not lane["left"]
                    if done:
                        del self.lanes[rid]
                    events.append({"rid": rid, "tokens": taken, "done": done})
                return events

            def cancel(self, rid):
                self.lanes.pop(rid, None)

        return Engine()

    return factory


#: The JSON-lines field each bytes field of a command becomes on a channel
#: without frames (base64).
B64_FIELD = {"args_bytes": "args", "kv_bytes": "kv"}


class Runtime:
    """One ``harness.py --serve`` subprocess (or another runtime ``mode``,
    such as ``--serve-child``) with every event it printed.

    Its stdout is read as the client reads it: JSON lines and binary frames
    interleaved, each frame decoded with the reference's codec; a
    ``telemetry_batch`` frame is unpacked into one ``telemetry`` event per
    record (``batches`` counts them, ``frame_kinds`` names every framed
    event).  ``frames=True`` negotiates frames first and then sends every
    command as a frame, a bytes field as the frame's body; without, a bytes
    field goes base64 in the JSON line.
    """

    def __init__(self, harness: Path, cwd: Path, frames: bool = False, mode: str = "--serve"):
        self.proc = subprocess.Popen(
            [sys.executable, str(harness), mode], cwd=cwd, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        )
        self.frames = frames
        self.events: list[dict] = []
        self.batches = 0
        self.frame_kinds: list[str] = []
        self._framed = False
        self._cond = threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        if frames:
            self.wait(is_event("ready"))
            self.send({"cmd": "frames", "version": 1, "codec": ""})
            self.wait(is_event("frames"))
            self._framed = True

    def _read(self):
        out = self.proc.stdout
        while True:
            first = out.read(1)
            if not first:
                return
            batch = False
            if first != ref_frames.MAGIC[:1]:
                events = [json.loads(first + out.readline())]
            else:
                fixed = first + out.read(ref_frames.HEADER_LEN - 1)
                _, _, _, flags, hlen, blen = ref_frames.HEADER.unpack(fixed)
                header, body = out.read(hlen), out.read(blen)
                event = ref_frames.decode_payload(flags, header, body)
                self.frame_kinds.append(event["event"])
                events = [event]
                if event["event"] == "telemetry_batch":
                    batch = True
                    records = json.loads(event["records"])
                    assert len(records) == event["count"]
                    events = [{"event": "telemetry", "id": event["id"], "data": r}
                              for r in records]
            with self._cond:
                self.batches += batch
                self.events.extend(events)
                self._cond.notify_all()

    def send(self, command) -> None:
        if isinstance(command, str):
            wire = (command + "\n").encode()
        elif self._framed:
            header = {k: v for k, v in command.items() if not isinstance(v, bytes)}
            body = [(k, v) for k, v in command.items() if isinstance(v, bytes)]
            if body:
                header["_body"] = body[0][0]
            verb = {"invoke": ref_frames.VERB_INVOKE,
                    "multi_invoke": ref_frames.VERB_MULTI_INVOKE}.get(
                command.get("cmd"), ref_frames.VERB_SERVE if str(command.get("cmd", ""))
                .startswith("serve_") else ref_frames.VERB_CMD)
            wire = ref_frames.encode_frame(verb, header, body[0][1] if body else b"")
        else:
            line = {B64_FIELD.get(k, k): base64.b64encode(v).decode("ascii")
                    if isinstance(v, bytes) else v for k, v in command.items()}
            wire = (json.dumps(line) + "\n").encode()
        self.proc.stdin.write(wire)
        self.proc.stdin.flush()

    def wait(self, predicate, count: int = 1) -> None:
        """Until ``count`` events satisfy ``predicate``."""
        with self._cond:
            if not self._cond.wait_for(
                    lambda: sum(map(predicate, self.events)) >= count, timeout=WAIT_S):
                raise AssertionError(f"timed out; events so far: {self.events}")

    def close(self) -> None:
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=WAIT_S)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()


def is_event(kind, sid=None):
    return lambda e: e.get("event") == kind and (sid is None or e.get("id") == sid)


def is_record(rid, type="serve.token", done=None, idx=None):
    def match(e):
        d = e.get("data") or {}
        return (e.get("event") == "telemetry" and d.get("rid") == rid and d.get("type") == type
                and (done is None or bool(d.get("done")) == done)
                and (idx is None or d.get("idx") == idx))
    return match


def run_script(rt: Runtime, digest: str, path: str, gates: Path) -> None:
    def request(rid, prompt, cap, **extra):
        params = {"max_new_tokens": cap}
        if "hold" in extra:
            params["hold"] = str(gates / extra.pop("hold"))
        rt.send({"cmd": "serve_request", "id": "s1", "rid": rid, "prompt": prompt,
                 "params": params, **extra})

    rt.wait(is_event("ready"))
    rt.send({"cmd": "ping"})
    rt.wait(is_event("pong"))
    rt.send({"cmd": "serve_request", "id": "ghost", "rid": "g1", "prompt": [1]})
    rt.wait(lambda e: e.get("id") == "ghost" and e.get("event") == "telemetry")
    open_cmd = {"cmd": "serve_open", "id": "s1", "digest": digest, "path": path,
                "options": {"queue_max": 2, "stats_interval_s": 3600}}
    rt.send({**open_cmd, "digest": "0" * 64})                      # digest mismatch
    rt.wait(is_event("serve_error", "s1"))
    rt.send(open_cmd)
    rt.wait(is_event("serve_opened", "s1"))
    rt.send(open_cmd)                                             # duplicate
    rt.wait(is_event("serve_error", "s1"), count=2)
    request("r1", [10], 5, hold="a")                              # runs, held
    rt.wait(is_record("r1", idx=0))
    request("r2", [20], 2)                                        # queued
    request("r3", [30], 2, deadline_s=0.3)                        # queued
    request("r4", [40], 2)                                        # shed: queue full
    rt.wait(is_record("r4", type="serve.reject"))
    # Cancel while queued.  A cancel also queues one wake-up item, which
    # counts against queue_max until the session thread takes it: at most
    # one is ever queued when a request arrives below, so none is shed.
    rt.send({"cmd": "serve_cancel", "id": "s1", "rid": "r2"})
    time.sleep(0.6)  # a lower bound: r3 cannot be admitted before the gate opens
    (gates / "a").touch()
    rt.wait(is_record("r1", done=True))
    rt.wait(is_record("r2", done=True))
    rt.wait(is_record("r3", type="serve.reject"))
    request("r5", [50], 4)
    rt.wait(is_record("r5", done=True))
    rt.send({"cmd": "serve_prefill", "id": "s1", "rid": "p1", "prompt": [5]})
    rt.wait(is_event("serve_kv", "s1"))                          # the stub cannot prefill
    rt.send({"cmd": "serve_prefill", "id": "ghost", "rid": "p2", "prompt": [5]})
    rt.wait(is_event("serve_kv", "ghost"))
    request("r9", [90], 2, kv_bytes=b"not the bundle it claims", kv_digest="0" * 64)
    rt.wait(is_record("r9", done=True))                           # degrades to a prefill
    request("r6", [60], 6, hold="b")                              # cancel while running
    rt.wait(is_record("r6", idx=0))
    rt.send({"cmd": "serve_cancel", "id": "s1", "rid": "r6"})
    rt.wait(is_record("r6", done=True))
    request("r7", [70], 6, hold="c", deadline_s=0.5)              # deadline while running
    rt.wait(is_record("r7", done=True))
    request("r8", [], 3)                                          # the engine refuses it
    rt.wait(is_record("r8", type="serve.reject"))
    rt.send({"cmd": "serve_cancel", "id": "s1", "rid": "nope"})  # no-op
    rt.send({"cmd": "bogus"})
    rt.wait(is_event("error"))
    rt.send("this is not json")
    rt.wait(is_event("error"), count=2)
    rt.send({"cmd": "serve_close", "id": "s1"})
    rt.wait(is_event("serve_closed", "s1"))
    rt.send({"cmd": "serve_close", "id": "s1"})                  # unknown session
    rt.wait(is_event("serve_error", "s1"), count=3)
    rt.send({"cmd": "frames", "version": 1, "codec": ""})
    rt.wait(is_event("frames"), count=2 if rt.frames else 1)
    rt.send({"cmd": "shutdown"})
    rt.wait(is_event("bye"))


#: What may differ: identity and clock fields.
VOLATILE = {"pid", "ts", "seq", "gen_s", "tokens_per_s"}


def normalized(events: list[dict]) -> tuple[list, dict]:
    """(the non-telemetry events in order, (id, rid) -> its records in order),
    with the fields that may differ removed."""
    def strip(d):
        return {k: v for k, v in d.items() if k not in VOLATILE}

    top, streams = [], {}
    for e in events:
        if e.get("event") == "telemetry":
            d = e["data"]
            streams.setdefault((e["id"], d.get("rid")), []).append(strip(d))
        else:
            top.append(strip(e))
    return top, streams


def run_both(root: Path, frames: bool) -> dict:
    """The script on both runtimes at once; name -> its :class:`Runtime`."""
    payload = cloudpickle.dumps(gated_factory())
    digest = hashlib.sha256(payload).hexdigest()
    path = root / f"{digest}.pkl"
    path.write_bytes(payload)
    runtimes, errors = {}, {}

    def drive(name):
        gates = root / f"gates_{name}"
        gates.mkdir()
        rt = None
        try:
            rt = runtimes[name] = Runtime(RUNTIMES[name], root, frames=frames)
            run_script(rt, digest, str(path), gates)
        except BaseException as err:  # noqa: BLE001 - reported below
            errors[name] = err
        finally:
            if rt is not None:
                rt.close()

    threads = [threading.Thread(target=drive, args=(n,)) for n in RUNTIMES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return runtimes


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    runtimes = run_both(tmp_path_factory.mktemp("protocol"), frames=False)
    return {name: rt.events for name, rt in runtimes.items()}


@pytest.fixture(scope="module")
def framed_runs(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("protocol_frames"), frames=True)


def test_port_runtime_answers_the_script_like_the_reference(both_runs):
    ref_top, ref_streams = normalized(both_runs["reference"])
    port_top, port_streams = normalized(both_runs["port"])
    assert port_top == ref_top
    assert port_streams == ref_streams


def test_port_runtime_answers_the_script_like_the_reference_on_frames(framed_runs):
    ref_top, ref_streams = normalized(framed_runs["reference"].events)
    port_top, port_streams = normalized(framed_runs["port"].events)
    assert port_top == ref_top
    assert port_streams == ref_streams


def test_the_frames_arm_rides_frames_and_streams_as_on_lines(framed_runs, both_runs):
    """On frames, tokens come back in ``telemetry_batch`` frames (some
    holding several records) from both runtimes, and every stream, record
    by record, equals the JSON-lines arm's."""
    for name, rt in framed_runs.items():
        assert rt.batches > 0 and "telemetry_batch" in rt.frame_kinds, name
        assert rt.batches < sum(e.get("event") == "telemetry" for e in rt.events), name
        top, streams = normalized(rt.events)
        line_top, line_streams = normalized(both_runs[name])
        assert streams == line_streams, name
        # the frames arm's own negotiation right after the banner; messages
        # name each arm's own directory
        assert top[1] == {"event": "frames", "version": 1, "codec": ""}, name
        unnamed = [[{k: v for k, v in e.items() if k != "message"} for e in events]
                   for events in ([top[0]] + top[2:], line_top)]
        assert unnamed[0] == unnamed[1], name


def test_the_script_covers_every_outcome(both_runs):
    """The shared script reaches every behaviour it is meant to compare."""
    top, streams = normalized(both_runs["port"])
    last = {rid: records[-1] for (_sid, rid), records in streams.items()}
    assert last["g1"]["code"] == "unknown_session"
    assert [r["tokens"] for r in streams[("s1", "r1")]] == [[11], [12, 13], [14, 15]]
    assert [r["idx"] for r in streams[("s1", "r1")]] == [0, 1, 3]
    assert last["r4"]["code"] == "serve_admission_shed"
    assert (last["r2"]["error"], last["r2"]["idx"]) == ("cancelled", 0)
    assert last["r3"]["code"] == "deadline"
    assert [t for r in streams[("s1", "r5")] for t in r["tokens"]] == [51, 52, 53, 54]
    assert (last["r6"]["error"], last["r6"]["idx"]) == ("cancelled", 1)
    assert (last["r7"]["error"], last["r7"]["idx"]) == ("deadline_exceeded", 1)
    assert last["r8"]["code"] == "engine_error"
    assert [t for r in streams[("s1", "r9")] for t in r["tokens"]] == [91, 92]
    kv = [(e["id"], e["rid"], e["code"]) for e in top if e["event"] == "serve_kv"]
    assert kv == [("s1", "p1", "unsupported"), ("ghost", "p2", "unknown_session")]
    stats = streams[("s1", None)]
    assert [s["type"] for s in stats] == ["serve.stats"]
    assert (stats[0]["served"], stats[0]["tokens_total"]) == (5, 13)
    assert (stats[0]["kv_admits"], stats[0]["kv_fallbacks"]) == (0, 1)
    errors = [e for e in both_runs["port"] if e.get("event") == "serve_error"]
    assert [e["code"] for e in errors] == ["digest_mismatch", "duplicate", "unknown_session"]
    assert all(e["permanent"] for e in errors)
    closed = [e for e in both_runs["port"] if e.get("event") == "serve_closed"]
    # r1, r5, r6, r7, r9: a request ended in the queue is not served
    assert closed[0]["served"] == 5


def test_frames_capability_is_the_only_banner_difference(both_runs):
    """Both runtimes advertise frames the same way, and ack them alike: the
    banners differ in nothing but the pid."""
    ref_banner, port_banner = (both_runs[n][0] for n in ("reference", "port"))
    assert {k: v for k, v in port_banner.items() if k != "pid"} == \
        {k: v for k, v in ref_banner.items() if k != "pid"}
    assert port_banner["frames"] == 1 and port_banner["codecs"] == ["zlib"]
    frames = [e for e in both_runs["port"] if e.get("event") == "frames"]
    assert frames == [{"event": "frames", "version": 1, "codec": ""}]


@pytest.mark.parametrize("verb,item", [
    ("serve_attach", "serve_attached"), ("serve_detach", "serve_detached"),
])
def test_port_runtime_refuses_verbs_of_later_items(tmp_path, verb, item):
    """The adapter verbs are ported: on a session that is not open, both
    runtimes answer with the same permanent ``unknown_session`` event."""
    answers = {}
    for name in ("reference", "port"):
        (tmp_path / name).mkdir()
        rt = Runtime(RUNTIMES[name], tmp_path / name)
        try:
            rt.wait(is_event("ready"))
            rt.send({"cmd": verb, "id": "x", "adapter": "tone"})
            rt.send({"cmd": "ping"})
            rt.wait(is_event("pong"))
            answers[name] = [{k: v for k, v in e.items() if k != "message"}
                             for e in rt.events if e.get("event") in (item, "error")]
            rt.send({"cmd": "shutdown"})
            rt.wait(is_event("bye"))
        finally:
            rt.close()
        assert rt.proc.returncode == 0
    assert answers["port"] == answers["reference"] == [
        {"event": item, "id": "x", "adapter": "tone", "code": "unknown_session",
         "permanent": True}]


@pytest.mark.parametrize("verb,code", [
    ("profile_start", "bad_request"), ("profile_stop", "not_running"),
])
def test_a_profile_verb_without_a_trace_answers_like_the_reference(tmp_path, verb, code):
    """A start that names no trace directory, and a stop with no trace
    running, are refused by both runtimes with the same code and nothing
    else (``tests/test_torch_profile.py`` runs the whole profile script on
    both)."""
    answers = {}
    for name, harness in RUNTIMES.items():
        (tmp_path / name).mkdir()
        rt = Runtime(harness, tmp_path / name)
        try:
            rt.wait(is_event("ready"))
            rt.send({"cmd": verb, "id": "x"})
            rt.send({"cmd": "ping"})
            rt.wait(is_event("pong"))
            answers[name] = [(e["event"], e.get("code")) for e in rt.events
                             if e.get("id") == "x" or e.get("event") == "error"]
            rt.send({"cmd": "shutdown"})
            rt.wait(is_event("bye"))
        finally:
            rt.close()
        assert rt.proc.returncode == 0, name
    assert answers["port"] == answers["reference"] == [("profile_error", code)]
