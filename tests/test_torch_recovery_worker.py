"""The port's worker side of crash recovery, against the reference's.

The cases of ``tests/test_recovery_worker.py`` on the port's pool server
(``covalent_tpu_plugin_torch/harness.py --serve``, copied into a temporary
directory as the dispatcher stages it): the epoch fence, the inventories,
the ``serve_resume`` states, orphan mode with adoption exactly once, TTL
expiry, and no orphan mode without a TTL.  Then what the reference's tests
leave to its dispatcher tests: the ``--attach`` relay, the SIGTERM
preemption notice, and one recovery command script fed to both packages'
runtimes, whose protocol events must be equal (only pids, clocks and seq
values may differ).  The stub engines are the reference tests' own,
pickled by value; the port's server preloads only ``cloudpickle``.
"""

import asyncio
import hashlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import cloudpickle

from covalent_tpu_plugin_torch import harness as port_harness

from .test_recovery_worker import SockChannel, Worker, _make_factory, _wait_rendezvous
from .test_torch_session_protocol import (
    RUNTIMES,
    Runtime,
    gated_factory,
    is_event,
    is_record,
    normalized,
)


class PortWorker(Worker):
    """The reference tests' raw-pipe worker, on the port's harness."""

    def __init__(self, tmp_path, env=None):
        self.dir = tmp_path / "pool"
        self.dir.mkdir(exist_ok=True)
        self.harness = self.dir / "harness.py"
        shutil.copyfile(port_harness.__file__, self.harness)
        full_env = dict(os.environ, COVALENT_TPU_AGENT_FRAMES="0",
                        COVALENT_TPU_POOL_PRELOAD="cloudpickle")
        full_env.update(env or {})
        self.proc = subprocess.Popen(
            [sys.executable, str(self.harness), "--serve"], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=full_env,
        )
        self.events: list = []
        self._cond = threading.Condition()
        self._reader = threading.Thread(target=self._read, args=(self.proc.stdout,),
                                        daemon=True)
        self._reader.start()

    def crash_dispatcher(self) -> None:
        """Drop both pipes with no goodbye.  stdin goes first: closing the
        read pipe while the reader thread sits in a read would wait for
        the worker's next write (a stats record, 30 s away); the worker's
        EOF silences or ends its output, which frees the reader."""
        for stream in (self.proc.stdin, self.proc.stdout):
            try:
                stream.close()
            except OSError:
                pass


class Channel(SockChannel):
    """The reference tests' adoption socket, closed with a shutdown first:
    that wakes the reader thread at once, instead of waiting on the
    worker's next write."""

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        super().close()


def _open_session(worker, sid, **factory_kw):
    digest, path = worker.stage(_make_factory(**factory_kw))
    worker.send(cmd="serve_open", id=sid, digest=digest, path=path,
                options={"stats_interval_s": 30.0})
    worker.wait_for(lambda e: e.get("event") == "serve_opened" and e.get("id") == sid)
    return sid


def _token(rid=None, done=None):
    def match(e):
        d = e.get("data") or {}
        return (e.get("event") == "telemetry" and d.get("type") == "serve.token"
                and (rid is None or d.get("rid") == rid)
                and (done is None or bool(d.get("done")) == done))
    return match


# -- the epoch fence ----------------------------------------------------------


def test_epoch_fencing_refuses_stale_dispatcher(tmp_path):
    worker = PortWorker(tmp_path)
    try:
        worker.wait_for(lambda e: e.get("event") == "ready")
        worker.send(cmd="epoch", epoch=2)
        worker.wait_for(lambda e: e.get("event") == "epoch_ok" and e.get("epoch") == 2)
        worker.send(cmd="epoch", epoch=1)
        worker.wait_for(lambda e: e.get("event") == "error" and e.get("code") == "stale_epoch")
        # every mutating verb of the stale channel is refused in its
        # caller's shape
        worker.send(cmd="serve_open", id="s-x", digest="d", path="p")
        worker.wait_for(lambda e: e.get("event") == "serve_error" and e.get("id") == "s-x"
                        and e.get("code") == "stale_epoch" and e.get("permanent"))
        worker.send(cmd="serve_request", id="s-x", rid="r-x", prompt=[1])
        worker.wait_for(lambda e: e.get("event") == "telemetry"
                        and (e.get("data") or {}).get("type") == "serve.reject"
                        and e["data"].get("code") == "stale_epoch")
        worker.send(cmd="serve_resume", id="s-x", rid="r-x")
        worker.wait_for(lambda e: e.get("event") == "serve_resumed"
                        and e.get("state") == "refused")
        worker.send(cmd="run", id="t-x", spec="/nonexistent")
        worker.wait_for(lambda e: e.get("event") == "error" and e.get("id") == "t-x"
                        and e.get("code") == "stale_epoch")
        # reads stay open: a stale dispatcher may look, not touch
        worker.send(cmd="ping")
        worker.wait_for(lambda e: e.get("event") == "pong")
        worker.send(cmd="serve_inventory")
        worker.wait_for(lambda e: e.get("event") == "serve_inventory" and e.get("epoch") == 2)
        worker.send(cmd="task_inventory")
        worker.wait_for(lambda e: e.get("event") == "task_inventory" and e.get("epoch") == 2)
        # the rightful successor declares a higher epoch and the fence lifts
        worker.send(cmd="epoch", epoch=3)
        worker.wait_for(lambda e: e.get("event") == "epoch_ok" and e.get("epoch") == 3)
        _open_session(worker, "s-ok")
    finally:
        worker.close()


# -- inventories and resume ---------------------------------------------------


def test_inventory_reports_sessions_and_streams(tmp_path):
    worker = PortWorker(tmp_path)
    try:
        sid = _open_session(worker, "s-inv", default_cap=4)
        worker.send(cmd="serve_request", id=sid, rid="r-1", prompt=[100])
        worker.wait_for(_token("r-1", done=True))
        worker.send(cmd="serve_inventory")
        inv = worker.wait_for(lambda e: e.get("event") == "serve_inventory")
        assert [s["sid"] for s in inv["sessions"]] == [sid]
        entry = inv["sessions"][0]
        assert entry["finished"]["r-1"] == {"tokens": 4, "error": ""}
        assert entry["served"] == 1 and entry["running"] == {}
        worker.send(cmd="task_inventory")
        assert worker.wait_for(lambda e: e.get("event") == "task_inventory")["tasks"] == []
    finally:
        worker.close()


def test_serve_resume_states(tmp_path):
    """Every resume state, at points a gated one-slot engine holds still: a
    stream held after its first token (``streaming``), one queued behind it
    (``pending``), a rid and a session never seen (``unknown``), and, once
    the gate opens and both finish, the finished ring (``done``)."""
    worker = PortWorker(tmp_path)
    gate = tmp_path / "gate"
    try:
        digest, path = worker.stage(gated_factory())
        worker.send(cmd="serve_open", id="s-res", digest=digest, path=path,
                    options={"stats_interval_s": 30.0})
        worker.wait_for(lambda e: e.get("event") == "serve_opened")
        worker.send(cmd="serve_request", id="s-res", rid="r-live", prompt=[0],
                    params={"max_new_tokens": 20, "hold": str(gate)})
        worker.wait_for(_token("r-live"))
        # queued behind the held lane (sent once it runs: an idle session
        # may take two requests that arrive together in either order)
        worker.send(cmd="serve_request", id="s-res", rid="r-queued", prompt=[50],
                    params={"max_new_tokens": 20})
        # held mid-decode: the whole history again from the asked offset
        worker.send(cmd="serve_resume", id="s-res", rid="r-live", **{"from": 0})
        ack = worker.wait_for(lambda e: e.get("event") == "serve_resumed"
                              and e.get("rid") == "r-live")
        assert (ack["state"], ack["from"], ack["sent"]) == ("streaming", 0, 1)
        worker.send(cmd="serve_resume", id="s-res", rid="r-queued", **{"from": 0})
        assert worker.wait_for(lambda e: e.get("event") == "serve_resumed"
                               and e.get("rid") == "r-queued")["state"] == "pending"
        worker.send(cmd="serve_resume", id="s-res", rid="r-ghost", **{"from": 0})
        assert worker.wait_for(lambda e: e.get("event") == "serve_resumed"
                               and e.get("rid") == "r-ghost")["state"] == "unknown"
        worker.send(cmd="serve_resume", id="s-ghost", rid="r-1", **{"from": 0})
        assert worker.wait_for(lambda e: e.get("event") == "serve_resumed"
                               and e.get("id") == "s-ghost")["state"] == "unknown"
        gate.touch()
        worker.wait_for(_token("r-queued", done=True), timeout=40.0)
        assert worker.tokens("r-live") == list(range(1, 21))
        # a finished stream resumes from the finished ring: the tail and done
        worker.send(cmd="serve_resume", id="s-res", rid="r-live", **{"from": 18})
        done_ack = worker.wait_for(lambda e: e.get("event") == "serve_resumed"
                                   and e.get("rid") == "r-live" and e.get("state") == "done")
        assert done_ack["from"] == 18 and done_ack["sent"] == 2
    finally:
        worker.close()


# -- orphan mode and adoption -------------------------------------------------


def test_orphan_adoption_resumes_streams_exactly_once(tmp_path):
    worker = PortWorker(tmp_path, env={"COVALENT_TPU_ORPHAN_TTL_S": "60"})
    try:
        worker.wait_for(lambda e: e.get("event") == "ready")
        worker.send(cmd="epoch", epoch=5)
        worker.wait_for(lambda e: e.get("event") == "epoch_ok")
        sid = _open_session(worker, "s-adopt", step_delay=0.1, chunk=2, default_cap=40)
        worker.send(cmd="serve_request", id=sid, rid="r-a", prompt=[1000])
        worker.wait_for(_token("r-a"))
        hwm = len(worker.tokens("r-a"))
        assert hwm >= 2
        # the dispatcher dies mid-stream: what the worker emits now is lost
        worker.crash_dispatcher()
        meta = _wait_rendezvous(worker)
        assert meta["pid"] == worker.proc.pid and meta["epoch"] == 5
        assert meta["sessions"] == [sid]
        # a stale successor is refused, and the worker waits on
        stale = Channel(meta["sock"])
        stale.send(cmd="adopt", epoch=4)
        stale.wait_for(lambda e: e.get("event") == "error" and e.get("code") == "stale_epoch")
        stale.close()
        chan = Channel(meta["sock"])
        chan.send(cmd="adopt", epoch=6)
        banner = chan.wait_for(lambda e: e.get("event") == "ready")
        assert banner.get("reattach") is True and banner.get("epoch") == 6
        assert banner.get("sessions") == [sid]
        # adopted exactly once: the rendezvous and the socket are gone
        deadline = time.monotonic() + 10
        while (worker.dir / "pool_orphan.json").exists() or \
                list(worker.dir.glob("pool_orphan.*.sock")):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        chan.send(cmd="serve_resume", id=sid, rid="r-a", **{"from": hwm})
        ack = chan.wait_for(lambda e: e.get("event") == "serve_resumed"
                            and e.get("rid") == "r-a")
        assert ack["state"] in ("streaming", "done")
        chan.wait_for(_token("r-a", done=True), timeout=40.0)
        resumed = chan.tokens("r-a", base=hwm)
        assert list(range(1001, 1001 + hwm)) + resumed == list(range(1001, 1041))
        chan.send(cmd="serve_request", id=sid, rid="r-b", prompt=[2000],
                  params={"max_new_tokens": 4})
        chan.wait_for(_token("r-b", done=True), timeout=40.0)
        assert chan.tokens("r-b") == [2001, 2002, 2003, 2004]
        chan.send(cmd="serve_close", id=sid)
        chan.wait_for(lambda e: e.get("event") == "serve_closed" and e.get("id") == sid)
        chan.close()
        worker.proc.wait(timeout=15)
    finally:
        worker.close()


def test_attach_relay_adopts_the_orphan_over_stdio(tmp_path):
    """The dispatcher's road: ``harness.py --attach <sock>`` pumps its
    stdio to the orphan's socket; the adopt line, the banner and the
    protocol pass through it, and a relay onto a dead socket answers
    ``attach_failed``."""
    worker = PortWorker(tmp_path, env={"COVALENT_TPU_ORPHAN_TTL_S": "60"})
    try:
        sid = _open_session(worker, "s-relay", step_delay=0.05, default_cap=30)
        worker.send(cmd="serve_request", id=sid, rid="r-a", prompt=[0])
        worker.wait_for(_token("r-a"))
        hwm = len(worker.tokens("r-a"))
        worker.crash_dispatcher()
        meta = _wait_rendezvous(worker)
        relay = subprocess.Popen([sys.executable, str(worker.harness), "--attach",
                                  meta["sock"]], stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        relay.stdin.write(b'{"cmd": "adopt", "epoch": 1}\n')
        relay.stdin.flush()
        banner = json.loads(relay.stdout.readline())
        assert banner["event"] == "ready" and banner["reattach"] is True
        relay.stdin.write(json.dumps({"cmd": "serve_resume", "id": sid, "rid": "r-a",
                                      "from": hwm}).encode() + b"\n")
        relay.stdin.flush()
        tokens, _ = _resumed_stream(relay.stdout, "r-a", hwm)
        assert list(range(1, hwm + 1)) + tokens == list(range(1, 31))
        relay.stdin.close()
        relay.wait(timeout=15)
        # the relay's end is the channel's: the server waits in orphan mode again
        meta = _wait_rendezvous(worker)
        worker.proc.kill()
        dead = subprocess.run([sys.executable, str(worker.harness), "--attach",
                               str(tmp_path / "nope.sock")], capture_output=True, text=True,
                              timeout=60)
        assert dead.returncode == 3
        assert json.loads(dead.stdout)["code"] == "attach_failed"
    finally:
        worker.close()


def _resumed_stream(stdout, rid, hwm):
    """The tokens after ``hwm`` of a stream resumed over an adopted channel,
    read as ``SessionSupervisor.resume_stream`` and its splice read them:
    every token once, in idx order.

    The adopted session keeps decoding, so live chunks of the stream can
    reach the new channel before the server takes ``serve_resume`` (the
    reference's server interleaves the same way: adoption puts the session
    back on the channel at once, the resume comes later).  Such a chunk
    starts past the high-water mark; the supervisor drops it until the
    replay (``resumed``: the history from ``hwm``, under the history lock)
    arrives and re-emits it (``test_supervisor_drops_live_chunks_until_the_
    replay``).  From the replay on, each chunk continues where the last one
    ended."""
    tokens, done, replayed, early = [], False, False, 0
    while not done:
        event = json.loads(stdout.readline())
        data = event.get("data") or {}
        if data.get("type") != "serve.token" or data.get("rid") != rid:
            continue
        have = hwm + len(tokens)
        if data.get("resumed"):
            assert data["idx"] == hwm
            replayed = True
        elif not replayed and data["idx"] > have:
            early += 1
            continue
        assert data["idx"] <= have
        tokens.extend(data["tokens"][have - data["idx"]:])
        done = bool(data.get("done"))
    return tokens, early


def test_resume_after_live_chunks_on_the_adopted_channel(tmp_path):
    """Force the interleaving: the adopted channel carries live chunks of
    the stream before the resume is sent.  The replay covers them, and
    every token still arrives exactly once and in order."""
    worker = PortWorker(tmp_path, env={"COVALENT_TPU_ORPHAN_TTL_S": "60"})
    try:
        sid = _open_session(worker, "s-live", step_delay=0.05, default_cap=200)
        worker.send(cmd="serve_request", id=sid, rid="r-l", prompt=[0])
        worker.wait_for(_token("r-l"))
        hwm = len(worker.tokens("r-l"))
        worker.crash_dispatcher()
        meta = _wait_rendezvous(worker)
        relay = subprocess.Popen([sys.executable, str(worker.harness), "--attach",
                                  meta["sock"]], stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        relay.stdin.write(b'{"cmd": "adopt", "epoch": 1}\n')
        relay.stdin.flush()
        assert json.loads(relay.stdout.readline())["reattach"] is True
        live = 0
        while live < 3:  # several live steps before the resume
            data = json.loads(relay.stdout.readline()).get("data") or {}
            if data.get("type") == "serve.token" and data.get("rid") == "r-l":
                assert data["idx"] > hwm and not data.get("resumed")
                live += 1
        relay.stdin.write(json.dumps({"cmd": "serve_resume", "id": sid, "rid": "r-l",
                                      "from": hwm}).encode() + b"\n")
        relay.stdin.flush()
        tokens, _ = _resumed_stream(relay.stdout, "r-l", hwm)
        assert list(range(1, hwm + 1)) + tokens == list(range(1, 201))
        relay.stdin.close()
        relay.wait(timeout=15)
    finally:
        worker.close()


class _AdoptedClient:
    """An adopted channel whose worker emits live chunks of the stream
    before it takes ``serve_resume``, then the replay, then the ack."""

    def __init__(self, before_replay):
        self.before_replay = before_replay
        self.sink = None

    def watch_serve(self, sid_g, sink):
        self.sink = lambda data: sink(sid_g, data)

    async def wait_dead(self):
        await asyncio.Event().wait()

    async def serve_resume(self, sid_g, rid, start):
        for chunk in self.before_replay:
            self.sink(chunk)
        history = list(range(start + 1, 9))
        self.sink({"type": "serve.token", "rid": rid, "idx": start, "tokens": history,
                   "done": False, "resumed": True})
        self.sink({"type": "serve.token", "rid": rid, "idx": 8, "tokens": [9, 10],
                   "done": True})
        return {"state": "streaming", "sent": len(history)}


def test_supervisor_drops_live_chunks_until_the_replay(run_async):
    """Through ``SessionSupervisor.resume_stream`` itself: live chunks past
    the high-water mark (2) arrive before the replay, which re-emits them;
    the stream is every token once, in order, and not a gap."""
    from covalent_tpu_plugin_torch.serving.supervisor import ServeRequest, SessionSupervisor

    async def flow():
        client = _AdoptedClient([
            {"type": "serve.token", "rid": "r-x", "idx": 6, "tokens": [7], "done": False},
            {"type": "serve.token", "rid": "r-x", "idx": 7, "tokens": [8], "done": False}])
        executor = types.SimpleNamespace(_serve_handles={})
        sup = SessionSupervisor(executor, sid="serve-x")
        await sup.adopt(client=client, conns=[], address="localhost", sid_g="serve-x.g1")
        try:
            request = ServeRequest("r-x", [0], None, 0.0)
            request.resumed_from = 2
            assert await sup.resume_stream(request) == "streaming"
            return await request.result(timeout=5), request.awaiting_replay
        finally:
            sup._supervisor.cancel()

    tokens, awaiting = run_async(flow())
    assert list(range(1, 3)) + tokens == list(range(1, 11))
    assert awaiting is False


def test_orphan_ttl_expiry_drains_and_exits(tmp_path):
    worker = PortWorker(tmp_path, env={"COVALENT_TPU_ORPHAN_TTL_S": "1"})
    try:
        sid = _open_session(worker, "s-ttl", default_cap=2)
        worker.send(cmd="serve_request", id=sid, rid="r-1", prompt=[1])
        worker.wait_for(_token(done=True))
        worker.crash_dispatcher()
        _wait_rendezvous(worker)
        worker.proc.wait(timeout=20)  # nobody adopts: drain and exit
        assert not (worker.dir / "pool_orphan.json").exists()
        assert not list(worker.dir.glob("pool_orphan.*.sock"))
    finally:
        worker.close()


def test_no_ttl_means_no_orphan_mode(tmp_path):
    worker = PortWorker(tmp_path)
    try:
        _open_session(worker, "s-plain", default_cap=2)
        worker.crash_dispatcher()
        worker.proc.wait(timeout=15)
        assert not (worker.dir / "pool_orphan.json").exists()
    finally:
        worker.close()


def test_sigterm_is_a_preemption_notice_while_sessions_live(tmp_path):
    """SIGTERM with a live session: ``serve.preempt`` on the side-band and
    the server keeps serving; with no session, SIGTERM ends it."""
    worker = PortWorker(tmp_path)
    try:
        sid = _open_session(worker, "s-pre", step_delay=0.05, default_cap=20)
        worker.send(cmd="serve_request", id=sid, rid="r-1", prompt=[0])
        worker.wait_for(_token("r-1"))
        worker.proc.send_signal(signal.SIGTERM)
        notice = worker.wait_for(lambda e: (e.get("data") or {}).get("type") == "serve.preempt")
        assert notice["id"] == sid and notice["data"]["reason"] == "sigterm"
        worker.wait_for(_token("r-1", done=True), timeout=40.0)
        assert worker.tokens("r-1") == list(range(1, 21))
        assert worker.proc.poll() is None
        worker.send(cmd="serve_close", id=sid)
        worker.wait_for(lambda e: e.get("event") == "serve_closed")
        worker.proc.send_signal(signal.SIGTERM)
        assert worker.proc.wait(timeout=15) == -signal.SIGTERM
    finally:
        worker.close()


# -- one recovery script on both runtimes --------------------------------------


def recovery_script(rt: Runtime, digest: str, path: str, gates) -> None:
    """The fence, the inventories and every resume state, at points the
    gated stub engine makes deterministic."""
    rt.wait(is_event("ready"))
    rt.send({"cmd": "epoch", "epoch": 2})
    rt.wait(is_event("epoch_ok"))
    rt.send({"cmd": "epoch", "epoch": 1})
    rt.wait(is_event("error"))
    rt.send({"cmd": "serve_open", "id": "s1", "digest": digest, "path": path})
    rt.wait(is_event("serve_error", "s1"))
    rt.send({"cmd": "serve_request", "id": "s1", "rid": "x", "prompt": [1]})
    rt.wait(is_record("x", type="serve.reject"))
    rt.send({"cmd": "serve_resume", "id": "s1", "rid": "x", "from": 0})
    rt.wait(is_event("serve_resumed", "s1"))
    rt.send({"cmd": "serve_cancel", "id": "s1", "rid": "x"})
    rt.wait(is_event("error"), count=2)
    rt.send({"cmd": "serve_inventory"})
    rt.wait(is_event("serve_inventory"))
    rt.send({"cmd": "task_inventory"})
    rt.wait(is_event("task_inventory"))
    rt.send({"cmd": "epoch", "epoch": 3})
    rt.wait(is_event("epoch_ok"), count=2)
    rt.send({"cmd": "serve_open", "id": "s1", "digest": digest, "path": path,
             "options": {"stats_interval_s": 3600}})
    rt.wait(is_event("serve_opened", "s1"))
    rt.send({"cmd": "serve_request", "id": "s1", "rid": "r1", "prompt": [10],
             "params": {"max_new_tokens": 5, "hold": str(gates / "a")}})
    rt.wait(is_record("r1", idx=0))
    rt.send({"cmd": "serve_request", "id": "s1", "rid": "r2", "prompt": [20],
             "params": {"max_new_tokens": 2}})
    rt.send({"cmd": "serve_inventory"})
    rt.wait(is_event("serve_inventory"), count=2)
    for rid, start in (("r1", 0), ("r2", 0), ("ghost", 0)):
        rt.send({"cmd": "serve_resume", "id": "s1", "rid": rid, "from": start})
        rt.wait(lambda e, rid=rid: e.get("event") == "serve_resumed" and e.get("rid") == rid)
    rt.send({"cmd": "serve_resume", "id": "nobody", "rid": "r1", "from": 0})
    rt.wait(is_event("serve_resumed", "nobody"))
    (gates / "a").touch()
    rt.wait(is_record("r2", done=True))
    rt.send({"cmd": "serve_resume", "id": "s1", "rid": "r1", "from": 3})
    rt.wait(lambda e: e.get("event") == "serve_resumed" and e.get("state") == "done")
    rt.send({"cmd": "adopt", "epoch": 9})
    rt.wait(is_event("error"), count=3)
    rt.send({"cmd": "serve_close", "id": "s1"})
    rt.wait(is_event("serve_closed", "s1"))
    rt.send({"cmd": "shutdown"})
    rt.wait(is_event("bye"))


def test_port_runtime_answers_the_recovery_script_like_the_reference(tmp_path):
    payload = cloudpickle.dumps(gated_factory())
    digest = hashlib.sha256(payload).hexdigest()
    path = tmp_path / f"{digest}.pkl"
    path.write_bytes(payload)
    runs, errors = {}, {}

    def drive(name):
        gates = tmp_path / f"gates_{name}"
        gates.mkdir()
        rt = None
        try:
            rt = Runtime(RUNTIMES[name], tmp_path)
            recovery_script(rt, digest, str(path), gates)
        except BaseException as err:  # noqa: BLE001 - reported below
            errors[name] = err
        finally:
            if rt is not None:
                rt.close()
                runs[name] = rt.events

    threads = [threading.Thread(target=drive, args=(n,)) for n in RUNTIMES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    port_top, port_streams = normalized(runs["port"])
    ref_top, ref_streams = normalized(runs["reference"])
    assert port_top == ref_top
    assert port_streams == ref_streams
    resumed = [e for e in port_top if e["event"] == "serve_resumed"]
    assert [(e["rid"], e["state"]) for e in resumed] == [
        ("x", "refused"), ("r1", "streaming"), ("r2", "pending"), ("ghost", "unknown"),
        ("r1", "unknown"), ("r1", "done")]
    assert [e.get("code") for e in port_top if e["event"] == "error"] == \
        ["stale_epoch", "stale_epoch", None]
