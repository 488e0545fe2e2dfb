"""Binary frames: the port's codec, its harness's mirror and the reference's.

Three encoders write a frame: ``covalent_tpu_plugin_torch/transport/frames.py``
(the dispatcher side), the port harness's stdlib-only mirror
(``_emit_frame``, which runs standalone on workers) and the reference's
``covalent_tpu_plugin/transport/frames.py``.  They must write the same
bytes, and every reader must decode every encoder's frames: both
dispatcher-side readers (``TransportProcess.read_event`` then
``decode_payload``) and both harnesses' command parsers
(``_extract_commands``).  The cases cover raw and zlib bodies (compressed,
incompressible, below the size that pays), a header-only frame, a
non-ASCII header, and the ``_body`` re-attachment.  Torn, oversized,
bad-magic and bad-version frames, a header that is not JSON and a frame cut
short must meet the same errors on both sides of both packages.  On a real
pool server, a session's token chunks of one engine step leave as one
frame, invokes queued together as one ``multi_invoke``, and a channel that
either side keeps on JSON lines gives the same results.
"""

import asyncio
import io
import json
import sys

import numpy as np
import pytest

from covalent_tpu_plugin import harness as ref_harness
from covalent_tpu_plugin.transport import frames as ref_frames
from covalent_tpu_plugin.transport.base import TransportError as RefTransportError
from covalent_tpu_plugin.transport.process import TransportProcess as RefProcess
from covalent_tpu_plugin_torch import harness as port_harness
from covalent_tpu_plugin_torch.transport import frames as port_frames
from covalent_tpu_plugin_torch.transport.base import TransportError as PortTransportError
from covalent_tpu_plugin_torch.transport.process import TransportProcess as PortProcess


class _Stdout:
    """The reference harness's stdout: text lines and frames in one byte stream."""

    def __init__(self):
        self.buffer = io.BytesIO()

    def write(self, text):
        self.buffer.write(text.encode())

    def flush(self):
        pass


class _FakeSys:
    """``sys`` for the reference harness: a private stdout, the real module
    for the rest (pytest swaps the real ``sys.stdout`` around each test)."""

    def __init__(self, stdout):
        self.stdout = stdout

    def __getattr__(self, name):
        return getattr(sys, name)


@pytest.fixture
def emitted(monkeypatch):
    """What each harness writes on its protocol channel."""
    ref_out = _Stdout()
    monkeypatch.setattr(ref_harness, "sys", _FakeSys(ref_out))
    port_out = io.BytesIO()
    monkeypatch.setattr(port_harness, "_PROTO", port_out)
    return {"reference": ref_out.buffer, "port": port_out}


_NOISE = np.random.default_rng(0).integers(0, 256, 4096, dtype=np.uint8).tobytes()

#: name -> (verb, header, body, codec)
CASES = {
    "invoke_raw": (1, {"cmd": "invoke", "id": "op1", "digest": "d" * 64,
                       "_body": "args_bytes"}, b"\x00\x01raw pickle bytes\xff" * 10, ""),
    "result_zlib": (2, {"event": "result", "id": "op1", "ok": True, "_body": "data_bytes"},
                    b"result pickle " * 2048, "zlib"),
    "kv_incompressible": (5, {"event": "serve_kv", "id": "s1", "rid": "r1",
                              "_body": "data_bytes"}, _NOISE, "zlib"),
    "batch_below_compress": (3, {"event": "telemetry_batch", "id": "s1", "count": 1,
                                 "_body": "records"}, b'[{"type":"serve.token"}]', "zlib"),
    "header_only": (5, {"cmd": "serve_request", "id": "s1", "rid": "r1", "prompt": [1, 2]},
                    b"", ""),
    "unicode_header": (0, {"cmd": "note", "text": "héllo ✓"}, b"", ""),
}


def _encode(encoder: str, case: str, emitted, monkeypatch) -> bytes:
    verb, header, body, codec = CASES[case]
    if encoder == "reference":
        return ref_frames.encode_frame(verb, dict(header), body, codec=codec)
    if encoder == "port":
        return port_frames.encode_frame(verb, dict(header), body, codec=codec)
    monkeypatch.setitem(port_harness._FRAMES, "out", True)
    monkeypatch.setitem(port_harness._FRAMES, "codec", codec)
    port_harness._emit_frame(verb, dict(header), body)
    return emitted["port"].getvalue()


def _expected(case: str) -> dict:
    _verb, header, body, _codec = CASES[case]
    event = {k: v for k, v in header.items() if k != "_body"}
    if "_body" in header:
        event[header["_body"]] = body
    return event


def _read_events(process_cls, wire: bytes) -> list:
    """Every message ``process_cls.read_event`` reads off ``wire``, then the
    error that ended the stream (EOF included)."""

    async def run():
        reader = asyncio.StreamReader()
        reader.feed_data(wire)
        reader.feed_eof()
        process = process_cls(reader, None, describe="chan")
        messages = []
        while True:
            try:
                messages.append(await process.read_event(timeout=5))
            except (RefTransportError, PortTransportError) as err:
                return messages, str(err)

    return asyncio.run(run())


def _decode(reader: str, wire: bytes) -> list:
    if reader in ("reference", "port"):
        process_cls, codec = ((RefProcess, ref_frames) if reader == "reference"
                              else (PortProcess, port_frames))
        messages, ended = _read_events(process_cls, wire)
        assert ended == "chan: channel EOF mid-message (0/1 bytes)"
        return [codec.decode_payload(*m[2:]) for m in messages]
    harness = ref_harness if reader == "reference_harness" else port_harness
    buffer = bytearray(wire)
    commands = harness._extract_commands(buffer)
    assert not buffer
    return commands


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_three_encoders_write_the_same_bytes(case, emitted, monkeypatch):
    wire = _encode("reference", case, emitted, monkeypatch)
    assert _encode("port", case, emitted, monkeypatch) == wire
    assert _encode("port_harness", case, emitted, monkeypatch) == wire
    verb, header, body, codec = CASES[case]
    monkeypatch.setitem(ref_harness._FRAMES, "out", True)
    monkeypatch.setitem(ref_harness._FRAMES, "codec", codec)
    ref_harness._emit_frame(verb, dict(header), body)
    assert emitted["reference"].getvalue() == wire
    zlib_flag = bool(wire[4] & port_frames.FLAG_BODY_ZLIB)
    assert zlib_flag == (case == "result_zlib")  # only a body that shrinks is compressed


@pytest.mark.parametrize("reader", ["reference", "port", "reference_harness", "port_harness"])
@pytest.mark.parametrize("encoder", ["reference", "port", "port_harness"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_reader_decodes_every_encoder(case, encoder, reader, emitted, monkeypatch):
    wire = _encode(encoder, case, emitted, monkeypatch)
    assert _decode(reader, wire) == [_expected(case)]


def test_frames_and_lines_interleave_on_both_sides(emitted, monkeypatch):
    """A channel after negotiation mixes JSON lines and frames."""
    wire = (b'{"cmd": "ping"}\n' + port_frames.encode_frame(5, {"cmd": "serve_request",
                                                                "id": "s1"})
            + port_frames.encode_frame(2, {"event": "result", "_body": "data_bytes"}, b"\xc5")
            + b'{"cmd": "shutdown"}\n')
    for harness in (ref_harness, port_harness):
        assert [c.get("cmd") for c in harness._extract_commands(bytearray(wire))] == [
            "ping", "serve_request", None, "shutdown"]
    kinds = {}
    for name, cls in (("reference", RefProcess), ("port", PortProcess)):
        messages, _ = _read_events(cls, wire)
        kinds[name] = [m[0] for m in messages]
        assert messages[0] == ("line", '{"cmd": "ping"}')
    assert kinds["port"] == kinds["reference"] == ["line", "frame", "frame", "line"]


# ---------------------------------------------------------------------------
# Malformed input: the same errors on both sides of both packages
# ---------------------------------------------------------------------------

_PING = b'{"cmd":"ping"}\n'


def _bad_version() -> bytes:
    frame = bytearray(ref_frames.encode_frame(0, {"cmd": "ping"}))
    frame[2] = 99
    return bytes(frame)


def _torn(cmd: str) -> bytes:
    head = {"cmd": cmd, "id": "tornop", "_body": "args_bytes"}
    if cmd == "multi_invoke":
        head = {"cmd": cmd, "digest": "d" * 64, "ops": [{"id": "m1"}, {"id": "m2"}],
                "args_lens": [3, 3], "_body": "args_bytes"}
    head_bytes = json.dumps(head).encode()
    body = b"definitely not deflate data"
    return ref_frames.HEADER.pack(ref_frames.MAGIC, ref_frames.VERSION, 1,
                                  ref_frames.FLAG_BODY_ZLIB, len(head_bytes),
                                  len(body)) + head_bytes + body


#: name -> (wire, what both harness parsers must answer, how both
#: dispatcher readers must end)
MALFORMED = {
    "bad_magic": (bytes([0xC5, 0x00]) + b"garbage-without-meaning\n" + _PING,
                  "bad frame magic", "chan: bad frame magic/version (b'\\xc5\\x00' v103)"),
    "bad_version": (_bad_version() + b"\n" + _PING, "bad frame magic",
                    "chan: bad frame magic/version (b'\\xc5\\xf7' v99)"),
    "oversized": (ref_frames.HEADER.pack(ref_frames.MAGIC, 1, 0, 0, 5,
                                         ref_frames.MAX_BODY_BYTES + 1) + b"\n" + _PING,
                  "oversized frame", "chan: oversized frame (header 5B, body 536870913B)"),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_a_bad_header_is_refused_alike(name, emitted):
    """Both harnesses answer ``bad_frame``, resync at the next newline and
    go on; both dispatcher readers end the channel with the same error."""
    wire, harness_says, reader_says = MALFORMED[name]
    answers = {}
    for harness, out in ((ref_harness, emitted["reference"]), (port_harness, emitted["port"])):
        commands = harness._extract_commands(bytearray(wire))
        assert [c.get("cmd") for c in commands] == ["ping"]
        answers[harness] = [json.loads(line) for line in out.getvalue().splitlines()]
    assert answers[port_harness] == answers[ref_harness]
    assert answers[port_harness][0]["code"] == "bad_frame"
    assert harness_says in answers[port_harness][0]["message"]
    for cls in (RefProcess, PortProcess):
        messages, ended = _read_events(cls, wire)
        assert messages == [] and ended == reader_says


@pytest.mark.parametrize("cmd", ["invoke", "multi_invoke"])
def test_a_torn_body_is_a_permanent_error_to_every_op(cmd, emitted):
    wire = _torn(cmd)
    answers = {}
    for harness, out in ((ref_harness, emitted["reference"]), (port_harness, emitted["port"])):
        assert harness._extract_commands(bytearray(wire)) == []
        answers[harness] = [json.loads(line) for line in out.getvalue().splitlines()]
    assert answers[port_harness] == answers[ref_harness]
    ids = ["m1", "m2"] if cmd == "multi_invoke" else ["tornop"]
    assert [e["id"] for e in answers[port_harness]] == ids
    assert all(e["code"] == "bad_frame" and e["permanent"] for e in answers[port_harness])
    for cls, codec in ((RefProcess, ref_frames), (PortProcess, port_frames)):
        (message,), _ = _read_events(cls, wire)
        with pytest.raises(codec.FrameIntegrityError, match="torn payload"):
            codec.decode_payload(*message[2:])


def test_a_header_that_is_not_json_keeps_the_stream_in_sync(emitted):
    bad = ref_frames.HEADER.pack(ref_frames.MAGIC, 1, 0, 0, 7, 3) + b"not-js!\x01\x02\x03"
    wire = bad + ref_frames.encode_frame(0, {"cmd": "ping"})
    answers = {}
    for harness, out in ((ref_harness, emitted["reference"]), (port_harness, emitted["port"])):
        assert [c["cmd"] for c in harness._extract_commands(bytearray(wire))] == ["ping"]
        answers[harness] = [json.loads(line)["code"] for line in out.getvalue().splitlines()]
    assert answers[port_harness] == answers[ref_harness] == ["bad_frame"]
    for cls, codec in ((RefProcess, ref_frames), (PortProcess, port_frames)):
        messages, _ = _read_events(cls, wire)
        with pytest.raises(codec.FrameError, match="not JSON"):
            codec.decode_payload(*messages[0][2:])


def test_a_frame_cut_short_waits_in_the_harness_and_kills_the_channel(emitted):
    """Mid-frame, the harness keeps the partial bytes for the next read; a
    dispatcher reader whose channel ends there raises (the supervisor then
    reconnects) instead of waiting forever."""
    wire = ref_frames.encode_frame(1, {"cmd": "invoke", "id": "op", "_body": "args_bytes"},
                                   b"x" * 100)
    for harness in (ref_harness, port_harness):
        buffer = bytearray(wire[:40])
        assert harness._extract_commands(buffer) == [] and len(buffer) == 40
        buffer.extend(wire[40:])
        assert harness._extract_commands(buffer)[0]["args_bytes"] == b"x" * 100
    ends = {cls: _read_events(cls, wire[:40]) for cls in (RefProcess, PortProcess)}
    assert ends[PortProcess] == ends[RefProcess] == ([], "chan: channel EOF mid-frame (27/47 bytes)")


def test_oversized_encodes_are_refused_alike():
    body = b"\x00" * (port_frames.MAX_BODY_BYTES + 1)
    for codec in (ref_frames, port_frames):
        with pytest.raises(codec.FrameError, match="frame too large"):
            codec.encode_frame(0, {"cmd": "x"}, body)


def test_the_port_codec_has_the_reference_constants():
    names = ("MAGIC", "VERSION", "HEADER_LEN", "FLAG_BODY_ZLIB", "MAX_HEADER_BYTES",
             "MAX_BODY_BYTES", "MIN_COMPRESS_BYTES", "VERB_CMD", "VERB_INVOKE", "VERB_RESULT",
             "VERB_TELEMETRY", "VERB_MULTI_INVOKE", "VERB_SERVE", "VERB_NAMES")
    assert {n: getattr(port_frames, n) for n in names} == {n: getattr(ref_frames, n)
                                                           for n in names}
    mirror = (port_harness._FRAME_MAGIC, port_harness._FRAME_VERSION, port_harness._FRAME_HEADER.size,
              port_harness._FRAME_MAX_HEADER, port_harness._FRAME_MAX_BODY,
              port_harness._FRAME_MIN_COMPRESS, port_harness._FRAME_FLAG_ZLIB)
    assert mirror == (ref_frames.MAGIC, ref_frames.VERSION, ref_frames.HEADER_LEN,
                      ref_frames.MAX_HEADER_BYTES, ref_frames.MAX_BODY_BYTES,
                      ref_frames.MIN_COMPRESS_BYTES, ref_frames.FLAG_BODY_ZLIB)


def test_a_step_s_token_chunks_leave_as_one_frame_when_the_step_ends(emitted, monkeypatch):
    """With frames on, the intermediate chunks one engine step emits are
    coalesced into one ``telemetry_batch`` frame, sent as the step ends:
    none waits for the next step."""
    monkeypatch.setitem(port_harness._FRAMES, "out", True)

    class Engine:
        def step(self):
            return [{"rid": "a", "tokens": [1, 2], "done": False},
                    {"rid": "b", "tokens": [3], "done": False}]

    session = port_harness._ServeSession("s1", {"spec": {}})
    session._engine = Engine()
    session.running = {rid: {"deadline": None, "emitted": 0, "t_admit": 0.0}
                       for rid in ("a", "b")}
    session._pump_engine()
    messages, _ = _read_events(PortProcess, emitted["port"].getvalue())
    assert [m[0] for m in messages] == ["frame"]
    batch = port_frames.decode_payload(*messages[0][2:])
    assert (batch["event"], batch["id"], batch["count"]) == ("telemetry_batch", "s1", 2)
    records = json.loads(batch["records"])
    assert [(r["rid"], r["idx"], r["tokens"]) for r in records] == [("a", 0, [1, 2]),
                                                                   ("b", 0, [3])]
    assert port_harness._BATCHER._pending == {}


# ---------------------------------------------------------------------------
# The client on a real pool server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("road", ["frames", "client_declines", "worker_declines"])
def test_invokes_of_one_turn_batch_on_frames_and_every_road_gives_equal_results(
        road, tmp_path, run_async):
    """Three invokes of one digest queued in the same event-loop turn leave
    as one ``multi_invoke`` frame on a negotiated channel; with frames
    declined by the client, or by the worker's own kill switch, the channel
    stays on JSON lines, and the results are the same."""
    import base64
    import hashlib
    import pickle

    import cloudpickle

    from covalent_tpu_plugin_torch.agent import start_pool_server
    from covalent_tpu_plugin_torch.obs.metrics import AGENT_BATCHED_INVOKES_TOTAL
    from covalent_tpu_plugin_torch.transport import LocalTransport

    def square(x):
        return x * x

    payload = cloudpickle.dumps(square)
    digest = hashlib.sha256(payload).hexdigest()
    path = tmp_path / f"{digest}.pkl"
    path.write_bytes(payload)

    async def flow():
        client = await start_pool_server(
            LocalTransport(), str(tmp_path / "remote"), sys.executable, preload="cloudpickle",
            env={"COVALENT_TPU_AGENT_FRAMES": "0"} if road == "worker_declines" else None,
            frames_enabled=road != "client_declines")
        try:
            await client.register_fn(digest, str(path))
            before = AGENT_BATCHED_INVOKES_TOTAL.value
            await asyncio.gather(*(client.invoke(f"op{i}", digest,
                                                 args_bytes=cloudpickle.dumps(((i,), {})))
                                   for i in range(3)))
            events = [await client.wait_result(f"op{i}", timeout=60) for i in range(3)]
            batched = AGENT_BATCHED_INVOKES_TOTAL.value - before
            return client.frames_active, events, batched
        finally:
            await client.close()

    frames_active, events, batched = run_async(flow())
    values = [pickle.loads(e["data_bytes"] if "data_bytes" in e
                           else base64.b64decode(e["data"]))[:2] for e in events]
    assert values == [(0, None), (1, None), (4, None)]
    assert frames_active == (road == "frames")
    assert batched == (3 if road == "frames" else 0)
