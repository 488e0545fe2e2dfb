"""Binary frame layer for the agent channel (dispatcher side).

Own copy of ``covalent_tpu_plugin/transport/frames.py``, byte-compatible
with it.  Without frames every RPC argument and result and every streamed
serve token travels as pickle -> base64 -> JSON line: a third more bytes
and a JSON parse of the bulky string on both ends.  After negotiation the
hot path rides length-prefixed binary frames instead:

    offset 0   magic      2 bytes   0xC5 0xF7 (never begins a JSON line)
    offset 2   version    1 byte    currently 1
    offset 3   verb       1 byte    accounting/routing hint (VERB_*)
    offset 4   flags      1 byte    bit 0: body is zlib-compressed
    offset 5   header len 4 bytes   big-endian u32
    offset 9   body len   4 bytes   big-endian u32
    offset 13  header     UTF-8 JSON object (the command/event, small)
    ...        body       raw bytes (pickle payloads, token batches, KV bundles)

The JSON header is exactly the dict the JSON-lines protocol would have
sent, minus its bulky field; its ``_body`` key names the field the raw
body re-attaches to on the receiving side (``args_bytes`` for an invoke,
``data_bytes`` for a result or a KV bundle, ``records`` for a coalesced
telemetry batch, ``kv_bytes`` for a request carrying a KV bundle).  Frames
and JSON lines interleave freely on one stream after negotiation: a reader
dispatches on the first byte.

Negotiation rides the pool server's ready banner: a frame-capable runtime
advertises ``"frames": 1``, the client (unless
``COVALENT_TPU_AGENT_FRAMES=0`` or ``GPUExecutor(agent_frames=False)``)
answers with a ``frames`` command, and both sides switch.  A silent banner
leaves the channel on JSON lines with byte-equal results.

The worker-side mirror of this codec lives in ``harness.py``, which must
stay stdlib-only because it runs standalone on workers;
``tests/test_torch_frames.py`` keeps the port's two copies and the
reference's byte-compatible.
"""

from __future__ import annotations

import json
import struct
import zlib

__all__ = [
    "MAGIC",
    "VERSION",
    "HEADER",
    "HEADER_LEN",
    "FLAG_BODY_ZLIB",
    "MAX_HEADER_BYTES",
    "MAX_BODY_BYTES",
    "MIN_COMPRESS_BYTES",
    "VERB_CMD",
    "VERB_INVOKE",
    "VERB_RESULT",
    "VERB_TELEMETRY",
    "VERB_MULTI_INVOKE",
    "VERB_SERVE",
    "VERB_NAMES",
    "FrameError",
    "FrameIntegrityError",
    "encode_frame",
    "decode_payload",
]

MAGIC = b"\xc5\xf7"
VERSION = 1

HEADER = struct.Struct(">2sBBBII")
HEADER_LEN = HEADER.size  # 13

#: Body compressed with zlib (stdlib on every worker — the frame codec
#: deliberately does not depend on the optional zstd the file-staging
#: codec can negotiate).
FLAG_BODY_ZLIB = 0x01

#: Header/body sanity ceilings: a corrupt length field must be refused as
#: a clean protocol error, never honoured as a multi-GB read that wedges
#: (or OOMs) the resident runtime.
MAX_HEADER_BYTES = 16 * 1024 * 1024
MAX_BODY_BYTES = 512 * 1024 * 1024

#: Bodies below this ship uncompressed (mirrors codec.MIN_COMPRESS_BYTES:
#: tiny payloads can't pay for the deflate header).
MIN_COMPRESS_BYTES = 512

VERB_CMD = 0
VERB_INVOKE = 1
VERB_RESULT = 2
VERB_TELEMETRY = 3
VERB_MULTI_INVOKE = 4
VERB_SERVE = 5

VERB_NAMES = {
    VERB_CMD: "cmd",
    VERB_INVOKE: "invoke",
    VERB_RESULT: "result",
    VERB_TELEMETRY: "telemetry_batch",
    VERB_MULTI_INVOKE: "multi_invoke",
    VERB_SERVE: "serve",
}


class FrameError(ValueError):
    """Malformed frame: bad magic/version, oversized or torn lengths.

    A ValueError (not TransportError) so a parser can distinguish protocol
    corruption from channel death; receivers surface it as a clean error
    event (server side) or a channel teardown (client side).
    """


class FrameIntegrityError(RuntimeError):
    """Frame body failed decompression after an intact transfer.

    RuntimeError on purpose — ``resilience.classify_error`` maps unknown
    non-transport errors PERMANENT, which is right for content corruption:
    re-sending the same torn bytes can never succeed.
    """


def encode_frame(
    verb: int,
    header: dict,
    body: bytes = b"",
    codec: str = "",
) -> bytes:
    """One wire-ready frame.  ``codec="zlib"`` compresses the body when it
    is large enough to win (>= MIN_COMPRESS_BYTES and shrinks >= 10%)."""
    flags = 0
    if body and codec == "zlib" and len(body) >= MIN_COMPRESS_BYTES:
        packed = zlib.compress(body, 6)
        if len(packed) < len(body) * 0.9:
            body = packed
            flags |= FLAG_BODY_ZLIB
    header_bytes = json.dumps(header, separators=(",", ":")).encode()
    if len(header_bytes) > MAX_HEADER_BYTES or len(body) > MAX_BODY_BYTES:
        raise FrameError(
            f"frame too large (header {len(header_bytes)}B, "
            f"body {len(body)}B)"
        )
    return (
        HEADER.pack(MAGIC, VERSION, verb, flags, len(header_bytes), len(body))
        + header_bytes
        + body
    )


def decode_payload(
    flags: int, header_bytes: bytes, body: bytes
) -> dict:
    """Reassemble the protocol dict from a received frame's parts.

    The header JSON parses back to the command/event dict; a compressed
    body is inflated (:class:`FrameIntegrityError` on torn bytes — the
    frame arrived length-intact, so garbage here is content corruption,
    not a channel problem); the body re-attaches under the field the
    header's ``_body`` key names.
    """
    try:
        event = json.loads(header_bytes.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as err:
        raise FrameError(f"frame header is not JSON: {err}") from err
    if not isinstance(event, dict):
        raise FrameError("frame header is not a JSON object")
    if flags & FLAG_BODY_ZLIB:
        try:
            body = zlib.decompress(body)
        except zlib.error as err:
            raise FrameIntegrityError(
                f"frame body failed decompression (torn payload): {err}"
            ) from err
    key = event.pop("_body", None)
    if key:
        event[str(key)] = body
    return event
