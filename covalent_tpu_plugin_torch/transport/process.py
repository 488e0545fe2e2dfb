"""Persistent process channels over a transport (own copy of
``covalent_tpu_plugin/transport/process.py``).

The resident pool server needs a long-lived stream instead of one
``run(cmd)`` per round trip: commands written to the remote process's
stdin, events read from its stdout as they happen.  After the channel
negotiates binary frames (:mod:`.frames`) the stream interleaves JSON
lines with length-prefixed frames; :meth:`TransportProcess.read_event`
dispatches on the first byte, so one reader serves both encodings.
"""

from __future__ import annotations

import asyncio

from . import frames
from .base import TransportError


class TransportProcess:
    """A running remote process with line- and frame-oriented stdin/stdout
    access."""

    def __init__(self, reader, writer, proc=None, describe: str = "process"):
        self._reader = reader
        self._writer = writer
        self._proc = proc
        self._describe = describe
        self._closed = False

    @property
    def returncode(self) -> int | None:
        """The process's exit code once it is known, else None: asyncio's
        ``returncode``, or an SSH process object's ``exit_status``."""
        if self._proc is None:
            return None
        code = getattr(self._proc, "returncode", None)
        return code if code is not None else getattr(self._proc, "exit_status", None)

    async def write_line(self, line: str) -> None:
        await self.write_bytes((line + "\n").encode())

    async def write_bytes(self, payload: bytes) -> None:
        """Ship pre-encoded bytes (a JSON line or a binary frame) down the
        channel."""
        if self._closed:
            raise TransportError(f"{self._describe}: channel closed")
        try:
            self._writer.write(payload)
            await self._writer.drain()
        except (ConnectionError, BrokenPipeError, OSError) as err:
            raise TransportError(f"{self._describe}: write failed: {err}") from err

    async def read_line(self, timeout: float | None = None) -> str:
        """Next stdout line, stripped.  EOF raises: a dead channel is an
        error, never an empty event."""
        try:
            raw = await asyncio.wait_for(self._reader.readline(), timeout)
        except asyncio.TimeoutError:
            raise TransportError(f"{self._describe}: no event within {timeout}s") from None
        if not raw:
            raise TransportError(f"{self._describe}: channel EOF")
        return raw.decode(errors="replace").rstrip("\r\n")

    async def _read_exactly(self, n: int, what: str) -> bytes:
        """``readexactly`` with the channel's death as :class:`TransportError`.

        A channel that dies mid-frame leaves the stream unsynchronizable:
        EOF here is a channel failure (the supervisor reconnects), never a
        clean close, and never a wait for bytes that cannot come.
        """
        try:
            return await self._reader.readexactly(n)
        except asyncio.IncompleteReadError as err:
            raise TransportError(
                f"{self._describe}: channel EOF mid-{what} ({len(err.partial)}/{n} bytes)"
            ) from err

    async def read_event(self, timeout: float | None = None):
        """Next protocol message: ``("line", str)`` or
        ``("frame", verb, flags, header_bytes, body_bytes)``.

        The first byte decides: the frame magic's lead byte is not ASCII
        and never begins a JSON line.  A frame with a bad magic or version,
        or an oversized length, raises :class:`TransportError`: past a bad
        header nothing on the stream can be trusted, so the channel is torn
        down (transient: the supervisor re-opens on a fresh one).
        """

        async def one_event():
            first = await self._read_exactly(1, "message")
            if first != frames.MAGIC[:1]:
                rest = await self._reader.readline()
                if not rest and not first.strip():
                    raise TransportError(f"{self._describe}: channel EOF")
                return "line", (first + rest).decode(errors="replace").rstrip("\r\n")
            fixed = first + await self._read_exactly(frames.HEADER_LEN - 1, "frame header")
            magic, version, verb, flags, hlen, blen = frames.HEADER.unpack(fixed)
            if magic != frames.MAGIC or version != frames.VERSION:
                raise TransportError(
                    f"{self._describe}: bad frame magic/version ({magic!r} v{version})")
            if hlen > frames.MAX_HEADER_BYTES or blen > frames.MAX_BODY_BYTES:
                raise TransportError(
                    f"{self._describe}: oversized frame (header {hlen}B, body {blen}B)")
            header = await self._read_exactly(hlen, "frame")
            body = await self._read_exactly(blen, "frame") if blen else b""
            return "frame", verb, flags, header, body

        try:
            return await asyncio.wait_for(one_event(), timeout)
        except asyncio.TimeoutError:
            raise TransportError(f"{self._describe}: no event within {timeout}s") from None

    async def close(self, kill: bool = False) -> None:
        """Close stdin (letting the remote side drain) and reap; ``kill``
        ends the process at once."""
        if self._closed:
            return
        self._closed = True
        try:
            self._writer.close()
        except Exception:  # noqa: BLE001 - the pipe may already be gone
            pass
        if self._proc is None:
            return
        if kill:
            try:
                self._proc.kill()
            except ProcessLookupError:
                pass
        try:
            await asyncio.wait_for(self._proc.wait(), 10.0)
        except asyncio.TimeoutError:
            try:
                self._proc.kill()
            except ProcessLookupError:
                pass
            await self._proc.wait()


async def start_local_process(argv: list[str], describe: str) -> TransportProcess:
    """Spawn a local subprocess wired for the line/frame protocol.  Its stderr is
    inherited: the command redirects it where it wants."""
    proc = await asyncio.create_subprocess_exec(
        *argv,
        stdin=asyncio.subprocess.PIPE,
        stdout=asyncio.subprocess.PIPE,
        # a protocol line may be long (a factory's open error, stats)
        limit=16 << 20,
    )
    return TransportProcess(proc.stdout, proc.stdin, proc, describe)
