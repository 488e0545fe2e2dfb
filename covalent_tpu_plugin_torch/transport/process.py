"""Persistent process channels over a transport (own copy of
``covalent_tpu_plugin/transport/process.py``, JSONL only).

The resident pool server needs a long-lived stream instead of one
``run(cmd)`` per round trip: commands written to the remote process's
stdin, events read from its stdout as they happen.  The reference's
channel also carries length-prefixed binary frames; the port's stays on
JSON lines until binary frames are ported (ROADMAP item 2c).
"""

from __future__ import annotations

import asyncio

from .base import TransportError


class TransportProcess:
    """A running remote process with line-oriented stdin/stdout access."""

    def __init__(self, reader, writer, proc=None, describe: str = "process"):
        self._reader = reader
        self._writer = writer
        self._proc = proc
        self._describe = describe
        self._closed = False

    async def write_line(self, line: str) -> None:
        if self._closed:
            raise TransportError(f"{self._describe}: channel closed")
        try:
            self._writer.write((line + "\n").encode())
            await self._writer.drain()
        except (ConnectionError, BrokenPipeError, OSError) as err:
            raise TransportError(f"{self._describe}: write failed: {err}") from err

    async def read_line(self, timeout: float | None = None) -> str:
        """Next stdout line (stripped).  Raises on EOF: a dead channel must
        surface as an error, not an empty event."""
        try:
            raw = await asyncio.wait_for(self._reader.readline(), timeout)
        except asyncio.TimeoutError:
            raise TransportError(f"{self._describe}: no event within {timeout}s") from None
        if not raw:
            raise TransportError(f"{self._describe}: channel EOF")
        return raw.decode(errors="replace").rstrip("\r\n")

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
    """Spawn a local subprocess wired for line-protocol use.  Its stderr is
    inherited: the command redirects it where it wants."""
    proc = await asyncio.create_subprocess_exec(
        *argv,
        stdin=asyncio.subprocess.PIPE,
        stdout=asyncio.subprocess.PIPE,
        # a protocol line may be long (a factory's open error, stats)
        limit=16 << 20,
    )
    return TransportProcess(proc.stdout, proc.stdin, proc, describe)
