"""Transport interface (own copy of ``covalent_tpu_plugin/transport/base.py``).

Distills the operations the reference performs over its connection object —
``conn.run(cmd)`` (``covalent_ssh_plugin/ssh.py:383``), upload
(``ssh.py:360-361``) and download (``ssh.py:451``) — into an abstract base
class every backend implements.
"""

from __future__ import annotations

import shlex
from abc import ABC, abstractmethod
from dataclasses import dataclass


class TransportError(RuntimeError):
    """Raised for connection/copy/exec failures on the control plane."""


@dataclass
class CommandResult:
    """Shape-compatible stand-in for asyncssh's ``SSHCompletedProcess``."""

    exit_status: int
    stdout: str
    stderr: str

    @property
    def returncode(self) -> int:
        return self.exit_status


class Transport(ABC):
    """One control-plane channel to one worker host."""

    #: Human-readable address for logs ("user@host" or "localhost").
    address: str = "?"

    #: True when bytes never cross a wire (shared filesystem): the codec
    #: layer (:mod:`.codec`) then ships raw, since compressing a local copy
    #: burns CPU to save bytes that were free.
    zero_wire: bool = False

    @abstractmethod
    async def run(self, command: str, timeout: float | None = None) -> CommandResult:
        """Execute a shell command on the worker and capture its output."""

    @abstractmethod
    async def put(self, local_path: str, remote_path: str) -> None:
        """Copy a file from the dispatcher to the worker."""

    @abstractmethod
    async def get(self, remote_path: str, local_path: str) -> None:
        """Copy a file from the worker back to the dispatcher."""

    @abstractmethod
    async def close(self) -> None:
        """Release the channel (idempotent)."""

    async def exists_batch(self, paths: list[str]) -> list[bool]:
        """Existence flags for ``paths`` in ONE round trip (seeds the CAS
        index, :mod:`..cache`).  Unparseable probe output reads as
        all-absent: a spurious re-upload at worst, never a spurious skip."""
        if not paths:
            return []
        probe = "; ".join(f"test -e {shlex.quote(p)} && echo 1 || echo 0" for p in paths)
        result = await self.run(probe)
        tokens = [line.strip() for line in result.stdout.splitlines()
                  if line.strip() in ("0", "1")]
        if result.exit_status != 0 or len(tokens) != len(paths):
            return [False] * len(paths)
        return [token == "1" for token in tokens]

    async def rename(self, src: str, dst: str) -> None:
        """Atomically move a worker-side file (the CAS publish step): a
        reader never sees a half-written artifact under its digest."""
        result = await self.run(f"mv -f {shlex.quote(src)} {shlex.quote(dst)}")
        if result.exit_status != 0:
            raise TransportError(f"rename {src} -> {dst} failed: {result.stderr.strip()}")

    async def put_bundle(self, items: "list[tuple[str, str, str]]", bundle_path: str,
                         python_path: str = "python3", codec=None) -> dict:
        """Ship many files in ONE upload and ONE remote exec.

        ``items`` is ``[(local_path, remote_path, sha256_digest)]`` (an
        empty digest skips that member's check).  Packs a tar (compressed
        with ``codec`` when that pays), ``put``s it to ``bundle_path`` and
        unpacks it with one ``python -c`` exec that checks each member's
        digest against the decompressed bytes and publishes it atomically.
        A torn bundle raises :class:`~.codec.CodecIntegrityError`
        (permanent).  Backends with direct filesystem access override it.
        """
        import asyncio
        import os
        import tempfile

        from . import codec as codec_mod

        payload, codec_name = await asyncio.to_thread(codec_mod.build_bundle, items, codec)
        fd, tmp_local = tempfile.mkstemp(prefix="covalent-gpu-bundle-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            await self.put(tmp_local, bundle_path)
        finally:
            try:
                os.unlink(tmp_local)
            except OSError:
                pass
        codec_mod._check_exec(
            await self.run(codec_mod.unpack_command(python_path, bundle_path, codec_name)),
            f"bundle unpack of {bundle_path}",
        )
        codec_mod.record_wire("up", codec_name, len(payload))
        return {"ops": 2, "wire_bytes": len(payload), "codec": codec_name,
                "members": len(items)}

    async def start_process(self, command: str, describe: str = ""):
        """Start a long-lived remote process with piped stdin/stdout.

        Returns a :class:`~.process.TransportProcess`, which writes JSON
        lines and binary frames (``write_line``/``write_bytes``) and reads
        either (``read_event``).  Optional: backends that cannot hold a
        persistent channel raise.
        """
        raise TransportError(f"{type(self).__name__} does not support persistent processes")

    async def remove(self, paths: list[str]) -> CommandResult:
        """Best-effort delete of worker-side files (reference cleanup,
        ssh.py:313-315)."""
        return await self.run("rm -f " + " ".join(shlex.quote(p) for p in paths))
