"""Local (subprocess) transport (own copy of
``covalent_tpu_plugin/transport/local.py``).

Drives the full stage/submit/poll/fetch lifecycle through a local
subprocess, so the whole executor path runs end to end with no sshd.
"""

from __future__ import annotations

import asyncio
import os
import shutil

from .base import CommandResult, Transport, TransportError


class LocalTransport(Transport):
    """Runs commands via ``asyncio.create_subprocess_shell`` and copies files
    with ``shutil`` on the dispatcher host itself."""

    zero_wire = True

    def __init__(self) -> None:
        self.address = "localhost"
        self._closed = False

    async def run(self, command: str, timeout: float | None = None) -> CommandResult:
        if self._closed:
            raise TransportError("transport is closed")
        proc = await asyncio.create_subprocess_shell(
            command,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
        )
        try:
            stdout, stderr = await asyncio.wait_for(proc.communicate(), timeout)
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()
            raise TransportError(f"command timed out after {timeout}s: {command!r}")
        return CommandResult(
            exit_status=proc.returncode if proc.returncode is not None else -1,
            stdout=stdout.decode(errors="replace"),
            stderr=stderr.decode(errors="replace"),
        )

    async def start_process(self, command: str, describe: str = ""):
        if self._closed:
            raise TransportError("transport is closed")
        from .process import start_local_process

        # `exec` so the handle we keep (and can kill) IS the target process,
        # not a lingering shell wrapper holding the pipes open.
        return await start_local_process(
            ["/bin/sh", "-c", f"exec {command}"],
            describe or f"local:{command.split()[0]}",
        )

    async def exists_batch(self, paths: list[str]) -> list[bool]:
        """Direct stats, no shell on the CAS probe path."""
        return await asyncio.to_thread(lambda: [os.path.exists(p) for p in paths])

    async def rename(self, src: str, dst: str) -> None:
        """Direct atomic replace, no shell on the CAS publish path."""
        try:
            await asyncio.to_thread(os.replace, src, dst)
        except OSError as err:
            raise TransportError(f"rename {src} -> {dst} failed: {err}") from err

    async def put_bundle(self, items, bundle_path, python_path="python3", codec=None) -> dict:
        """Direct atomic copies in one thread hop: a bundle saves round
        trips, and on a shared filesystem a round trip is a function call."""
        from . import codec as codec_mod

        def copy_all() -> int:
            total = 0
            for local, remote, _digest in items:
                parent = os.path.dirname(remote)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                # unique per call: two gang processes staging one digest from
                # one dispatcher must not share a temporary name
                tmp = f"{remote}.tmp-{os.getpid()}-{os.urandom(4).hex()}"
                shutil.copyfile(local, tmp)
                os.replace(tmp, remote)
                total += os.path.getsize(remote)
            return total

        size = await asyncio.to_thread(copy_all)
        codec_mod.record_wire("up", "raw", size)
        return {"ops": 1, "wire_bytes": size, "codec": "raw", "members": len(items)}

    async def remove(self, paths: list[str]) -> CommandResult:
        """Direct unlink, no shell: mirrors ``rm -f`` (missing files are
        fine; other failures surface as a nonzero exit + stderr)."""

        def unlink_all() -> list[str]:
            errors = []
            for path in paths:
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
                except OSError as err:
                    errors.append(f"{path}: {err}")
            return errors

        errors = await asyncio.to_thread(unlink_all)
        return CommandResult(
            exit_status=1 if errors else 0, stdout="", stderr="; ".join(errors)
        )

    async def put(self, local_path: str, remote_path: str) -> None:
        if local_path != remote_path:
            await asyncio.to_thread(shutil.copyfile, local_path, remote_path)

    async def get(self, remote_path: str, local_path: str) -> None:
        if local_path != remote_path:
            await asyncio.to_thread(shutil.copyfile, remote_path, local_path)

    async def close(self) -> None:
        self._closed = True
