"""Local (subprocess) transport (own copy of
``covalent_tpu_plugin/transport/local.py``, cut to launch-mode dispatch).

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
