"""Transport interface (own copy of ``covalent_tpu_plugin/transport/base.py``,
cut to what launch-mode dispatch and the
resident pool server use).

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


class Transport(ABC):
    """One control-plane channel to one worker host."""

    #: Human-readable address for logs ("user@host" or "localhost").
    address: str = "?"

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
