"""SSH transport with bounded, classified retry (own copy of
``covalent_tpu_plugin/transport/ssh.py``).

Reimplements the reference's connection manager
(``covalent_ssh_plugin/ssh.py:210-282``) on the :class:`Transport`
interface, with two deliberate departures:

* host-key verification is ON by default (the reference passes
  ``known_hosts=None``, ``ssh.py:267``);
* the backend degrades: asyncssh when importable, else the OpenSSH client
  binaries (``ssh``/``scp``) over subprocess, and as the last rung the
  pure-Python SSH-2 stack (:mod:`.minissh`, on ``cryptography``), so the
  control plane works on hosts with no SSH stack installed.  ``backend=``
  pins one ("asyncssh" / "openssh" / "minissh").  The ladder is resolved
  once, in the constructor, so one transport never straddles two backends.

Retry semantics match the reference: up to ``max_attempts`` tries
(default 5, ``ssh.py:90``) sleeping ``retry_wait_time`` between them
(default 5 s, ``ssh.py:91``), retrying only :data:`RETRYABLE_ERRORS`
(``ssh.py:249-253``), and re-raising at once when ``retry_connect`` is
False (``ssh.py:271-273``).  Authentication and host-key verdicts are not
in that tuple: they fail on the first attempt.
"""

from __future__ import annotations

import asyncio
import shlex
import shutil
from typing import Sequence

from ..obs import events as obs_events
from ..utils.log import app_log
from .base import CommandResult, Transport, TransportError

try:  # pragma: no cover - asyncssh is optional
    import asyncssh

    _HAVE_ASYNCSSH = True
except Exception:
    asyncssh = None
    _HAVE_ASYNCSSH = False

#: Errors worth retrying, mirroring ssh.py:249-253.
RETRYABLE_ERRORS: tuple[type[BaseException], ...] = (
    ConnectionRefusedError,
    ConnectionResetError,
    TimeoutError,
    OSError,
)
if _HAVE_ASYNCSSH:  # pragma: no cover
    RETRYABLE_ERRORS = RETRYABLE_ERRORS + (asyncssh.ConnectionLost,)


class SSHTransport(Transport):
    """One SSH channel to one worker.

    Construct via :func:`connect_with_retries`, which performs the actual
    handshake/validation; the constructor itself is cheap.
    """

    def __init__(
        self,
        hostname: str,
        username: str = "",
        ssh_key_file: str = "",
        port: int = 22,
        strict_host_keys: bool = True,
        connect_timeout: float = 30.0,
        backend: str = "auto",
        password: str = "",
        known_host_key=None,
    ) -> None:
        if backend not in ("auto", "asyncssh", "openssh", "minissh"):
            raise ValueError(
                f'backend must be "auto"/"asyncssh"/"openssh"/"minissh", '
                f"got {backend!r}"
            )
        self.hostname = hostname
        self.username = username
        self.ssh_key_file = ssh_key_file
        self.port = port
        self.strict_host_keys = strict_host_keys
        self.connect_timeout = connect_timeout
        self.address = f"{username}@{hostname}" if username else hostname
        self._conn = None  # asyncssh/minissh connection when active
        self.password = password
        self.known_host_key = known_host_key
        if backend == "auto":
            # Degradation ladder: asyncssh > OpenSSH binaries > vendored
            # pure-python stack.  Resolved here (not per-call) so one
            # transport never straddles two backends.
            if _HAVE_ASYNCSSH:
                backend = "asyncssh"
            elif shutil.which("ssh") is not None:
                backend = "openssh"
            else:
                backend = "minissh"
        self.backend = backend
        self._use_asyncssh = backend == "asyncssh"
        self._closed = False

    # -- handshake -----------------------------------------------------------

    async def _open(self) -> None:
        if self.backend == "minissh":
            # Validate the pin configuration BEFORE importing the minissh
            # stack: the config error is actionable on any host, while the
            # import needs `cryptography` — a missing optional dep must not
            # mask the real diagnostic.
            if self.strict_host_keys and self.known_host_key is None:
                raise TransportError(
                    "minissh backend with strict_host_keys=True needs "
                    "known_host_key (a key object or public-key file path)"
                )
            try:
                from . import minissh
            except ImportError as err:
                # an ImportError, not an OSError: no retry can install it
                raise ImportError(
                    f"the minissh backend needs the `cryptography` package ({err}); "
                    "install it, or use backend='asyncssh'/'openssh'") from err

            known = self.known_host_key
            if isinstance(known, (str, bytes)) and known:
                from cryptography.hazmat.primitives import serialization

                with open(known, "rb") as fh:
                    known = serialization.load_ssh_public_key(fh.read())
            self._conn = await minissh.connect(
                self.hostname,
                self.port,
                self.username or "root",
                password=self.password or None,
                client_key=self.ssh_key_file or None,
                known_host_key=known if self.strict_host_keys else None,
                connect_timeout=self.connect_timeout,
            )
            return
        if self._use_asyncssh:
            if self.known_host_key is not None:
                # Silently ignoring an operator's explicit pin would be a
                # MITM-protection downgrade; asyncssh users pin via
                # ~/.ssh/known_hosts (its native mechanism) instead.
                raise TransportError(
                    "known_host_key pinning is implemented for the "
                    "minissh backend; with asyncssh use a known_hosts "
                    "entry (strict_host_keys=True already enables it)"
                )
            kwargs = dict(
                username=self.username or None,
                client_keys=[self.ssh_key_file] if self.ssh_key_file else None,
                port=self.port,
                connect_timeout=self.connect_timeout,
            )
            if not self.strict_host_keys:
                kwargs["known_hosts"] = None
            self._conn = await asyncssh.connect(self.hostname, **kwargs)
        else:
            if shutil.which("ssh") is None:
                raise TransportError(
                    "no SSH backend available: install asyncssh or the OpenSSH client"
                )
            # Probe with a no-op exec so connect failures surface here, in the
            # retry loop, rather than at first use.
            result = await self._exec_openssh("true")
            if result.exit_status == 255:  # ssh's own failure exit code
                raise ConnectionRefusedError(result.stderr.strip() or "ssh connect failed")

    # -- OpenSSH-binary backend ---------------------------------------------

    def _ssh_base(self) -> list[str]:
        cmd = ["ssh", "-p", str(self.port), "-o", "BatchMode=yes"]
        if not self.strict_host_keys:
            cmd += ["-o", "StrictHostKeyChecking=no", "-o", "UserKnownHostsFile=/dev/null"]
        if self.ssh_key_file:
            cmd += ["-i", self.ssh_key_file]
        cmd.append(self.address)
        return cmd

    def _scp_base(self) -> list[str]:
        cmd = ["scp", "-P", str(self.port), "-o", "BatchMode=yes"]
        if not self.strict_host_keys:
            cmd += ["-o", "StrictHostKeyChecking=no", "-o", "UserKnownHostsFile=/dev/null"]
        if self.ssh_key_file:
            cmd += ["-i", self.ssh_key_file]
        return cmd

    async def _exec_argv(
        self, argv: Sequence[str], timeout: float | None
    ) -> CommandResult:
        proc = await asyncio.create_subprocess_exec(
            *argv,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
        )
        try:
            stdout, stderr = await asyncio.wait_for(proc.communicate(), timeout)
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()
            raise TransportError(f"timed out after {timeout}s: {' '.join(argv[:3])}...")
        return CommandResult(
            exit_status=proc.returncode if proc.returncode is not None else -1,
            stdout=stdout.decode(errors="replace"),
            stderr=stderr.decode(errors="replace"),
        )

    async def _exec_openssh(self, command: str, timeout: float | None = None) -> CommandResult:
        return await self._exec_argv(self._ssh_base() + [command], timeout)

    # -- Transport interface -------------------------------------------------

    async def start_process(self, command: str, describe: str = ""):
        """Persistent remote process: asyncssh session or an ssh-binary pipe."""
        if self._closed:
            raise TransportError("transport is closed")
        describe = describe or f"{self.address}:{command.split()[0]}"
        if self.backend == "minissh":
            from .process import TransportProcess

            proc = await self._conn.open_exec(command)
            return TransportProcess(proc.stdout, proc.stdin, proc, describe)
        if self._use_asyncssh:
            from .process import TransportProcess

            proc = await self._conn.create_process(command, encoding=None)
            return TransportProcess(proc.stdout, proc.stdin, proc, describe)
        from .process import start_local_process

        return await start_local_process(self._ssh_base() + [command], describe)

    async def run(self, command: str, timeout: float | None = None) -> CommandResult:
        if self._closed:
            raise TransportError("transport is closed")
        if self.backend == "minissh":
            res = await asyncio.wait_for(self._conn.run(command), timeout)
            return CommandResult(
                exit_status=res.exit_status, stdout=res.stdout, stderr=res.stderr
            )
        if self._use_asyncssh:
            proc = await asyncio.wait_for(self._conn.run(command), timeout)
            return CommandResult(
                exit_status=proc.exit_status if proc.exit_status is not None else -1,
                stdout=proc.stdout or "",
                stderr=proc.stderr or "",
            )
        return await self._exec_openssh(command, timeout)

    async def put(self, local_path: str, remote_path: str) -> None:
        if self.backend == "minissh":
            await self._conn.put(local_path, remote_path)
            return
        if self._use_asyncssh:
            await asyncssh.scp(local_path, (self._conn, remote_path))
            return
        result = await self._exec_argv(
            self._scp_base() + [local_path, f"{self.address}:{shlex.quote(remote_path)}"],
            None,
        )
        if result.exit_status != 0:
            raise TransportError(f"scp upload failed: {result.stderr.strip()}")

    async def get(self, remote_path: str, local_path: str) -> None:
        if self.backend == "minissh":
            await self._conn.get(remote_path, local_path)
            return
        if self._use_asyncssh:
            await asyncssh.scp((self._conn, remote_path), local_path)
            return
        result = await self._exec_argv(
            self._scp_base() + [f"{self.address}:{shlex.quote(remote_path)}", local_path],
            None,
        )
        if result.exit_status != 0:
            raise TransportError(f"scp download failed: {result.stderr.strip()}")

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if (
            (self._use_asyncssh or self.backend == "minissh")
            and self._conn is not None
        ):
            self._conn.close()
            await self._conn.wait_closed()


async def connect_with_retries(
    transport: Transport,
    max_attempts: int = 5,
    retry_wait_time: float = 5.0,
    retry_connect: bool = True,
) -> Transport:
    """Open ``transport`` with the reference's bounded-retry envelope.

    Mirrors ``_attempt_client_connect`` (``ssh.py:237-282``): loop up to
    ``max_attempts``, sleep ``retry_wait_time`` between tries, retry only
    :data:`RETRYABLE_ERRORS`, and re-raise immediately when ``retry_connect``
    is False.
    """
    opener = getattr(transport, "_open", None)
    if opener is None:
        return transport
    last_error: BaseException | None = None
    for attempt in range(1, max_attempts + 1):
        try:
            await opener()
            return transport
        except RETRYABLE_ERRORS as err:
            last_error = err
            if not retry_connect:
                raise
            app_log.warning(
                "connect to %s failed (attempt %d/%d): %s",
                transport.address,
                attempt,
                max_attempts,
                err,
            )
            obs_events.emit(
                "transport.retry",
                address=transport.address,
                attempt=attempt,
                max_attempts=max_attempts,
                error=repr(err),
            )
            if attempt < max_attempts:
                await asyncio.sleep(retry_wait_time)
    raise TransportError(
        f"could not connect to {transport.address} "
        f"after {max_attempts} attempts: {last_error}"
    ) from last_error
