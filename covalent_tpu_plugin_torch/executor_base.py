"""``RemoteExecutor`` template (own copy of ``covalent_tpu_plugin/executor_base.py``).

The reference subclasses Covalent's async remote-executor template
(``covalent_ssh_plugin/ssh.py:32`` —
``from covalent.executor.executor_plugins.remote_executor import
RemoteExecutor``).  When Covalent is installed we use the real class so
``GPUExecutor`` plugs into a live server unmodified; otherwise this module
provides a behaviour-compatible shim exposing the same abstract lifecycle
(`_validate_credentials`, `_upload_task`, `submit_task`, `get_status`,
`_poll_task`, `query_result`, `cancel`, `run` — signatures at
``ssh.py:317,337,363,388,408,434,460,466``), keeping the framework fully
standalone.
"""

from __future__ import annotations

from abc import abstractmethod
from typing import Any, Callable

try:  # covered by the stub-covalent interop tier when importable
    from covalent.executor.executor_plugins.remote_executor import (
        RemoteExecutor as _CovalentRemoteExecutor,
    )

    _BASE: type = _CovalentRemoteExecutor
    HAVE_COVALENT = True
except Exception:
    HAVE_COVALENT = False

    class _StandaloneRemoteExecutor:
        """Async executor template (standalone stand-in for Covalent's)."""

        def __init__(
            self,
            poll_freq: float = 15,
            remote_cache: str = "",
            credentials_file: str = "",
        ) -> None:
            self.poll_freq = poll_freq
            self.remote_cache = remote_cache
            self.credentials_file = credentials_file

        @abstractmethod
        async def _validate_credentials(self) -> bool: ...

        @abstractmethod
        async def _upload_task(self, *args, **kwargs) -> None: ...

        @abstractmethod
        async def submit_task(self, *args, **kwargs) -> Any: ...

        @abstractmethod
        async def get_status(self, *args, **kwargs) -> Any: ...

        @abstractmethod
        async def _poll_task(self, *args, **kwargs) -> Any: ...

        @abstractmethod
        async def query_result(self, *args, **kwargs) -> Any: ...

        @abstractmethod
        async def cancel(self, *args, **kwargs) -> None: ...

        @abstractmethod
        async def run(
            self, function: Callable, args: list, kwargs: dict, task_metadata: dict
        ) -> Any: ...

    _BASE = _StandaloneRemoteExecutor

RemoteExecutor = _BASE

__all__ = ["RemoteExecutor", "HAVE_COVALENT"]
