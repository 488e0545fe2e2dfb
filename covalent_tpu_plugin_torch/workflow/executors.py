"""Executor registry and alias resolution.

Own copy of ``covalent_tpu_plugin/workflow/executors.py``.  Upstream
Covalent resolves ``executor="ssh"`` through the setuptools entry point
group ``covalent.executor.executor_plugins`` (``setup.py:36,74-76`` in the
reference); the standalone engine keeps a plain registry with the same
semantics: a string alias maps to an executor class, instantiated from its
config defaults, and instances pass through unchanged.  The built-ins are
``"local"`` and ``"gpu"`` (:class:`..gpu.GPUExecutor`).  ``"gpu"`` builds
its executor from ``[executors.gpu]``: with ``transport = "ssh"`` or
``"minissh"`` and ``hostname`` (or ``workers``) there, an SSH executor.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Callable

#: package-sets already installed into this process's environment, guarded
#: by a thread lock — dispatches run on separate event-loop threads and pip
#: does not guarantee concurrent installs into one site-packages are safe.
_PIP_INSTALLED: set[tuple[str, ...]] = set()
_PIP_LOCK = threading.Lock()


def _install_pip_deps_once(pip_deps: tuple[str, ...]) -> None:
    from ..harness import install_pip_deps

    with _PIP_LOCK:
        if pip_deps in _PIP_INSTALLED:
            return
        install_pip_deps(list(pip_deps))
        _PIP_INSTALLED.add(pip_deps)


class LocalExecutor:
    """Default executor: runs the electron in-process on the dispatcher.

    The upstream analog is Covalent's local/dask default executor, which the
    reference's mixed-executor test relies on
    (``tests/functional_tests/svm_workflow.py:11-29`` — some electrons
    local, some remote).
    """

    SHORT_NAME = "local"

    async def run(
        self, function: Callable, args: list, kwargs: dict, task_metadata: dict
    ) -> Any:
        pip_deps = (task_metadata or {}).get("pip_deps")
        if pip_deps:
            # Same pre-task install contract as the remote harness (the
            # dispatcher host is this electron's "worker"), but installed
            # once per package-set per process — a mapped electron must not
            # re-pay the subprocess on all N invocations.
            await asyncio.to_thread(_install_pip_deps_once, tuple(pip_deps))
        return await asyncio.to_thread(function, *tuple(args or ()), **(kwargs or {}))

    async def close(self) -> None:
        pass


_REGISTRY: dict[str, type] = {}


def register_executor(alias: str, cls: type) -> None:
    _REGISTRY[alias] = cls


def resolve_executor(spec: Any) -> Any:
    """alias string -> new instance; instance -> itself."""
    if isinstance(spec, str):
        try:
            cls = _REGISTRY[spec]
        except KeyError:
            raise ValueError(
                f"unknown executor alias {spec!r}; registered: {sorted(_REGISTRY)}"
            ) from None
        return cls()
    return spec


class _FleetNotPorted:
    """``executor="fleet"``: the fleet work queue comes with slice 5."""

    def __init__(self) -> None:
        raise NotImplementedError(
            'executor="fleet" is not ported yet: the fleet scheduler comes with '
            "slice 5b (the rest of the executor)"
        )


def _register_builtins() -> None:
    from ..gpu import GPUExecutor

    register_executor("local", LocalExecutor)
    register_executor("gpu", GPUExecutor)
    register_executor("fleet", _FleetNotPorted)


_register_builtins()
