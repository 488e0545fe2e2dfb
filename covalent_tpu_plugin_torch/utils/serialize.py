"""Task/result serialization.

The wire protocol matches the reference: the dispatcher cloudpickles the
``(fn, args, kwargs)`` triple into a function file
(``covalent_ssh_plugin/ssh.py:147-150``) and the remote harness writes a
``(result, exception)`` pickle back (``covalent_ssh_plugin/exec.py:45-46``),
here with a third item, the electron's own start and end times.
Own copy of ``covalent_tpu_plugin/utils/serialize.py``.  The harness moves
result tensors to host memory before pickling (``harness._to_host``), since a
CUDA tensor is only meaningful on the machine that holds the card.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Callable

import cloudpickle


def dump_task(
    fn: Callable, args: tuple, kwargs: dict, path: str | Path
) -> None:
    """Stage ``(fn, args, kwargs)`` to ``path`` (reference: ssh.py:147-150)."""
    with open(path, "wb") as f:
        cloudpickle.dump((fn, args, kwargs), f)


def load_result(path: str | Path) -> tuple[Any, BaseException | None, dict | None]:
    """Unpickle a fetched result file (reference: ssh.py:455-458) into
    ``(result, exception, times)``.  ``times`` (the electron's ``start`` and
    ``end``) is None when the electron never ran: the harness's setup
    failures write ``(None, error)``."""
    with open(path, "rb") as f:
        result, exception, *times = pickle.load(f)
    return result, exception, (times[0] if times else None)
