"""Per-electron dependencies: pip packages and call hooks.

Own copy of ``covalent_tpu_plugin/workflow/deps.py``.  The reference's
functional ML workflow attaches pip dependencies to an electron with
upstream Covalent's ``ct.DepsPip`` (``tests/functional_tests/
svm_workflow.py:6,19``) so the worker installs them before the task body
runs.  The standalone engine keeps that surface:

* :class:`DepsPip`: packages (or a requirements file) installed on the
  worker *before* the function pickle is loaded, because unpickling may
  itself import the dependency.  Travels in the task spec (see
  ``harness.run_task``), not in the pickle.
* :class:`DepsCall`: an arbitrary callable run on the worker before
  (``call_before``) or after (``call_after``) the electron body, upstream
  Covalent's generalised dependency hook.

Hook callables ride inside the function pickle via a :class:`_HookedTask`
wrapper.  This module is registered with
``cloudpickle.register_pickle_by_value``, so the wrapper class serialises by
value: the harness subprocess unpickles it without importing this package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Iterable, Sequence

import cloudpickle


class DepsPip:
    """Pip packages an electron needs on its worker.

    ``DepsPip(packages=["scikit-learn==1.1.2"])`` or
    ``DepsPip(reqs_path="requirements.txt")`` (file read eagerly at
    construction so the worker never needs the file).
    """

    def __init__(
        self,
        packages: str | Sequence[str] = (),
        reqs_path: str = "",
    ) -> None:
        if isinstance(packages, str):
            packages = [packages] if packages else []
        self.packages: list[str] = list(packages)
        self.reqs_path = reqs_path
        if reqs_path:
            text = Path(reqs_path).read_text()
            for line in text.splitlines():
                line = line.strip()
                if line and not line.startswith("#"):
                    self.packages.append(line)

    def __repr__(self) -> str:
        return f"DepsPip({self.packages!r})"


class DepsCall:
    """A callable dependency: run ``fn(*args, **kwargs)`` on the worker."""

    def __init__(self, fn: Callable, args: tuple = (), kwargs: dict | None = None):
        self.fn = fn
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})

    def apply(self) -> Any:
        return self.fn(*self.args, **self.kwargs)


class DepsBash(DepsCall):
    """Shell commands run on the worker before the electron body.

    Upstream Covalent's ``ct.DepsBash(["apt list", ...])`` surface: each
    command runs under the worker's shell in the task's working directory;
    a non-zero exit fails the electron with the command's stderr.
    """

    def __init__(self, commands: str | Sequence[str] = ()):
        if isinstance(commands, str):
            commands = [commands] if commands else []
        self.commands: list[str] = list(commands)
        super().__init__(self._run_commands)

    def _run_commands(self) -> None:
        import subprocess

        for command in self.commands:
            proc = subprocess.run(
                command, shell=True, capture_output=True, text=True
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"DepsBash command failed ({command!r}, "
                    f"exit {proc.returncode}): {proc.stderr.strip()}"
                )

    def __repr__(self) -> str:
        return f"DepsBash({self.commands!r})"


def _as_calls(hooks: Iterable[Any]) -> list[DepsCall]:
    out: list[DepsCall] = []
    for hook in hooks or ():
        out.append(hook if isinstance(hook, DepsCall) else DepsCall(hook))
    return out


class _HookedTask:
    """Picklable wrapper running call_before/call_after around the body.

    Lives in the function pickle, so the hooks execute on whatever worker
    the executor chose — same machine as the electron body.
    """

    def __init__(
        self,
        fn: Callable,
        call_before: Sequence[DepsCall] = (),
        call_after: Sequence[DepsCall] = (),
    ) -> None:
        self.fn = fn
        self.call_before = list(call_before)
        self.call_after = list(call_after)
        self.__name__ = getattr(fn, "__name__", "electron")

    def __call__(self, *args, **kwargs):
        for dep in self.call_before:
            dep.apply()
        try:
            return self.fn(*args, **kwargs)
        finally:
            for dep in self.call_after:
                dep.apply()


def wrap_task(
    fn: Callable,
    call_before: Sequence[DepsCall],
    call_after: Sequence[DepsCall],
) -> Callable:
    """Wrap ``fn`` with hooks; identity when there are none."""
    if not call_before and not call_after:
        return fn
    return _HookedTask(fn, call_before, call_after)


# Workers need not have this package: serialise everything defined here by
# value, so _HookedTask/DepsCall unpickle standalone on the worker.
import sys as _sys  # noqa: E402

cloudpickle.register_pickle_by_value(_sys.modules[__name__])
