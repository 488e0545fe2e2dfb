"""Worker-side bootstrap: ``python harness.py <task_spec.json>``.

Counterpart of ``covalent_tpu_plugin/harness.py`` in launch mode.  The
executor ships this one file to the worker (it imports nothing of the
package), and the worker runs it detached: it applies the task's
environment, unpickles ``(fn, args, kwargs)``, runs the electron, moves
tensors in the result to host memory, and writes ``(result, exception)``
back as a pickle, which the dispatcher fetches.  Optionally it traces the
electron with ``torch.profiler``.

The spec keys of later slices (the distributed bootstrap, heartbeats, the
checkpointer, pip dependencies, resume, resident and RPC modes) are refused:
the electron does not run, and the error comes back as its exception.
"""

from __future__ import annotations

import json
import os
import sys

#: spec keys this harness understands
_SPEC_KEYS = {
    "operation_id", "function_file", "result_file", "workdir", "pid_file",
    "env", "profile_dir",
}


def _fallback_result(result_file: str, error: BaseException) -> None:
    """Best-effort ``(None, error)`` write with stdlib pickle, mirroring the
    reference's cloudpickle-ImportError path (``exec.py:16-24``)."""
    import pickle

    tmp = result_file + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump((None, error), f)
    os.replace(tmp, result_file)


def _to_host(tree):
    """Detached CPU copies of every tensor in ``tree`` (containers rebuilt),
    so the result unpickles on a machine without the card."""
    # A task that never imported torch cannot return tensors: skip the import.
    if "torch" not in sys.modules:
        return tree
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return type(tree)((key, _to_host(value)) for key, value in tree.items())
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_to_host(value) for value in tree)
    return tree


def _apply_spec_env(spec: dict) -> None:
    """Apply the task's env contract to THIS process: os.environ entries,
    a sys.path mirror for PYTHONPATH, and the ``CUDA_VISIBLE_DEVICES`` pin.

    The pin only takes effect before CUDA initialises in this process;
    a pin that arrives later is refused rather than silently ignored.
    """
    env = spec.get("env") or {}
    if "CUDA_VISIBLE_DEVICES" in env and "torch" in sys.modules:
        import torch

        if torch.cuda.is_initialized():
            raise RuntimeError(
                "CUDA_VISIBLE_DEVICES cannot change after CUDA initialised"
            )
    for key, value in env.items():
        os.environ[key] = str(value)
    if "PYTHONPATH" in env:
        # The interpreter already started; os.environ alone no longer affects
        # import resolution.  Mirror the entries into sys.path.
        for entry in reversed(str(env["PYTHONPATH"]).split(os.pathsep)):
            if entry and entry not in sys.path:
                sys.path.insert(0, entry)


def _start_profiler(profile_dir: str):
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str) -> None:
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def run_task(spec: dict) -> int:
    """Execute one staged task described by ``spec``.  Returns the exit code."""
    result_file = spec["result_file"]

    pid_file = spec.get("pid_file")
    if pid_file:
        # First thing, before any failure mode: the dispatcher's liveness
        # probe reads it.  Atomic write: never observed empty.
        tmp_pid = f"{pid_file}.tmp.{os.getpid()}"
        with open(tmp_pid, "w") as f:
            f.write(str(os.getpid()))
        os.replace(tmp_pid, pid_file)

    unsupported = sorted(set(spec) - _SPEC_KEYS)
    if unsupported:
        _fallback_result(result_file, NotImplementedError(
            f"task spec keys {unsupported} are not supported by this harness yet"
        ))
        return 1

    try:
        _apply_spec_env(spec)
        import cloudpickle as pickle
    except (ImportError, RuntimeError) as setup_error:
        _fallback_result(result_file, setup_error)
        return 1

    with open(spec["function_file"], "rb") as f:
        fn, args, kwargs = pickle.load(f)

    profile_dir = spec.get("profile_dir")
    profiler = _start_profiler(profile_dir) if profile_dir else None

    workdir = spec.get("workdir")
    current_dir = os.getcwd()
    result, exception = None, None
    try:
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            os.chdir(workdir)
        result = _to_host(fn(*args, **kwargs))
    except Exception as task_error:  # noqa: BLE001 - transported to dispatcher
        exception = task_error
    finally:
        os.chdir(current_dir)
        if profiler is not None:
            _stop_profiler(profiler, profile_dir)

    tmp = result_file + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump((result, exception), f)
    os.replace(tmp, result_file)
    return 0


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print("usage: harness.py <task_spec.json>", file=sys.stderr)
        return 2
    # Become a session/process-group leader: a kill of `-- -pid` then reaches
    # the electron's own subprocesses too.
    try:
        os.setsid()
    except OSError:
        pass  # already a leader
    with open(argv[1]) as f:
        spec = json.load(f)
    return run_task(spec)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
