"""Async DAG runner: ``dispatch`` / ``get_result``.

Own copy of ``covalent_tpu_plugin/workflow/runner.py``.  The upstream flow
the reference tests exercise is ``ct.dispatch(lattice)(args)`` ->
dispatch_id -> ``ct.get_result(id, wait=True)``
(``basic_workflow_test.py:23-24``), with independent electrons dispatched
concurrently.  Every node becomes an asyncio task that awaits its
dependency futures, so independent electrons' control-plane sessions
interleave on the event loop as the reference's async executor does.

Executor aliases are resolved once per dispatch and shared across that
dispatch's nodes, and the executors created from aliases are closed when
the dispatch ends.
"""

from __future__ import annotations

import asyncio
import os
import threading
import traceback
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable

from ..obs import events as obs_events
from ..obs.metrics import REGISTRY
from ..obs.trace import Span
from ..utils.log import app_log
from .dag import Graph, Lattice, Node
from .deps import wrap_task
from .executors import resolve_executor

_NODES_TOTAL = REGISTRY.counter(
    "covalent_tpu_workflow_nodes_total",
    "Workflow node terminal states",
    ("status",),
)
_DISPATCHES_TOTAL = REGISTRY.counter(
    "covalent_tpu_dispatches_total",
    "Workflow dispatch terminal states",
    ("status",),
)


class Status(str, Enum):
    NEW = "NEW"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"


@dataclass
class Result:
    """What ``get_result`` returns — shaped like Covalent's result object:
    ``.status``, ``.result``, ``.error`` (asserted at
    ``basic_workflow_test.py:25-31,46-49``)."""

    dispatch_id: str
    status: Status = Status.NEW
    result: Any = None
    error: str | None = None
    node_outputs: dict[int, Any] = field(default_factory=dict)
    node_errors: dict[int, str] = field(default_factory=dict)
    _done: threading.Event = field(default_factory=threading.Event, repr=False)
    # Cancellation plumbing: the dispatch's loop + per-node tasks/executors,
    # populated by _execute_graph (cancel() reaches in from another thread).
    _loop: Any = field(default=None, repr=False)
    _tasks: dict = field(default_factory=dict, repr=False)
    _node_executors: dict = field(default_factory=dict, repr=False)
    _cancelled: bool = field(default=False, repr=False)

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)


#: dispatch_id -> Result.  Bounded: under sustained traffic an unbounded
#: store leaks one Result (with node outputs) per dispatch forever, so
#: only the newest ``COVALENT_TPU_RESULT_RETENTION`` *terminal* results
#: are retained (insertion order = dispatch order); running dispatches are
#: never evicted.  ``get_result`` on an evicted id raises the same
#: ValueError an unknown id does.
_RESULTS: dict[str, Result] = {}
_RESULTS_LOCK = threading.Lock()
_RESULT_RETENTION_ENV = "COVALENT_TPU_RESULT_RETENTION"
_DEFAULT_RESULT_RETENTION = 256

_RESULTS_EVICTED = REGISTRY.counter(
    "covalent_tpu_results_evicted_total",
    "Terminal dispatch Results evicted from the in-memory store",
)


def _result_retention() -> int:
    """Read at eviction time so embedders/tests can retune a live process."""
    try:
        return max(1, int(
            os.environ.get(_RESULT_RETENTION_ENV, _DEFAULT_RESULT_RETENTION)
        ))
    except ValueError:
        return _DEFAULT_RESULT_RETENTION


def _retain_terminal_results() -> None:
    """Evict oldest terminal Results beyond the retention bound."""
    limit = _result_retention()
    with _RESULTS_LOCK:
        terminal = [
            dispatch_id
            for dispatch_id, result in _RESULTS.items()
            if result._done.is_set()
        ]
        for dispatch_id in terminal[: max(0, len(terminal) - limit)]:
            del _RESULTS[dispatch_id]
            _RESULTS_EVICTED.inc()


class _DependencyFailed(Exception):
    """Raised inside a node task whose upstream dependency failed — marks the
    node as skipped, not failed, so errors aren't misattributed downstream."""


def _resolve_value(value: Any, outputs: dict[int, Any]) -> Any:
    """Substitute Node placeholders with their computed outputs."""
    if isinstance(value, Node):
        return outputs[value.node_id]
    if isinstance(value, list):
        return [_resolve_value(v, outputs) for v in value]
    if isinstance(value, tuple):
        return tuple(_resolve_value(v, outputs) for v in value)
    if isinstance(value, set):
        return {_resolve_value(v, outputs) for v in value}
    if isinstance(value, dict):
        return {k: _resolve_value(v, outputs) for k, v in value.items()}
    return value


async def _execute_graph(graph: Graph, result: Result) -> None:
    dispatch_id = result.dispatch_id
    futures: dict[int, asyncio.Future] = {}
    executors: dict[Any, Any] = {}
    created: list[Any] = []
    #: in-flight connection prewarms (reaped before executor close).
    prewarm_tasks: set[asyncio.Task] = set()

    def executor_for(spec: Any) -> Any:
        key = spec if isinstance(spec, str) else id(spec)
        if key not in executors:
            instance = resolve_executor(spec)
            executors[key] = instance
            if isinstance(spec, str):
                created.append(instance)
        return executors[key]

    def node_event(spec, state: str, **fields) -> None:
        obs_events.emit(
            "node.state",
            dispatch_id=dispatch_id,
            node_id=spec.node_id,
            node=getattr(spec.fn, "__name__", str(spec.fn)),
            state=state,
            **fields,
        )

    async def run_node(spec) -> Any:
        deps = spec.dependencies()
        if deps:
            # DAG-driven prewarm: this node is blocked on upstream nodes,
            # which is when an executor that can warm its workers ahead
            # (a ``prewarm`` method) does so for free.  Best-effort; errors
            # never touch the node.
            prewarmer = getattr(executor_for(spec.executor), "prewarm", None)
            if prewarmer is not None:
                task = asyncio.ensure_future(prewarmer())
                prewarm_tasks.add(task)
                task.add_done_callback(prewarm_tasks.discard)
            dep_results = await asyncio.gather(
                *(futures[d] for d in deps), return_exceptions=True
            )
            failed = [d for d, r in zip(deps, dep_results) if isinstance(r, BaseException)]
            if failed:
                _NODES_TOTAL.labels(status="skipped").inc()
                node_event(spec, "skipped", upstream_failed=sorted(failed))
                raise _DependencyFailed(f"upstream node(s) {sorted(failed)} failed")
        args = _resolve_value(list(spec.args), result.node_outputs)
        kwargs = _resolve_value(dict(spec.kwargs), result.node_outputs)
        executor = executor_for(spec.executor)
        result._node_executors[spec.node_id] = executor
        # Electron metadata rides to the executor.  Runner-managed keys are
        # filtered out: pip_deps is DepsPip's contract (metadata must not
        # smuggle worker-side pip installs), and dispatch/node identity is
        # never user-writable.
        task_metadata = {
            **{
                key: value
                for key, value in (
                    getattr(spec, "metadata", None) or {}
                ).items()
                if key not in ("dispatch_id", "node_id", "pip_deps")
            },
            "dispatch_id": dispatch_id,
            "node_id": spec.node_id,
        }
        if spec.deps_pip and spec.deps_pip.packages:
            # Installed by the worker harness *before* unpickling the task
            # (the pickle may import the dependency), reference ct.DepsPip
            # usage at svm_workflow.py:19.
            task_metadata["pip_deps"] = list(spec.deps_pip.packages)
        fn = wrap_task(spec.fn, spec.call_before, spec.call_after)
        node_event(spec, "running")

        def retry_fields() -> dict:
            # An executor that retries exposes per-operation attempt counts
            # (``attempts_of``); the terminal node event carries them.
            getter = getattr(executor, "attempts_of", None)
            if getter is None:
                return {}
            attempts = getter(f"{dispatch_id}_{spec.node_id}")
            return {"attempts": attempts} if attempts > 1 else {}

        try:
            with Span(
                "workflow.node",
                {"dispatch_id": dispatch_id, "node_id": spec.node_id,
                 "node": getattr(spec.fn, "__name__", str(spec.fn))},
            ):
                output = await executor.run(fn, args, kwargs, task_metadata)
        except asyncio.CancelledError:
            _NODES_TOTAL.labels(status="cancelled").inc()
            node_event(spec, "cancelled", **retry_fields())
            raise
        except BaseException as err:
            _NODES_TOTAL.labels(status="failed").inc()
            node_event(spec, "failed", error=repr(err), **retry_fields())
            raise
        _NODES_TOTAL.labels(status="completed").inc()
        node_event(spec, "completed", **retry_fields())
        result.node_outputs[spec.node_id] = output
        return output

    # Dispatch root span: node tasks are created below with this span
    # active, so their context copies parent every workflow.node (and the
    # executor.run trees under them) to one trace per dispatch.
    dispatch_span = Span(
        "workflow.dispatch",
        {"dispatch_id": dispatch_id, "num_nodes": len(graph.nodes)},
    )
    dispatch_span.__enter__()
    obs_events.emit(
        "dispatch.state",
        dispatch_id=dispatch_id,
        state="running",
        num_nodes=len(graph.nodes),
        trace_id=dispatch_span.trace_id,
    )
    try:
        loop = asyncio.get_running_loop()
        result._loop = loop
        if result._cancelled:
            # Cancelled before the loop even started (ct.cancel immediately
            # after ct.dispatch): never launch any electron.
            result.status = Status.CANCELLED
            result.error = "dispatch cancelled"
            return
        for spec in graph.nodes:
            futures[spec.node_id] = loop.create_task(run_node(spec))
        result._tasks = dict(futures)
        node_results = await asyncio.gather(*futures.values(), return_exceptions=True)

        failed = False
        for spec, node_result in zip(graph.nodes, node_results):
            if isinstance(node_result, BaseException):
                if isinstance(node_result, (_DependencyFailed, asyncio.CancelledError)):
                    continue  # skipped, not failed — real error sits upstream
                failed = True
                result.node_errors[spec.node_id] = "".join(
                    traceback.format_exception(node_result)
                )
        if result._cancelled:
            result.status = Status.CANCELLED
            result.error = result.error or "dispatch cancelled"
        elif failed:
            result.status = Status.FAILED
            result.error = "\n".join(result.node_errors.values())
        else:
            result.result = _resolve_value(graph.output, result.node_outputs)
            result.status = Status.COMPLETED
    except Exception as err:  # noqa: BLE001 - engine-level failure
        result.status = Status.FAILED
        result.error = "".join(traceback.format_exception(err))
        app_log.error("dispatch %s failed: %s", dispatch_id, err)
    finally:
        # Reap prewarms before closing executors: a dial racing its own
        # pool teardown would leak the fresh transport.
        for task in list(prewarm_tasks):
            task.cancel()
        if prewarm_tasks:
            await asyncio.gather(*prewarm_tasks, return_exceptions=True)
        for instance in created:
            closer = getattr(instance, "close", None)
            if closer is not None:
                try:
                    await closer()
                except Exception:  # noqa: BLE001
                    pass
        status = result.status.value
        dispatch_span.set_attribute("status", status)
        if result.status not in (Status.COMPLETED, Status.NEW):
            dispatch_span.record_error(status)
        dispatch_span.end()
        _DISPATCHES_TOTAL.labels(status=status.lower()).inc()
        obs_events.emit(
            "dispatch.state",
            dispatch_id=dispatch_id,
            state=status,
            trace_id=dispatch_span.trace_id,
            **({"error": result.error} if result.error else {}),
        )
        result._done.set()
        _retain_terminal_results()


_LOOP_LOCK = threading.Lock()
_LOOP: Any = None


def _dispatcher_loop() -> asyncio.AbstractEventLoop:
    """The ONE long-lived event loop all dispatches share.

    A per-dispatch loop breaks persistent executors: a ``GPUExecutor``'s
    pool agents (``use_agent="pool"``) are bound to the loop that made
    them, so the second lattice through the same executor would find them
    on a dead loop.  The loop is the standalone stand-in for the Covalent
    server process.
    """
    global _LOOP
    with _LOOP_LOCK:
        if _LOOP is None or _LOOP.is_closed():
            loop = asyncio.new_event_loop()
            threading.Thread(
                target=loop.run_forever, name="covalent-gpu-dispatcher", daemon=True
            ).start()
            _LOOP = loop
            if os.environ.get("COVALENT_TPU_OPS_PORT"):
                app_log.warning(
                    "COVALENT_TPU_OPS_PORT is set, but this package has no ops "
                    "endpoint yet: it comes with slice 5b"
                )
        return _LOOP


def dispatch(lattice: Lattice) -> Callable[..., str]:
    """``dispatch(lattice)(*args, **kwargs) -> dispatch_id`` (non-blocking)."""

    def submit(*args, **kwargs) -> str:
        dispatch_id = str(uuid.uuid4())
        graph = lattice.build_graph(*args, **kwargs)
        result = Result(dispatch_id=dispatch_id, status=Status.RUNNING)
        with _RESULTS_LOCK:
            _RESULTS[dispatch_id] = result
        asyncio.run_coroutine_threadsafe(
            _execute_graph(graph, result), _dispatcher_loop()
        )
        return dispatch_id

    return submit


def dispatch_sync(lattice: Lattice) -> Callable[..., Result]:
    """Convenience: dispatch and block until the Result is final."""

    def submit(*args, **kwargs) -> Result:
        return get_result(dispatch(lattice)(*args, **kwargs), wait=True)

    return submit


def cancel(dispatch_id: str, timeout: float = 30.0) -> Result:
    """Cancel a running dispatch: kill remote tasks, mark CANCELLED.

    Upstream Covalent exposes ``ct.cancel(dispatch_id)``: each running
    node's executor kills its remote process group, then the node task is
    cancelled on the dispatch loop.

    Scope: executors with a ``cancel`` method (GPUExecutor) have their
    worker-side processes killed.  An in-process LocalExecutor electron
    cannot be interrupted mid-body (a Python thread is not killable); its
    output is discarded and the dispatch still reports CANCELLED promptly.
    """
    import time as _time

    result = get_result(dispatch_id)
    if result.status is not Status.RUNNING:
        return result
    result._cancelled = True  # _execute_graph honors this even pre-loop

    # The dispatch thread may not have entered its event loop yet
    # (cancel immediately after dispatch); give it a moment.
    deadline = _time.monotonic() + min(timeout, 5.0)
    while result._loop is None and not result._done.is_set():
        if _time.monotonic() > deadline:
            break
        _time.sleep(0.01)
    loop = result._loop
    if loop is None or result._done.is_set():
        result.wait(timeout)
        return result

    async def do_cancel() -> None:
        for node_id, task in result._tasks.items():
            if task.done():
                continue
            executor = result._node_executors.get(node_id)
            canceller = getattr(executor, "cancel", None)
            if canceller is not None:
                try:
                    await canceller(f"{dispatch_id}_{node_id}")
                except Exception as err:  # noqa: BLE001 - best-effort kill
                    app_log.warning(
                        "cancel %s node %s: %s", dispatch_id, node_id, err
                    )
            task.cancel()

    try:
        future = asyncio.run_coroutine_threadsafe(do_cancel(), loop)
        future.result(timeout)
    except RuntimeError:
        pass  # loop closed between the check and the call: dispatch finished
    except TimeoutError:
        app_log.warning("cancel %s: remote kill timed out", dispatch_id)
    result.wait(timeout)
    return result


def get_result(
    dispatch_id: str, wait: bool = False, timeout: float | None = None
) -> Result:
    """Fetch a dispatch's Result; with ``wait=True`` block until final
    (``ct.get_result(dispatch_id, wait=True)``, basic_workflow_test.py:24)."""
    try:
        with _RESULTS_LOCK:
            result = _RESULTS[dispatch_id]
    except KeyError:
        raise ValueError(f"unknown dispatch_id {dispatch_id!r}") from None
    if wait:
        finished = result.wait(timeout)
        if not finished:
            raise TimeoutError(
                f"dispatch {dispatch_id} not finished within {timeout}s"
            )
    return result
