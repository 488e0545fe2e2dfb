"""Electron/lattice decorators and DAG capture.

Own copy of ``covalent_tpu_plugin/workflow/dag.py``, the upstream Covalent
surface the reference tests use (``tests/functional_tests/
basic_workflow_test.py:8-22``): ``@electron`` marks a task and carries its
executor choice; ``@lattice`` marks the workflow function.  The DAG is
built by tracing: the lattice body runs once with real inputs, and each
electron call appends a :class:`Node` and returns a placeholder that
downstream electrons receive as a dependency edge.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from .deps import DepsBash, DepsCall, DepsPip, _as_calls, wrap_task


class Node:
    """Placeholder returned by an electron call during lattice tracing."""

    __slots__ = ("node_id", "name")

    def __init__(self, node_id: int, name: str):
        self.node_id = node_id
        self.name = name

    def __repr__(self) -> str:
        return f"<Node {self.node_id}:{self.name}>"


@dataclass
class NodeSpec:
    """One recorded electron invocation inside a lattice."""

    node_id: int
    fn: Callable
    args: tuple
    kwargs: dict
    executor: Any  # alias string or executor instance
    name: str
    deps_pip: DepsPip | None = None
    call_before: list[DepsCall] = field(default_factory=list)
    call_after: list[DepsCall] = field(default_factory=list)
    #: free-form electron metadata threaded into task_metadata; reserved
    #: runner keys (dispatch_id, node_id, pip_deps) win.
    metadata: dict = field(default_factory=dict)

    def dependencies(self) -> set[int]:
        deps: set[int] = set()

        def scan(value: Any) -> None:
            if isinstance(value, Node):
                deps.add(value.node_id)
            elif isinstance(value, (list, tuple, set)):
                for v in value:
                    scan(v)
            elif isinstance(value, dict):
                for v in value.values():
                    scan(v)

        scan(self.args)
        scan(self.kwargs)
        return deps


@dataclass
class Graph:
    """The traced DAG plus the lattice's (possibly Node-valued) return."""

    nodes: list[NodeSpec] = field(default_factory=list)
    output: Any = None


_trace_local = threading.local()


def _active_graph() -> Graph | None:
    return getattr(_trace_local, "graph", None)


class Electron:
    """A task function bound to an executor choice and its dependencies.

    Called inside a lattice trace it records a node; called directly it just
    runs (matching upstream Covalent's behaviour for bare electron calls).
    Dependencies mirror upstream's electron kwargs seen in the reference's
    ML workflow (``svm_workflow.py:16-19``): ``deps_pip`` plus
    ``call_before``/``call_after`` hooks, all executed on the worker.
    """

    def __init__(
        self,
        fn: Callable,
        executor: Any = "local",
        deps_pip: DepsPip | Sequence[str] | None = None,
        deps_bash: Any = None,
        call_before: Sequence[Any] = (),
        call_after: Sequence[Any] = (),
        metadata: dict | None = None,
    ):
        self.fn = fn
        self.executor = executor
        self.metadata = dict(metadata or {})
        if deps_pip is not None and not isinstance(deps_pip, DepsPip):
            deps_pip = DepsPip(packages=deps_pip)
        self.deps_pip = deps_pip
        if deps_bash is not None and not isinstance(deps_bash, DepsBash):
            deps_bash = DepsBash(deps_bash)
        # Bash deps are just call_before hooks that run shell commands.
        call_before = ([deps_bash] if deps_bash else []) + list(call_before)
        self.call_before = _as_calls(call_before)
        self.call_after = _as_calls(call_after)
        self.__name__ = getattr(fn, "__name__", "electron")
        self.__doc__ = fn.__doc__

    def __call__(self, *args, **kwargs):
        graph = _active_graph()
        if graph is None:
            return wrap_task(self.fn, self.call_before, self.call_after)(
                *args, **kwargs
            )
        node_id = len(graph.nodes)
        graph.nodes.append(
            NodeSpec(
                node_id=node_id,
                fn=self.fn,
                args=args,
                kwargs=kwargs,
                executor=self.executor,
                name=self.__name__,
                deps_pip=self.deps_pip,
                call_before=self.call_before,
                call_after=self.call_after,
                metadata=dict(self.metadata),
            )
        )
        return Node(node_id, self.__name__)


def electron(
    fn: Callable | None = None,
    *,
    executor: Any = "local",
    deps_pip: DepsPip | Sequence[str] | None = None,
    deps_bash: Any = None,
    call_before: Sequence[Any] = (),
    call_after: Sequence[Any] = (),
    metadata: dict | None = None,
) -> Any:
    """``@electron`` / ``@electron(executor="gpu", deps_pip=...)`` decorator."""

    def wrap(f: Callable) -> Electron:
        return Electron(
            f,
            executor=executor,
            deps_pip=deps_pip,
            deps_bash=deps_bash,
            call_before=call_before,
            call_after=call_after,
            metadata=metadata,
        )

    if fn is not None:
        return wrap(fn)
    return wrap


class Lattice:
    """A workflow function whose electron calls define a DAG."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.__name__ = getattr(fn, "__name__", "lattice")
        self.__doc__ = fn.__doc__

    def build_graph(self, *args, **kwargs) -> Graph:
        if _active_graph() is not None:
            raise RuntimeError("nested lattice tracing is not supported")
        graph = Graph()
        _trace_local.graph = graph
        try:
            graph.output = self.fn(*args, **kwargs)
        finally:
            _trace_local.graph = None
        return graph

    def __call__(self, *args, **kwargs):
        """Calling a lattice directly runs it eagerly (electrons execute
        in-process) — convenient for debugging, like upstream."""
        return self.fn(*args, **kwargs)


def lattice(fn: Callable) -> Lattice:
    """``@lattice`` decorator."""
    return Lattice(fn)
