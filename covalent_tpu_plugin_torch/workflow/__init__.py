"""Built-in minimal workflow layer of the port (own copy of
``covalent_tpu_plugin/workflow``).

Upstream Covalent carries these layers (``@ct.electron``/``@ct.lattice``,
``ct.dispatch``, ``ct.get_result``: ``tests/functional_tests/
basic_workflow_test.py:8-29``); this package runs standalone on machines
without a Covalent server, so it carries a small engine with the same
user-facing shape:

    import covalent_tpu_plugin_torch.workflow as ct

    @ct.electron(executor="gpu")
    def train(x): ...

    @ct.lattice
    def flow(x):
        return train(x)

    dispatch_id = ct.dispatch(flow)(x)
    result = ct.get_result(dispatch_id, wait=True)

With the real ``covalent`` package installed, use it instead: the
``GPUExecutor`` registers there via the entry point in ``setup.py``.
"""

from .dag import Electron, Lattice, Node, electron, lattice
from .deps import DepsBash, DepsCall, DepsPip
from .executors import LocalExecutor, register_executor, resolve_executor
from .runner import Result, Status, cancel, dispatch, get_result, dispatch_sync

__all__ = [
    "electron",
    "lattice",
    "dispatch",
    "dispatch_sync",
    "get_result",
    "cancel",
    "DepsBash",
    "DepsCall",
    "DepsPip",
    "Electron",
    "Lattice",
    "Node",
    "Result",
    "Status",
    "LocalExecutor",
    "register_executor",
    "resolve_executor",
]
