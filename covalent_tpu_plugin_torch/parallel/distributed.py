"""Multi-process bootstrap helpers.

Counterpart of ``covalent_tpu_plugin/parallel/distributed.py``.  The
harness makes the ``torch.distributed.init_process_group`` call from the
task spec's ``distributed`` block (``covalent_tpu_plugin_torch/harness.py``);
these helpers cover the two adjacent needs: electrons asking where they sit
in the gang, and executors building the per-process ``distributed`` blocks.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ProcessInfo:
    process_id: int
    num_processes: int
    local_device_count: int
    global_device_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def process_info() -> ProcessInfo:
    """Where am I in the gang?  Callable from inside any electron.

    Each rank drives one device (its card, or its CPU), so the gang's
    device count is its process count.  Outside a process group: process 0
    of 1.
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    return ProcessInfo(
        process_id=rank,
        num_processes=world,
        local_device_count=1,
        global_device_count=world,
    )


def coordinator_spec(
    workers: list[str] | None = None,
    port: int = 8476,
    *,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
) -> list[dict]:
    """Per-worker ``distributed`` spec blocks for the task spec files.

    By default worker 0's host is the rendezvous point; addresses may carry
    a ``user@`` prefix on the control plane which is stripped for the data
    plane.  The executor passes an explicit ``coordinator_address`` instead
    when the rendezvous host differs from the dial address (the local
    transport rendezvouses on 127.0.0.1).
    """
    if coordinator_address is None:
        if not workers:
            raise ValueError("coordinator_spec needs workers or coordinator_address")
        host = workers[0].split("@", 1)[-1]
        # Strip a :ssh-port suffix (host:2222) — the data plane dials its
        # own port; IPv6-style colon-bearing hosts pass through whole.
        front, sep, maybe_port = host.rpartition(":")
        if sep and maybe_port.isdigit() and ":" not in front:
            host = front
        coordinator_address = f"{host}:{port}"
    if num_processes is None:
        num_processes = len(workers or [])
    return [
        {
            "coordinator_address": coordinator_address,
            "num_processes": num_processes,
            "process_id": i,
        }
        for i in range(num_processes)
    ]
