"""Run a function as a gang of processes on this machine.

    results = run_gang(fn, world=2, args=(...), device="cpu")

Each rank is a fresh interpreter (``python -m
covalent_tpu_plugin_torch.parallel.launch``) that joins one process group
(rendezvous on a ``file://`` store in a private directory, so concurrent
gangs never share a port), runs ``fn(*args, **kwargs)`` and hands its value
back.  ``fn`` travels by cloudpickle: a module registered with
``cloudpickle.register_pickle_by_value`` ships its functions by value, so a
rank imports only what the function itself needs.

It is the in-process counterpart of a gang electron (``GPUExecutor(workers=
[...])`` runs the same bootstrap through the harness): the tests drive the
parallel layer with it, one rank per CPU.  A rank that fails (or a gang
that outlives ``timeout_s``) kills the others and raises with its error.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

#: the process group's timeout inside a rank: a collective that never
#: completes (a peer died) fails instead of hanging
GROUP_TIMEOUT_S = 120


def run_gang(fn, world: int, args: tuple = (), kwargs: dict | None = None, *,
             device: str = "cpu", backend: str = "gloo", timeout_s: float = 300.0) -> list:
    """``fn``'s value on each of ``world`` ranks, in rank order."""
    import cloudpickle

    with tempfile.TemporaryDirectory(prefix="gang_") as tmp:
        payload = os.path.join(tmp, "fn.pkl")
        with open(payload, "wb") as f:
            cloudpickle.dump((fn, tuple(args), dict(kwargs or {})), f)
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "covalent_tpu_plugin_torch.parallel.launch", payload,
             str(r), str(world), f"file://{tmp}/store", device, backend],
            stdout=logs[r], stderr=subprocess.STDOUT, env=env,
        ) for r in range(world)]
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            pending = set(range(world))
            while pending and failed is None:
                for r in sorted(pending):
                    code = procs[r].poll()
                    if code is not None:
                        pending.discard(r)
                        if code != 0:
                            failed = (r, f"exited {code}")
                            break
                if pending and failed is None:
                    if time.monotonic() > deadline:
                        failed = (min(pending), f"did not finish in {timeout_s} s")
                    time.sleep(0.05)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        if failed is not None:
            rank, why = failed
            logs[rank].seek(0)
            tail = logs[rank].read()[-4000:]
            for log in logs:
                log.close()
            raise RuntimeError(f"gang rank {rank} of {world} {why}:\n{tail}")
        for log in logs:
            log.close()
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                results.append(cloudpickle.load(f))
        return results


def _rank_main(payload: str, rank: int, world: int, init_method: str, device: str,
               backend: str) -> int:
    from datetime import timedelta

    import cloudpickle
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the gang asked for the card and this rank finds none")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    with open(payload, "rb") as f:
        fn, args, kwargs = cloudpickle.load(f)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        value = fn(*args, **kwargs)
    finally:
        dist.destroy_process_group()
    out = os.path.join(os.path.dirname(payload), f"out{rank}.pkl")
    with open(out + ".tmp", "wb") as f:
        cloudpickle.dump(value, f)
    os.replace(out + ".tmp", out)
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                        sys.argv[5], sys.argv[6]))
