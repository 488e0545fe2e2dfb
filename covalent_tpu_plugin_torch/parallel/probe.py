"""Which collectives a process-group backend carries on a device's tensors.

    python -m covalent_tpu_plugin_torch.parallel.probe [--world 2]
        [--device cuda] [--backend gloo]

A gang of ``world`` processes on this machine (``launch.run_gang``) runs
every collective the port's gang path issues, on tensors of ``device``, and
checks each result against its closed form.  The answer, per collective, is
ok or the error text; nothing is swapped for another road.  It decides the
backend of a gang whose ranks share one card: NCCL refuses two ranks on one
device, so such a gang runs over gloo with its tensors on the card.

The checks, in the order they run (a failure on one does not stop the
next; a backend that hangs on one hits the group's timeout):

* ``all_reduce`` (sum), ``all_reduce_avg`` (FSDP2's gradient average),
  ``all_reduce_max`` (the vocab-parallel loss);
* ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` (sum and avg):
  FSDP2's, and ``parallel.collectives``' ``all_gather``/``reduce_scatter``;
* ``all_to_all_single`` and ``ring_permute`` (``parallel.collectives``' ring
  shift: one ``all_to_all_single`` with uneven splits);
* ``device_mesh`` (``init_device_mesh`` over the gang) and ``fsdp2_step``
  (two FSDP2 layers, one forward, backward and SGD step, held against the
  same step on the whole batch in one process);
* last, the two that killed a rank on the H100 (gloo, torch 2.11), which
  the port's roads avoid: ``send_recv`` (a ring shift with
  ``batch_isend_irecv``: gloo writes the device pointer to its socket) and
  ``funcol_all_gather`` (the functional all-gather behind DTensor's
  ``full_tensor``: a segfault).

A check that kills a rank is recorded with the rank's last words, and a new
gang runs the checks after it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from .launch import run_gang


def _checks(device, rank: int, world: int) -> dict:
    """name -> a function that runs one collective and raises on a wrong result."""
    import torch
    import torch.distributed as dist

    def ramp(n, offset=0.0):
        return torch.arange(n, dtype=torch.float32, device=device) + offset

    def expect(got, want, what):
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"{what}: got {got.cpu().tolist()}, want {want.cpu().tolist()}")

    total = world * (world - 1) / 2  # sum of the ranks

    def all_reduce():
        x = ramp(4, rank)
        dist.all_reduce(x)
        expect(x, world * ramp(4) + total, "sum")

    def all_reduce_avg():
        x = ramp(4, rank)
        dist.all_reduce(x, op=dist.ReduceOp.AVG)
        expect(x, ramp(4) + total / world, "avg")

    def all_reduce_max():
        x = ramp(4, rank)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        expect(x, ramp(4, world - 1), "max")

    def all_gather_into_tensor():
        out = torch.empty(4 * world, device=device)
        dist.all_gather_into_tensor(out, ramp(4, rank))
        expect(out, torch.cat([ramp(4, r) for r in range(world)]), "gather")

    def scattered(scale):
        want = sum(ramp(4 * world, r) for r in range(world)) * scale
        return want[4 * rank:4 * (rank + 1)]

    def reduce_scatter_tensor():
        out = torch.empty(4, device=device)
        dist.reduce_scatter_tensor(out, ramp(4 * world, rank))
        expect(out, scattered(1.0), "reduce_scatter_tensor")

    def reduce_scatter_tensor_avg():
        out = torch.empty(4, device=device)
        dist.reduce_scatter_tensor(out, ramp(4 * world, rank), op=dist.ReduceOp.AVG)
        expect(out, scattered(1.0 / world), "reduce_scatter_tensor avg")

    def all_to_all_single():
        out = torch.empty(2 * world, device=device)
        dist.all_to_all_single(out, ramp(2 * world, 100 * rank))
        want = torch.cat([ramp(2 * world, 100 * r)[2 * rank:2 * rank + 2] for r in range(world)])
        expect(out, want, "all_to_all")

    def ring_permute():
        from torch.distributed.device_mesh import init_device_mesh

        from .collectives import ring_permute as port_ring_permute

        mesh = init_device_mesh(torch.device(device).type, (world,), mesh_dim_names=("data",))
        out = port_ring_permute(ramp(4, rank)[:, None], "data", mesh)[:, 0]
        expect(out, ramp(4, (rank - 1) % world), "ring shift")

    def device_mesh():
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh(torch.device(device).type, (world,), mesh_dim_names=("fsdp",))
        if mesh["fsdp"].size() != world:
            raise AssertionError(f"mesh size {mesh['fsdp'].size()}")

    def fsdp2_step():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        gen = torch.Generator().manual_seed(0)
        layers = [torch.randn(8, 8, generator=gen) for _ in range(2)]
        x = torch.randn(2 * world, 8, generator=gen)

        def net():
            model = torch.nn.Sequential(*(torch.nn.Linear(8, 8, bias=False) for _ in layers))
            with torch.no_grad():
                for lin, w in zip(model, layers):
                    lin.weight.copy_(w)
            return model.to(device)

        whole = net()
        whole(x.to(device)).square().mean().backward()
        torch.optim.SGD(whole.parameters(), lr=0.1).step()
        sharded = net()
        mesh = init_device_mesh(torch.device(device).type, (world,))
        for lin in sharded:
            fully_shard(lin, mesh=mesh)
        fully_shard(sharded, mesh=mesh)
        sharded(x[2 * rank:2 * rank + 2].to(device)).square().mean().backward()
        torch.optim.SGD(sharded.parameters(), lr=0.1).step()
        for a, b in zip(whole.parameters(), sharded.parameters()):
            local = b.to_local().detach().contiguous()
            full = torch.empty((world * local.shape[0], *local.shape[1:]), device=device)
            dist.all_gather_into_tensor(full, local)  # not full_tensor(): see the last check
            err = (a.detach().cpu() - full.cpu()).abs().max().item()
            if err > 1e-6:
                raise AssertionError(f"FSDP2 step off the one-process step by {err}")

    def send_recv():
        out = torch.empty(4, device=device)
        ops = [dist.P2POp(dist.isend, ramp(4, rank), (rank + 1) % world),
               dist.P2POp(dist.irecv, out, (rank - 1) % world)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        expect(out, ramp(4, (rank - 1) % world), "ring shift")

    def funcol_all_gather():
        import torch.distributed._functional_collectives as funcol

        out = funcol.all_gather_tensor(ramp(4, rank), 0, dist.group.WORLD)
        expect(out, torch.cat([ramp(4, r) for r in range(world)]), "functional gather")

    return {fn.__name__: fn for fn in (
        all_reduce, all_reduce_avg, all_reduce_max, all_gather_into_tensor,
        reduce_scatter_tensor, reduce_scatter_tensor_avg, all_to_all_single, ring_permute,
        device_mesh, fsdp2_step, send_recv, funcol_all_gather)}


#: the checks, in the order they run
CHECKS = (
    "all_reduce", "all_reduce_avg", "all_reduce_max", "all_gather_into_tensor",
    "reduce_scatter_tensor", "reduce_scatter_tensor_avg", "all_to_all_single",
    "ring_permute", "device_mesh", "fsdp2_step", "send_recv", "funcol_all_gather",
)


def _rank_checks(device: str, only: list, out_dir: str) -> None:
    """One rank: each check's start, then its result, as lines of its own
    file, written as they happen, so a rank the backend kills still says
    where it was."""
    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    with open(os.path.join(out_dir, f"rank{rank}.jsonl"), "a") as log:
        for name, check in _checks(device, rank, world).items():
            if name not in only:
                continue
            log.write(json.dumps({"name": name, "start": True}) + "\n")
            log.flush()
            try:
                check()
                if device == "cuda":
                    torch.cuda.synchronize()
                result = {"name": name, "ok": True}
            except Exception as err:  # noqa: BLE001 - the probe reports every failure
                result = {"name": name, "ok": False,
                          "error": f"{type(err).__name__}: {err}"[:400]}
            log.write(json.dumps(result) + "\n")
            log.flush()


def probe_collectives(world: int = 2, device: str = "cuda", backend: str = "gloo",
                      timeout_s: float = 300.0) -> dict:
    """Run the checks as gangs of ``world`` processes on this machine.

    Returns ``{"backend", "device", "world", "collectives": {name: {"ok":
    bool, "error"?: text, "killed_rank"?: True}}, "gangs", "seconds"}``: a
    check is ok when every rank checked its result.
    """
    start = time.perf_counter()
    pending, collectives, gangs = list(CHECKS), {}, 0
    while pending:
        gangs += 1
        remaining = timeout_s - (time.perf_counter() - start)
        if remaining <= 0:
            raise RuntimeError(f"collective probe ran out of time with {pending} left")
        with tempfile.TemporaryDirectory(prefix="probe_") as out_dir:
            crash = ""
            try:
                run_gang(_rank_checks, world, (device, pending, out_dir), device=device,
                         backend=backend, timeout_s=remaining)
            except RuntimeError as err:
                crash = str(err)[-400:]
            records = []
            for r in range(world):
                path = os.path.join(out_dir, f"rank{r}.jsonl")
                if os.path.exists(path):
                    with open(path) as f:
                        records.extend(json.loads(line) for line in f)
        started = {rec["name"] for rec in records if rec.get("start")}
        for name in list(pending):
            results = [rec for rec in records if rec["name"] == name and not rec.get("start")]
            if len(results) == world:
                collectives[name] = {"ok": all(r["ok"] for r in results)}
                errors = sorted({r["error"] for r in results if not r["ok"]})
                if errors:
                    collectives[name]["error"] = errors[0]
                pending.remove(name)
        if crash:
            # the first check a rank started and no rank finished killed it
            killed = next((name for name in pending if name in started), None)
            if killed is None:
                raise RuntimeError(f"probe gang failed before any check: {crash}")
            collectives[killed] = {"ok": False, "error": crash, "killed_rank": True}
            pending.remove(killed)
        elif pending:
            raise RuntimeError(f"probe gang ended without results for {pending}")
    return {"backend": backend, "device": device, "world": world,
            "collectives": {name: collectives[name] for name in CHECKS},
            "gangs": gangs, "seconds": time.perf_counter() - start}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default="gloo")
    args = parser.parse_args(argv)
    print(json.dumps(probe_collectives(args.world, args.device, args.backend)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
