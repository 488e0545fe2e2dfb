"""Device-mesh construction over ``torch.distributed``.

Counterpart of ``covalent_tpu_plugin/parallel/mesh.py``.  Axis convention
(order matters: outer axes map to the slower links first, inner axes to the
tighter ones):

* ``data``   — pure data parallelism (gradients averaged)
* ``fsdp``   — data parallelism with parameter sharding (FSDP2 gathers
  weights just in time); the batch is sharded over ``data × fsdp``
* ``tensor`` — Megatron-style tensor parallelism inside layers
* ``seq``    — sequence/context parallelism (ring and Ulysses attention,
  ``ops/ring_attention.py``)
* ``pipe``   — pipeline parallelism (GPipe, ``parallel/pipeline.py``)

A dimension of 1 stays in the mesh, as in the reference: one train-step
definition serves every plan.  Each rank of the process group drives one
device (its card, or its CPU), so the reference's "devices" are ranks here:
the mesh is a ``DeviceMesh`` whose entries are global ranks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

AXES = ("data", "fsdp", "tensor", "seq", "pipe")


@dataclass(frozen=True)
class MeshPlan:
    """A named factorisation of the device count over the standard axes."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    pipe: int = 1

    @property
    def sizes(self) -> dict[str, int]:
        return {
            "data": self.data,
            "fsdp": self.fsdp,
            "tensor": self.tensor,
            "seq": self.seq,
            "pipe": self.pipe,
        }

    def total(self) -> int:
        return self.data * self.fsdp * self.tensor * self.seq * self.pipe


def _ranks(devices) -> list[int]:
    """The global ranks a mesh may use: ``devices`` (ranks) or the whole
    process group, in rank order."""
    if devices is not None:
        return [int(d) for d in devices]
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialised process group (torch.distributed."
            "init_process_group; the harness does it for a gang electron)"
        )
    return list(range(dist.get_world_size()))


def _build(array: np.ndarray, device_type: str):
    """A DeviceMesh over ``array`` of ranks, with the standard axis names."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if array.size == dist.get_world_size() and \
            array.reshape(-1).tolist() == list(range(array.size)):
        return init_device_mesh(device_type, array.shape, mesh_dim_names=AXES)
    return DeviceMesh(device_type, torch.tensor(array, dtype=torch.int64), mesh_dim_names=AXES)


def make_mesh(plan: MeshPlan, devices=None, device_type: str = "cuda"):
    """Build a ``DeviceMesh`` laid out per ``plan``.

    ``devices`` are global ranks (default: every rank of the process group,
    in order); the first ``plan.total()`` are used, so the *innermost* axes
    get neighbouring ranks.  Every rank of the group must call this (it
    creates one process group per axis).
    """
    devices = _ranks(devices)
    if plan.total() > len(devices):
        raise ValueError(
            f"mesh plan {plan.sizes} needs {plan.total()} devices, got {len(devices)}"
        )
    array = np.array(devices[: plan.total()]).reshape(
        plan.data, plan.fsdp, plan.tensor, plan.seq, plan.pipe
    )
    return _build(array, device_type)


def make_hybrid_mesh(
    plan: MeshPlan,
    *,
    n_slices: int | None = None,
    dcn_axis: str = "data",
    devices=None,
    hosts: list[str] | None = None,
    device_type: str = "cuda",
):
    """Multi-host mesh: ``dcn_axis`` spans hosts, the rest stays inside one.

    The analog of the reference's multi-slice mesh for BASELINE config 5's
    2-worker story: collectives on the slow links between hosts should be
    the infrequent, bandwidth-light ones (the data axis's once-per-step
    gradient average), while tensor/seq/pipe collectives stay on one host.

    ``hosts`` names the host of each rank in ``devices``; ranks group by
    it.  Without topology (no ``hosts``, or every rank on one host) the
    ranks split into ``n_slices`` equal contiguous groups, the reference's
    path for meshes without slice information.  The ``dcn_axis`` extent must
    equal the group count, and every other axis must fit inside one group.
    """
    devices = _ranks(devices)
    ids = list(hosts) if hosts is not None else [None] * len(devices)
    if len(ids) != len(devices):
        raise ValueError(f"{len(ids)} hosts given for {len(devices)} devices")
    if any(i is None for i in ids) or len(set(ids)) == 1:
        if n_slices is None:
            raise ValueError(
                "devices expose no slice topology; pass n_slices explicitly"
            )
        if len(devices) % n_slices:
            raise ValueError(
                f"{len(devices)} devices not divisible into {n_slices} slices"
            )
        per_slice = len(devices) // n_slices
        groups = [
            devices[i * per_slice:(i + 1) * per_slice]
            for i in range(n_slices)
        ]
    else:
        keys = list(dict.fromkeys(ids))  # hosts in the order their ranks appear
        groups = [[d for d, i in zip(devices, ids) if i == k] for k in keys]
        if n_slices is not None and len(groups) != n_slices:
            raise ValueError(
                f"topology shows {len(groups)} slices, caller asked {n_slices}"
            )
        if len({len(g) for g in groups}) != 1:
            raise ValueError(
                f"unequal slice sizes {[len(g) for g in groups]}"
            )

    sizes = plan.sizes
    if dcn_axis not in sizes:
        raise ValueError(f"dcn_axis must be one of {AXES}, got {dcn_axis!r}")
    if sizes[dcn_axis] != len(groups):
        raise ValueError(
            f"dcn axis {dcn_axis!r}={sizes[dcn_axis]} must equal the slice "
            f"count {len(groups)}"
        )
    per_slice_total = plan.total() // len(groups)
    if per_slice_total > len(groups[0]):
        raise ValueError(
            f"plan needs {per_slice_total} devices per slice, "
            f"slices have {len(groups[0])}"
        )
    ici_shape = [sizes[a] if a != dcn_axis else 1 for a in AXES]
    stacked = np.stack(
        [np.array(g[:per_slice_total]).reshape(ici_shape) for g in groups],
        axis=AXES.index(dcn_axis),
    ).reshape([sizes[a] for a in AXES])
    return _build(stacked, device_type)


def auto_mesh(
    n_devices: int | None = None,
    *,
    tensor: int = 1,
    seq: int = 1,
    fsdp: int | None = None,
    devices=None,
    device_type: str = "cuda",
):
    """Pick a plan for ``n_devices`` and build the mesh.

    Model-parallel sizes (``tensor``, ``seq``) are explicit choices; the
    remaining factor goes to ``data``, unless an explicit ``fsdp`` size
    carves parameter-sharded data parallelism out of it.  The default,
    everything on ``data``, is the MNIST data-parallel BASELINE config.
    """
    devices = _ranks(devices)
    n = n_devices if n_devices is not None else len(devices)
    devices = devices[:n]
    if n % (tensor * seq) != 0:
        raise ValueError(f"{n} devices not divisible by tensor*seq={tensor * seq}")
    rest = n // (tensor * seq)
    if fsdp is None:
        data, fsdp_size = rest, 1
    else:
        if rest % fsdp != 0:
            raise ValueError(f"residual {rest} not divisible by fsdp={fsdp}")
        data, fsdp_size = rest // fsdp, fsdp
    plan = MeshPlan(data=data, fsdp=fsdp_size, tensor=tensor, seq=seq)
    return make_mesh(plan, devices, device_type=device_type)


def mesh_plan(mesh) -> MeshPlan:
    """The plan a mesh was built from (its extent on each axis)."""
    return MeshPlan(**{axis: mesh.size(i) for i, axis in enumerate(mesh.mesh_dim_names)})
