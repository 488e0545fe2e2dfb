"""Logical-axis sharding rules, batch placement and parameter sharding.

Counterpart of ``covalent_tpu_plugin/parallel/sharding.py``.  A model names
the *logical* axes of each parameter (``"embed"``, ``"heads"``, ...; the LM's
``TransformerLM.param_logical_axes``); :data:`DEFAULT_RULES` maps them onto
the mesh axes of :mod:`.mesh`.  Where the reference lets XLA place every
collective, the port applies the rules with two tools
(:func:`apply_rules`):

* the ``tensor`` axis (``heads``, ``mlp``, ``vocab``): each parameter
  becomes a DTensor on ``mesh["tensor"]``, sharded on the dimension the
  rules name, and each module that holds one gets a :class:`TensorParallel`
  handle whose two
  regions (``parallel.collectives.copy_to_group`` / ``reduce_from_group``)
  the layers put around their products (Megatron's column and row
  parallelism).  The layers compute on the local shards as plain tensors,
  so the flash kernels see ``(B, H / tensor, S, D)``;
* the ``fsdp`` axis (``embed``) through FSDP2 ``fully_shard`` over
  ``mesh["fsdp"]``, or ``mesh["data", "fsdp"]`` (HSDP: replicas over
  ``data``) when both exceed 1.  FSDP2 shards dimension 0 of each
  parameter where the reference shards the ``embed`` dimension: the layouts
  differ, the math does not.

With ``fsdp`` 1 and ``data`` > 1 the replicas are plain data parallelism:
the train step averages the gradients over ``data``
(:func:`average_gradients`).  ``kv_heads`` (a GQA model's k/v projections)
is replicated over ``tensor``, as in the reference; each rank computes the
kv heads its query heads read, and the projections' gradients are summed
over ``tensor``.

The ``seq`` axis (sequence parallelism) shards activations, not
parameters: every parameter is replicated over it.  Each ``seq`` rank
takes its part of every sequence (:func:`shard_batch`: the inputs, the
labels cut from the globally shifted sequence, and the global positions of
its rows, contiguous or zigzag-striped) and the model's ring or Ulysses
attention (``ops/ring_attention.py``) joins the parts.  A rank's loss is a
mean over its S/n tokens and the ring's backward has already sent every
dK/dV partial to its owner, so the gradients are averaged over ``seq`` as
over ``data`` (:func:`average_gradients`, also under FSDP2, which averages
over ``fsdp`` only).

The ``pipe`` axis (GPipe, ``parallel/pipeline.py``) splits the layers: each
``pipe`` rank keeps its stage's (``TransformerLM.pipeline_parallel``), the
rest of the model stays whole on every rank.  It composes with ``data``
(each ``data`` rank pipelines its rows); ``fsdp``, ``tensor`` and ``seq``
inside a pipeline are not ported.  A model that routes tokens over the
global batch (the MoE's ``batch_parallel``) takes the mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .collectives import copy_to_group, reduce_from_group
from .mesh import mesh_plan

#: logical axis -> mesh axis (or None = replicated): activation batch over
#: the data axes, attention heads + MLP hidden + vocab over tensor, embed
#: over fsdp, activation sequence over seq.
DEFAULT_RULES: tuple[tuple[str, Any], ...] = (
    ("batch", ("data", "fsdp")),
    ("seq", "seq"),
    ("embed", "fsdp"),
    ("heads", "tensor"),
    # GQA kv projections: replicated across tensor shards (n_kv_heads is
    # typically smaller than the tensor axis, and kv weights are small).
    ("kv_heads", None),
    ("kv", None),
    # MoE: experts over tensor, the per-expert hidden dim unsharded.
    ("expert", "tensor"),
    ("expert_mlp", None),
    ("mlp", "tensor"),
    ("vocab", "tensor"),
    ("layers", None),
)


def _mesh_axes_for(logical_name: str | None, rules) -> Any:
    if logical_name is None:
        return None
    for name, mesh_axes in rules:
        if name == logical_name:
            return mesh_axes
    return None


def logical_spec(logical_axes: tuple[str | None, ...], rules=DEFAULT_RULES) -> tuple:
    """The mesh axes (a name, a tuple of names, or None) of each logical axis:
    the reference's PartitionSpec, as a tuple."""
    return tuple(_mesh_axes_for(name, rules) for name in logical_axes)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_sharding(mesh, logical_axes: tuple[str | None, ...], rules=DEFAULT_RULES) -> list:
    """DTensor placements on ``mesh`` (one per mesh axis) for a tensor whose
    dimensions carry ``logical_axes``: ``Shard(d)`` on each mesh axis the
    rules give dimension ``d``, ``Replicate()`` elsewhere.  A mesh axis
    named for two dimensions is refused, as a PartitionSpec refuses it."""
    from torch.distributed.tensor import Replicate, Shard

    by_axis: dict[str, int] = {}
    for dim, entry in enumerate(logical_spec(logical_axes, rules)):
        for axis in _axes(entry):
            if axis in by_axis:
                raise ValueError(f"mesh axis {axis!r} shards dimensions {by_axis[axis]} and {dim}")
            by_axis[axis] = dim
    return [Shard(by_axis[a]) if a in by_axis else Replicate() for a in mesh.mesh_dim_names]


def replicated(mesh) -> list:
    """Placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def batch_sharding(mesh, rules=DEFAULT_RULES) -> list:
    """Placements of a leading batch dimension (data × fsdp)."""
    return logical_sharding(mesh, ("batch",), rules)


def _batch_block(mesh, rules) -> tuple[int, int]:
    """(this rank's block, block count) of a batch split over the mesh axes
    the rules give ``batch``, the first axis outermost."""
    block, count = 0, 1
    for axis in _axes(_mesh_axes_for("batch", rules)):
        n = mesh[axis].size()
        block, count = block * n + mesh.get_local_rank(axis), count * n
    return block, count


def _device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _seq_cut(batch: Any, mesh, zigzag: bool) -> Any:
    """With ``seq`` > 1: this rank's part of a language-model batch
    ``{"tokens": (B, S + 1)}`` as ``{"tokens": inputs, "labels": labels,
    "positions": positions}``: the inputs and the labels (the sequence
    shifted by one, cut after the shift) at the global positions of this
    rank's rows, ``(B, S / seq)`` each, and those positions ((S / seq,)
    int64), contiguous or zigzag-striped (``ops.ring_attention``).  With
    ``seq`` 1 the batch as it is."""
    n = mesh["seq"].size()
    if n == 1:
        return batch
    from ..ops.ring_attention import sequence_positions

    if not isinstance(batch, dict) or set(batch) != {"tokens"}:
        raise ValueError(
            "a batch split over 'seq' is a language model's {'tokens': (B, S + 1)}, "
            f"got {sorted(batch) if isinstance(batch, dict) else type(batch).__name__}")
    tokens = torch.as_tensor(batch["tokens"])
    positions = sequence_positions(tokens.shape[1] - 1, n, mesh.get_local_rank("seq"), zigzag)
    index = torch.as_tensor(positions, dtype=torch.int64)
    return {"tokens": tokens[:, :-1][:, index], "labels": tokens[:, 1:][:, index],
            "positions": index}


def shard_batch(batch: Any, mesh, rules=DEFAULT_RULES, *, zigzag: bool = False) -> Any:
    """This rank's rows of a host-global batch, on the mesh's device.

    Every leaf's dim 0 is the batch, split over the batch axes (data ×
    fsdp) in mesh order: ranks that differ only on other axes (tensor) get
    the same rows.  Scalars come through whole.  Each rank holds the whole
    batch and keeps its block, the counterpart of the reference's
    ``device_put`` of a global array.

    With ``seq`` > 1 the batch is a language model's ``{"tokens": (B, S +
    1)}`` and each rank also keeps its part of the sequence
    (``{"tokens", "labels", "positions"}``, see :func:`_seq_cut`), striped
    when ``zigzag`` (the model's layout: ``TransformerLM.sequence_zigzag``).
    """
    block, count = _batch_block(mesh, rules)
    device = _device(mesh)

    def rows(x):
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        if x.dim() == 0:
            return x
        if x.shape[0] % count:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by the {count} batch shards")
        span = x.shape[0] // count
        return x[block * span:(block + 1) * span]

    batch = _seq_cut(_map(rows, batch), mesh, zigzag)
    return _map(lambda x: x.to(device), batch)


def shard_batch_per_process(local_batch: Any, mesh, rules=DEFAULT_RULES) -> Any:
    """Multi-process batch feeding: each process supplies only its rows.

    The counterpart of ``jax.make_array_from_process_local_data``: each rank
    drives one device, so its local batch is its shard of the global batch,
    and it is moved to the mesh's device as it is.  Ranks that share a batch
    block (tensor parallel peers) must pass the same rows; scalars must be
    equal on every rank.  The global batch is the concatenation of the
    blocks in the order of the batch axes.
    """
    device = _device(mesh)
    return _map(lambda x: torch.as_tensor(
        np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(device), local_batch)


def process_local_slice(batch: Any, axis: int = 0) -> Any:
    """This process's contiguous shard of a host-global batch (dim ``axis``).

    Process ``i`` of ``N`` owns rows ``[i*B/N, (i+1)*B/N)``; outside a
    process group, process 0 of 1 owns all of them.
    """
    from .distributed import process_info

    info = process_info()
    index, count = info.process_id, info.num_processes

    def cut(x):
        x = np.asarray(x)
        if x.ndim == 0:
            return x
        if x.shape[axis] % count:
            raise ValueError(
                f"batch dim {x.shape[axis]} not divisible by "
                f"process count {count}"
            )
        span = x.shape[axis] // count
        slicer = [slice(None)] * x.ndim
        slicer[axis] = slice(index * span, (index + 1) * span)
        return x[tuple(slicer)]

    return _map(cut, batch)


def param_shardings(model: torch.nn.Module, mesh=None, rules=DEFAULT_RULES) -> dict:
    """name -> the mesh axes of each dimension of that parameter (a tuple,
    None where a dimension is not sharded), from the model's logical axes
    (``model.param_logical_axes()``; a model without them replicates every
    parameter).  With a mesh, axes of extent 1 read None."""
    logical = getattr(model, "param_logical_axes", lambda: {})()
    out = {}
    for name, param in model.named_parameters():
        axes = logical.get(name, (None,) * param.dim())
        spec = logical_spec(axes, rules)
        if mesh is not None:
            spec = tuple(
                tuple(a for a in _axes(e) if mesh[a].size() > 1) or None for e in spec)
            spec = tuple(e[0] if e is not None and len(e) == 1 else e for e in spec)
        out[name] = spec
    return out


@dataclass(frozen=True)
class TensorParallel:
    """A module's handle on the ``tensor`` axis: its process group, this
    rank's index and the axis extent, and the two regions of Megatron's
    tensor parallelism."""

    group: Any
    rank: int
    size: int

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Before a column-parallel product: identity forward, the group's
        gradient sum backward."""
        return copy_to_group(x, self.group)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        """After a row-parallel product: the group's sum forward."""
        return reduce_from_group(x, self.group)

    def block(self, n: int) -> slice:
        """This rank's block of an axis of ``n`` split over the group."""
        if n % self.size:
            raise ValueError(f"an axis of {n} does not split over tensor={self.size}")
        span = n // self.size
        return slice(self.rank * span, (self.rank + 1) * span)


def _shard_on_tensor(module: torch.nn.Module, prefix: str, shardings: dict,
                     tp: TensorParallel, tensor_mesh) -> None:
    """Turn ``module``'s own parameters into DTensors on the tensor mesh,
    sharded where ``shardings`` says ``tensor``, replicated elsewhere."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    for name, param in list(module.named_parameters(recurse=False)):
        spec = shardings[f"{prefix}{name}"]
        dims = [d for d, e in enumerate(spec) if "tensor" in _axes(e)]
        local, placement = param.data, Replicate()
        if dims:
            (dim,) = dims
            local = local[(slice(None),) * dim + (tp.block(local.shape[dim]),)]
            placement = Shard(dim)
        dt = DTensor.from_local(local.contiguous(), tensor_mesh, [placement], run_check=False)
        module.register_parameter(name, torch.nn.Parameter(dt, param.requires_grad))


def apply_rules(model: torch.nn.Module, mesh, rules=DEFAULT_RULES) -> torch.nn.Module:
    """Shard ``model`` in place over ``mesh`` per the rules (module
    docstring); returns it.  Every rank of the mesh calls it on identical
    weights.  Parameters are replicated over ``seq``; each module that runs
    sequence-parallel attention takes the mesh (``sequence_parallel``), as
    does each that routes over the global batch (``batch_parallel``).  Over
    ``pipe`` the model keeps its stage's layers (``pipeline_parallel``)."""
    plan = mesh_plan(mesh)
    if plan.pipe > 1:
        if plan.fsdp > 1 or plan.tensor > 1 or plan.seq > 1:
            raise NotImplementedError(
                f"mesh {plan.sizes}: the pipeline composes with data only; fsdp, tensor "
                "and seq inside a pipeline stage are not ported")
        if not hasattr(model, "pipeline_parallel"):
            raise ValueError(f"{type(model).__name__} has no layers to split over pipe")
        model.pipeline_parallel(mesh)
    for module in model.modules():
        if hasattr(module, "sequence_parallel"):
            module.sequence_parallel(mesh)
        if hasattr(module, "batch_parallel"):
            module.batch_parallel(mesh)
    shardings = param_shardings(model, mesh, rules)
    if plan.tensor > 1:
        tp = TensorParallel(mesh.get_group("tensor"), mesh.get_local_rank("tensor"), plan.tensor)
        for owner, module in model.named_modules():
            _shard_on_tensor(module, f"{owner}." if owner else "", shardings, tp, mesh["tensor"])
            # each layer that puts regions around its products takes the handle
            if hasattr(module, "tensor_parallel"):
                module.tensor_parallel(tp)
    if plan.fsdp > 1:
        from torch.distributed.fsdp import fully_shard

        dp_mesh = mesh["data", "fsdp"] if plan.data > 1 else mesh["fsdp"]
        for unit in getattr(model, "fsdp_units", lambda: [])():
            fully_shard(unit, mesh=dp_mesh)
        fully_shard(model, mesh=dp_mesh)
    model.mesh = mesh
    return model


def average_gradients(model: torch.nn.Module, mesh) -> None:
    """Average every gradient over the axes whose ranks hold replicas of the
    parameters and see other tokens: ``data`` when the replicas are plain
    data parallelism (``fsdp`` 1; FSDP2 averages over ``data`` and ``fsdp``
    itself), and ``seq``.  One all-reduce of the flattened gradients (this
    rank's shards of them) on each such axis."""
    plan = mesh_plan(mesh)
    axes = [a for a, on in (("data", plan.data > 1 and plan.fsdp == 1), ("seq", plan.seq > 1))
            if on]
    if not axes:
        return
    grads = [_local(p.grad) for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat /= math.prod(mesh[a].size() for a in axes)
    for axis in axes:
        dist.all_reduce(flat, group=mesh.get_group(axis))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def batch_mean(value: torch.Tensor, mesh, rules=DEFAULT_RULES) -> torch.Tensor:
    """The mean of a per-rank value (a loss over the rank's rows and, under
    ``seq``, its part of the sequence) over the batch axes and ``seq``: the
    global mean when every rank holds as many tokens."""
    total, count = value.detach().float().clone(), 1
    for axis in _axes(_mesh_axes_for("batch", rules)) + ("seq",):
        n = mesh[axis].size()
        if n > 1:
            dist.all_reduce(total, group=mesh.get_group(axis))
            count *= n
    return total / count


def _local(t: torch.Tensor) -> torch.Tensor:
    """A parameter's local shard as a plain tensor (a DTensor's, under tensor
    parallelism); any other tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(tensors, mesh, stage_tensors=()) -> torch.Tensor:
    """The 2-norm of the whole of ``tensors`` (gradients, possibly DTensor
    shards) and ``stage_tensors`` (those of this rank's pipeline stage only):
    each shard's squares summed over the mesh axes that shard it, a stage's
    over ``pipe``, a replica counted once.  Every collective is an
    all-reduce."""
    from torch.distributed.tensor import DTensor

    partial: dict = {}
    for t in stage_tensors:
        entry = partial.setdefault(("pipe", ()), [[mesh.get_group("pipe")],
                                                  torch.zeros((), dtype=torch.float32,
                                                              device=t.device)])
        entry[1] = entry[1] + t.float().square().sum()
    for t in tensors:
        if isinstance(t, DTensor):
            if any(p.is_partial() for p in t.placements):
                raise ValueError(f"global_norm takes sharded or replicated tensors, not {t.placements}")
            # Shard and FSDP2's strided shard both split the tensor
            key = (id(t.device_mesh), tuple(
                i for i, p in enumerate(t.placements) if not p.is_replicate()))
            groups = [t.device_mesh.get_group(i) for i in key[1]]
            local = t.to_local()
        else:
            key, groups, local = (None, ()), [], t
        entry = partial.setdefault(key, [groups, torch.zeros((), dtype=torch.float32,
                                                             device=local.device)])
        entry[1] = entry[1] + local.float().square().sum()
    total = None
    for groups, sq in partial.values():
        for group in groups:
            dist.all_reduce(sq, group=group)
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return total.sqrt()
