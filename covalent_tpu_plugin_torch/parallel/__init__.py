"""Parallelism layer: device meshes, logical shardings, collectives.

Counterpart of ``covalent_tpu_plugin/parallel/``: electrons scale *within* a
task over a gang of processes, one a device, joined by a
``torch.distributed`` process group that the harness opens from the task
spec's ``distributed`` block.  ``mesh`` names the axes, ``sharding`` maps a
model's logical axes onto them (FSDP2 over ``fsdp``, tensor parallelism over
``tensor``, replicas over ``seq``, each rank's part of the sequence from
``shard_batch``; ``logical_sharding`` and the like answer DTensor
placements), ``collectives`` runs the tiled collectives on one axis (the
ring permute and the all-to-all differentiable, for
``ops/ring_attention.py``), ``launch`` runs a function as a local gang, and
``probe`` says which collectives a backend carries on a device's tensors,
and ``pipeline`` runs the GPipe schedule over ``pipe``.
"""

# Lazy (PEP 562) re-exports: the dispatcher's control plane imports this
# package for ``coordinator_spec`` alone and must not pay for the rest.
import importlib

_EXPORTS = {
    "psum": ".collectives",
    "all_gather": ".collectives",
    "all_to_all": ".collectives",
    "reduce_scatter": ".collectives",
    "ring_permute": ".collectives",
    "coordinator_spec": ".distributed",
    "process_info": ".distributed",
    "MeshPlan": ".mesh",
    "auto_mesh": ".mesh",
    "make_mesh": ".mesh",
    "make_hybrid_mesh": ".mesh",
    "DEFAULT_RULES": ".sharding",
    "apply_rules": ".sharding",
    "batch_sharding": ".sharding",
    "logical_sharding": ".sharding",
    "param_shardings": ".sharding",
    "replicated": ".sharding",
    "shard_batch": ".sharding",
    "shard_batch_per_process": ".sharding",
    "process_local_slice": ".sharding",
    "pipelined": ".pipeline",
    "pipeline_apply": ".pipeline",
    "pipeline_stages": ".pipeline",
}


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(_EXPORTS[name], __name__)
        value = getattr(module, name)
        globals()[name] = value  # cache: later lookups skip __getattr__
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = [
    "MeshPlan",
    "auto_mesh",
    "make_mesh",
    "make_hybrid_mesh",
    "DEFAULT_RULES",
    "apply_rules",
    "logical_sharding",
    "param_shardings",
    "batch_sharding",
    "shard_batch",
    "shard_batch_per_process",
    "process_local_slice",
    "pipelined",
    "pipeline_apply",
    "pipeline_stages",
    "replicated",
    "psum",
    "all_gather",
    "all_to_all",
    "reduce_scatter",
    "ring_permute",
    "process_info",
    "coordinator_spec",
]
