"""The port's parallel layer against the reference's, on the CPU.

``covalent_tpu_plugin_torch.parallel`` runs over a ``torch.distributed``
process group: here one gang of 4 processes (gloo, one rank a CPU,
``parallel.launch.run_gang``) builds the meshes and runs every collective,
and the test process holds each rank's result against the reference's
``shard_map`` on the virtual CPU mesh of the same plan, from the same numpy
inputs: exactly for integers, at atol 1e-6 for float sums.  The mesh
layouts (which rank sits at which coordinate), the refusals' texts and
``coordinator_spec`` must equal the reference's.
"""

import sys

import cloudpickle
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from covalent_tpu_plugin.parallel import collectives as jax_coll
from covalent_tpu_plugin.parallel import mesh as jax_mesh
from covalent_tpu_plugin.parallel.distributed import coordinator_spec as jax_coordinator_spec
from covalent_tpu_plugin.parallel.sharding import process_local_slice as jax_local_slice
from covalent_tpu_plugin_torch import parallel
from covalent_tpu_plugin_torch.parallel import mesh as torch_mesh
from covalent_tpu_plugin_torch.parallel.distributed import coordinator_spec
from covalent_tpu_plugin_torch.parallel.launch import run_gang

WORLD = 4
SUM_ATOL = 1e-6

#: (name, plan) of the meshes the gang builds with make_mesh
PLANS = {
    "fsdp2_tensor2": dict(fsdp=2, tensor=2),
    "data4": dict(data=4),
    "data2_tensor2": dict(data=2, tensor=2),
    "tensor2_seq2": dict(tensor=2, seq=2),
}

#: (plan, mesh axis) of the collectives
AXIS_CASES = [("fsdp2_tensor2", "fsdp"), ("fsdp2_tensor2", "tensor"), ("data4", "data")]

#: name -> (input kind, the port's function of (x, axis, mesh))
PORT = {
    "psum": ("float", lambda x, a, m: parallel.psum(x, a, m)),
    "psum_int": ("int", lambda x, a, m: parallel.psum(x, a, m)),
    "all_gather": ("int", lambda x, a, m: parallel.all_gather(x, a, m)),
    "all_gather_axis1": ("int", lambda x, a, m: parallel.all_gather(x, a, m, axis=1)),
    "all_gather_untiled": ("int", lambda x, a, m: parallel.all_gather(x, a, m, tiled=False)),
    "reduce_scatter": ("float", lambda x, a, m: parallel.reduce_scatter(x, a, m)),
    "reduce_scatter_axis1": ("float", lambda x, a, m: parallel.reduce_scatter(x, a, m, axis=1)),
    "all_to_all": ("int", lambda x, a, m: parallel.all_to_all(x, a, m, split_axis=1,
                                                              concat_axis=0)),
    "all_to_all_back": ("int", lambda x, a, m: parallel.all_to_all(x, a, m, split_axis=0,
                                                                   concat_axis=1)),
    "ring_permute": ("int", lambda x, a, m: parallel.ring_permute(x, a, m)),
    "ring_permute_back": ("int", lambda x, a, m: parallel.ring_permute(x, a, m, shift=-1)),
}

#: name -> the reference's function of (x, axis), inside shard_map
REFERENCE = {
    "psum": lambda x, a: jax_coll.psum(x, a),
    "psum_int": lambda x, a: jax_coll.psum(x, a),
    "all_gather": lambda x, a: jax_coll.all_gather(x, a),
    "all_gather_axis1": lambda x, a: jax_coll.all_gather(x, a, axis=1),
    "all_gather_untiled": lambda x, a: jax_coll.all_gather(x, a, tiled=False),
    "reduce_scatter": lambda x, a: jax_coll.reduce_scatter(x, a),
    "reduce_scatter_axis1": lambda x, a: jax_coll.reduce_scatter(x, a, axis=1),
    "all_to_all": lambda x, a: jax_coll.all_to_all(x, a, split_axis=1, concat_axis=0),
    "all_to_all_back": lambda x, a: jax_coll.all_to_all(x, a, split_axis=0, concat_axis=1),
    "ring_permute": lambda x, a: jax_coll.ring_permute(x, a),
    "ring_permute_back": lambda x, a: jax_coll.ring_permute(x, a, shift=-1),
}


#: logical axes whose DTensor placements the gang reports
LOGICAL_CASES = [("heads", "embed"), ("embed", "mlp"), ("vocab", "embed"),
                 ("batch", "seq", "heads"), ("kv_heads", "embed")]


def _input(kind: str, rank: int) -> np.ndarray:
    """Rank ``rank``'s local (4, 8) input: the same bytes in both packages."""
    rng = np.random.default_rng(1000 + rank)
    if kind == "int":
        return rng.integers(-50, 50, size=(4, 8)).astype(np.int32)
    return rng.standard_normal((4, 8)).astype(np.float32)


def _gang_body():
    """One rank of the gang: every mesh, collective and batch placement."""
    import numpy as np
    import torch

    from covalent_tpu_plugin_torch import parallel
    from covalent_tpu_plugin_torch.parallel import mesh as tm
    from covalent_tpu_plugin_torch.parallel import sharding

    out = {"meshes": {}, "collectives": {}, "rows": {}}
    meshes = {name: tm.make_mesh(tm.MeshPlan(**plan), device_type="cpu")
              for name, plan in PLANS.items()}
    meshes["auto_tensor2"] = tm.auto_mesh(tensor=2, device_type="cpu")
    meshes["auto_fsdp2"] = tm.auto_mesh(fsdp=2, device_type="cpu")
    meshes["hybrid"] = tm.make_hybrid_mesh(tm.MeshPlan(data=2, tensor=2), n_slices=2,
                                           device_type="cpu")
    for name, mesh in meshes.items():
        out["meshes"][name] = {"names": mesh.mesh_dim_names, "ranks": mesh.mesh.tolist()}
    rank = torch.distributed.get_rank()
    for plan_name, axis in AXIS_CASES:
        mesh = meshes[plan_name]
        out["collectives"][(plan_name, axis, "axis_index")] = parallel.collectives.axis_index(
            axis, mesh)
        out["collectives"][(plan_name, axis, "axis_size")] = parallel.collectives.axis_size(
            axis, mesh)
        for name, (kind, port_fn) in PORT.items():
            x = torch.from_numpy(_input(kind, rank))
            out["collectives"][(plan_name, axis, name)] = port_fn(x, axis, mesh).numpy()
    batch = {"tokens": np.arange(8 * 3).reshape(8, 3), "step": np.int64(7)}
    for name in ("fsdp2_tensor2", "data4", "data2_tensor2"):
        placed = sharding.shard_batch(batch, meshes[name])
        out["rows"][name] = (placed["tokens"].numpy(), int(placed["step"]))
    out["rows"]["process_local_slice"] = sharding.process_local_slice(batch)["tokens"]
    local = sharding.shard_batch_per_process({"x": np.full((2, 3), rank)}, meshes["data4"])
    out["rows"]["per_process"] = local["x"].numpy()
    mesh = meshes["data2_tensor2"]
    out["placements"] = {axes: [str(p) for p in sharding.logical_sharding(mesh, axes)]
                         for axes in LOGICAL_CASES}
    out["placements"]["batch"] = [str(p) for p in sharding.batch_sharding(mesh)]
    out["placements"]["replicated"] = [str(p) for p in sharding.replicated(mesh)]
    return out


@pytest.fixture(scope="module")
def gang():
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        return run_gang(_gang_body, WORLD, timeout_s=240)
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


def _reference_mesh(plan: dict):
    return jax_mesh.make_mesh(jax_mesh.MeshPlan(**plan), jax.devices()[:WORLD])


def _device_ids(mesh) -> list:
    return np.vectorize(lambda d: d.id)(mesh.devices).tolist()


def _reference_per_rank(plan: dict, fn, inputs: list) -> list:
    """``fn`` under shard_map on the reference's mesh of ``plan``: rank r's
    input at the mesh coordinate of device r; each rank's output."""
    mesh = _reference_mesh(plan)
    shape = tuple(mesh.devices.shape)
    stacked = np.stack(inputs).reshape(shape + inputs[0].shape)
    lead = (1,) * len(shape)

    def body(block):
        y = fn(block.reshape(block.shape[len(shape):]))
        return y.reshape(lead + y.shape)

    spec = P(*jax_mesh.AXES)
    out = np.asarray(jax.shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec,
                                   check_vma=False)(stacked))
    return [out[np.unravel_index(r, shape)] for r in range(len(inputs))]


# -- meshes ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(PLANS))
def test_make_mesh_layout_equals_the_reference(gang, name):
    for rank_out in gang:
        got = rank_out["meshes"][name]
        assert got["names"] == jax_mesh.AXES
        assert got["ranks"] == _device_ids(_reference_mesh(PLANS[name]))


@pytest.mark.parametrize("name, reference", [
    ("auto_tensor2", lambda d: jax_mesh.auto_mesh(tensor=2, devices=d)),
    ("auto_fsdp2", lambda d: jax_mesh.auto_mesh(fsdp=2, devices=d)),
    ("hybrid", lambda d: jax_mesh.make_hybrid_mesh(jax_mesh.MeshPlan(data=2, tensor=2),
                                                   n_slices=2, devices=d)),
])
def test_auto_and_hybrid_mesh_layouts_equal_the_reference(gang, name, reference):
    want = _device_ids(reference(jax.devices()[:WORLD]))
    assert all(rank_out["meshes"][name]["ranks"] == want for rank_out in gang)


REFUSALS = [
    ("make_mesh", (dict(data=16),), {}),
    ("make_mesh", (dict(fsdp=3, tensor=3),), {}),
    ("auto_mesh", (6,), dict(tensor=4)),
    ("auto_mesh", (8,), dict(tensor=2, fsdp=3)),
    ("make_hybrid_mesh", (dict(data=2),), {}),
    ("make_hybrid_mesh", (dict(data=2),), dict(n_slices=3)),
    ("make_hybrid_mesh", (dict(data=2),), dict(n_slices=2, dcn_axis="bogus")),
    ("make_hybrid_mesh", (dict(data=4, tensor=2),), dict(n_slices=2)),
    ("make_hybrid_mesh", (dict(data=2, tensor=8),), dict(n_slices=2)),
]


@pytest.mark.parametrize("fn, args, kwargs", REFUSALS)
def test_mesh_refusals_say_what_the_reference_says(fn, args, kwargs):
    """Wrong counts raise ValueError with the reference's text, before any
    process group is touched."""
    def call(module, devices):
        real = [module.MeshPlan(**a) if isinstance(a, dict) else a for a in args]
        return getattr(module, fn)(*real, devices=devices, **kwargs)

    with pytest.raises(ValueError) as want:
        call(jax_mesh, jax.devices()[:8])
    with pytest.raises(ValueError) as got:
        call(torch_mesh, list(range(8)))
    assert str(got.value) == str(want.value)


def test_mesh_plan_matches_the_reference():
    plan = torch_mesh.MeshPlan(data=2, fsdp=3, tensor=5)
    ref = jax_mesh.MeshPlan(data=2, fsdp=3, tensor=5)
    assert plan.sizes == ref.sizes and plan.total() == ref.total() == 30
    assert torch_mesh.AXES == jax_mesh.AXES


def test_a_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialised process group"):
        torch_mesh.make_mesh(torch_mesh.MeshPlan(), device_type="cpu")


# -- coordinator_spec -----------------------------------------------------------


@pytest.mark.parametrize("args, kwargs", [
    ((["alice@w0", "w1"],), dict(port=9999)),
    ((["w0:2222", "w1:2222", "w2"],), {}),
    ((["[fe80::1]", "w1"],), dict(port=1234)),
    ((["fe80::1", "w1"],), {}),
    ((), dict(coordinator_address="127.0.0.1:5555", num_processes=3)),
    ((["h0", "h1"],), dict(num_processes=4)),
])
def test_coordinator_spec_equals_the_reference(args, kwargs):
    assert coordinator_spec(*args, **kwargs) == jax_coordinator_spec(*args, **kwargs)


def test_coordinator_spec_refuses_an_empty_gang():
    with pytest.raises(ValueError, match="needs workers or coordinator_address"):
        coordinator_spec()


def test_process_info_outside_a_group():
    info = parallel.process_info()
    assert (info.process_id, info.num_processes, info.is_coordinator) == (0, 1, True)


# -- collectives --------------------------------------------------------------------


@pytest.mark.parametrize("plan_name, axis", AXIS_CASES)
@pytest.mark.parametrize("name", list(PORT))
def test_collective_equals_the_reference(gang, plan_name, axis, name):
    kind, ref_fn = PORT[name][0], REFERENCE[name]
    inputs = [_input(kind, r) for r in range(WORLD)]
    want = _reference_per_rank(PLANS[plan_name], lambda x: ref_fn(x, axis), inputs)
    for rank, rank_out in enumerate(gang):
        got = rank_out["collectives"][(plan_name, axis, name)]
        assert got.shape == want[rank].shape and got.dtype == want[rank].dtype
        if kind == "int":
            np.testing.assert_array_equal(got, want[rank])
        else:
            np.testing.assert_allclose(got, want[rank], rtol=0, atol=SUM_ATOL)


@pytest.mark.parametrize("plan_name, axis", AXIS_CASES)
def test_axis_index_and_size_equal_the_reference(gang, plan_name, axis):
    zeros = [np.zeros((1,), np.int32)] * WORLD
    index = _reference_per_rank(
        PLANS[plan_name], lambda x: x + jax_coll.axis_index(axis), zeros)
    size = _reference_per_rank(
        PLANS[plan_name], lambda x: x + jax_coll.axis_size(axis), zeros)
    for rank, rank_out in enumerate(gang):
        assert rank_out["collectives"][(plan_name, axis, "axis_index")] == int(index[rank][0])
        assert rank_out["collectives"][(plan_name, axis, "axis_size")] == int(size[rank][0])


# -- batch placement --------------------------------------------------------------


@pytest.mark.parametrize("name, blocks", [
    # fsdp=2 x tensor=2: ranks (0, 1) are tensor peers with block 0
    ("fsdp2_tensor2", [0, 0, 1, 1]),
    ("data4", [0, 1, 2, 3]),
    ("data2_tensor2", [0, 0, 1, 1]),
])
def test_shard_batch_gives_each_rank_its_block(gang, name, blocks):
    tokens = np.arange(8 * 3).reshape(8, 3)
    span = 8 // (max(blocks) + 1)
    for rank, rank_out in enumerate(gang):
        got, step = rank_out["rows"][name]
        np.testing.assert_array_equal(got, tokens[blocks[rank] * span:(blocks[rank] + 1) * span])
        assert step == 7


def test_process_local_slice_owns_its_contiguous_rows(gang):
    """Process i of N owns rows [i*B/N, (i+1)*B/N); one process owns all of
    them, as the reference's does in one process."""
    tokens = np.arange(8 * 3).reshape(8, 3)
    for rank, rank_out in enumerate(gang):
        np.testing.assert_array_equal(rank_out["rows"]["process_local_slice"],
                                      tokens[2 * rank:2 * rank + 2])
    whole = parallel.process_local_slice({"tokens": tokens})["tokens"]
    np.testing.assert_array_equal(whole, jax_local_slice({"tokens": tokens})["tokens"])


def test_shard_batch_per_process_keeps_each_rank_its_own_rows(gang):
    for rank, rank_out in enumerate(gang):
        np.testing.assert_array_equal(rank_out["rows"]["per_process"], np.full((2, 3), rank))


def test_process_local_slice_refuses_an_uneven_batch(monkeypatch):
    from covalent_tpu_plugin_torch.parallel import distributed, sharding

    monkeypatch.setattr(distributed, "process_info",
                        lambda: distributed.ProcessInfo(0, 2, 1, 2))
    with pytest.raises(ValueError, match="batch dim 3 not divisible by process count 2"):
        sharding.process_local_slice({"x": np.zeros((3, 2))})


def test_parallel_exports_resolve_lazily():
    for name in parallel.__all__:
        assert getattr(parallel, name) is not None
    assert parallel.pipelined.__module__.endswith("parallel.pipeline")
    with pytest.raises(AttributeError):
        parallel.unbox  # noqa: B018 - the reference's flax unboxing has no counterpart


# -- the collective probe ---------------------------------------------------------


def test_probe_on_cpu_gloo_carries_every_check():
    """On CPU tensors gloo carries everything, point-to-point and the
    functional all-gather included (on the card it does not: PERF.md)."""
    from covalent_tpu_plugin_torch.parallel import probe

    out = probe.probe_collectives(world=2, device="cpu", backend="gloo", timeout_s=240)
    assert out["gangs"] == 1
    assert {name: e["ok"] for name, e in out["collectives"].items()} == dict.fromkeys(
        probe.CHECKS, True)


def test_probe_blames_the_check_that_killed_a_rank(monkeypatch):
    """A rank killed inside a check: that check is recorded with the
    rank's last words and a new gang runs the ones after it."""
    import json as json_mod
    import os as os_mod

    from covalent_tpu_plugin_torch.parallel import probe

    gangs = []

    def fake_run_gang(fn, world, args, **kwargs):
        _, only, out_dir = args
        gangs.append(list(only))
        for rank in range(world):
            with open(os_mod.path.join(out_dir, f"rank{rank}.jsonl"), "w") as log:
                for name in only:
                    log.write(json_mod.dumps({"name": name, "start": True}) + "\n")
                    if name == "fsdp2_step" and len(gangs) == 1:
                        break
                    log.write(json_mod.dumps({"name": name, "ok": name != "send_recv",
                                              "error": "refused"}) + "\n")
        if len(gangs) == 1:
            raise RuntimeError("gang rank 1 of 2 exited -11:\nstart fsdp2_step")

    monkeypatch.setattr(probe, "run_gang", fake_run_gang)
    out = probe.probe_collectives(world=2, device="cpu")
    entries = out["collectives"]
    assert out["gangs"] == 2 and gangs[1] == ["send_recv", "funcol_all_gather"]
    assert entries["fsdp2_step"]["killed_rank"] and "exited -11" in entries["fsdp2_step"]["error"]
    assert entries["device_mesh"] == {"ok": True}
    assert entries["send_recv"] == {"ok": False, "error": "refused"}
    assert entries["funcol_all_gather"] == {"ok": True}


@pytest.mark.parametrize("axes", LOGICAL_CASES + ["batch", "replicated"])
def test_logical_sharding_places_what_the_reference_partition_spec_names(gang, axes):
    """Shard(d) on each mesh axis the reference's PartitionSpec gives
    dimension d, Replicate elsewhere."""
    from covalent_tpu_plugin.parallel.sharding import logical_spec as ref_logical_spec

    names = {"batch": ("batch",), "replicated": ()}.get(axes, axes)
    spec = ref_logical_spec(names)
    want = []
    for axis in jax_mesh.AXES:
        dims = [d for d, entry in enumerate(spec)
                if entry is not None and axis in ((entry,) if isinstance(entry, str) else entry)]
        want.append(f"S({dims[0]})" if dims else "R")
    for rank_out in gang:
        assert rank_out["placements"][axes] == want


def test_logical_sharding_refuses_one_mesh_axis_on_two_dimensions():
    """batch (data x fsdp) beside embed (fsdp): a PartitionSpec naming fsdp
    twice, which the reference's NamedSharding refuses too."""
    from covalent_tpu_plugin_torch.parallel import sharding

    class Mesh:
        mesh_dim_names = torch_mesh.AXES

    with pytest.raises(ValueError, match="mesh axis 'fsdp' shards dimensions 0 and 2"):
        sharding.logical_sharding(Mesh(), ("batch", "seq", "embed"))
