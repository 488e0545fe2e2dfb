"""Sequence-parallel training of the port against the reference's, on the CPU.

The small LM of ``tests/test_torch_sharded_train.py`` (2 layers, d_model 64,
4 heads, vocab 256, f32) trains 3 AdamW steps with ``attention="ring"`` and
``attention="ulysses"`` as a gloo gang of 2 processes under
``MeshPlan(seq=2)``, and with the ring under ``MeshPlan(fsdp=2, seq=2)`` as
a gang of 4.  Each rank holds its rows of the global batch and its part of
every sequence (zigzag stripes for the ring, contiguous for Ulysses), at
the global positions rotary needs.  The reference trains the same steps with
``make_sharded_train_state`` + ``make_train_step`` on a virtual CPU mesh of
the same plan, and the port starts from the reference's initial weights
(``params_from_jax``).  On the CPU the ring resolves to the einsum ring in
both packages.  The bounds are those of ``tests/test_torch_sharded_train.py``:
losses atol 1e-5, the gradient norms rtol 1e-5, parameters after two steps
atol 2e-5 (a missing gradient average over ``seq`` still gives falling
losses; only the parameters show it).

``train_lm`` itself runs on a 2-process ``seq`` gang at the same size, and
must give one process's losses at the same global batch.
"""

import sys

import cloudpickle
import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from covalent_tpu_plugin.models import train as ref_train
from covalent_tpu_plugin.models import transformer as ref_tf
from covalent_tpu_plugin.parallel import MeshPlan as RefPlan
from covalent_tpu_plugin.parallel import make_mesh as ref_make_mesh
from covalent_tpu_plugin.parallel import shard_batch as ref_shard_batch
from covalent_tpu_plugin_torch.models import convert, data, train
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.parallel import sharding
from covalent_tpu_plugin_torch.parallel.launch import run_gang

LOSS_ATOL = 1e-5
PARAM_ATOL = 2e-5
NORM_RTOL = 1e-5
STEPS = 3

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=64)
#: the global batch: 8 rows of 17 tokens (the loss reads 16, 8 on each seq rank)
BATCH, SEQ = 8, 17

#: arm -> (plan, processes, attention)
ARMS = {"ring_seq2": (dict(seq=2), 2, "ring"), "ulysses_seq2": (dict(seq=2), 2, "ulysses"),
        "ring_fsdp2_seq2": (dict(fsdp=2, seq=2), 4, "ring")}
TWO = [arm for arm, (_, n, _) in ARMS.items() if n == 2]
FOUR = [arm for arm, (_, n, _) in ARMS.items() if n == 4]
#: train_lm's own arm: a few steps at the small size, with and without the gang
TRAIN_LM = dict(steps=2, batch_size=4, seq_len=16, device="cpu", dtype=torch.float32,
                **TINY)


def _torch_config(attention):
    return torch_tf.TransformerConfig(**TINY, dtype=torch.float32, attention=attention)


def _batches():
    return list(data.synthetic_lm_batches(STEPS, BATCH, SEQ, TINY["vocab_size"], seed=0))


def _full(param) -> torch.Tensor:
    return (param.full_tensor() if hasattr(param, "full_tensor") else param).detach().clone()


def _lm_arm(arm, state, batches):
    """One rank: the LM of ``arm`` from ``state``, sharded over its plan;
    losses, grad norms, the full parameters after two steps and the part of
    the first batch this rank took."""
    from covalent_tpu_plugin_torch.models import train
    from covalent_tpu_plugin_torch.models import transformer as tf
    from covalent_tpu_plugin_torch.parallel import sharding
    from covalent_tpu_plugin_torch.parallel.mesh import MeshPlan, make_mesh

    plan, _, attention = ARMS[arm]
    model = tf.TransformerLM(_torch_config(attention), device="cpu")
    model.load_state_dict(state)
    mesh = make_mesh(MeshPlan(**plan), device_type="cpu")
    model, optimizer, _ = train.make_sharded_train_state(model, train.adamw, mesh)
    step = train.make_train_step(model, optimizer, mesh=mesh)
    losses, norms, params = [], [], None
    for i, batch in enumerate(batches):
        metrics = step(batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if i == 1:
            params = {n: _full(p) for n, p in model.named_parameters()}
    zigzag = model.sequence_zigzag(SEQ - 1, mesh["seq"].size())
    part = sharding.shard_batch(batches[0], mesh, zigzag=zigzag)
    return {"losses": losses, "norms": norms, "params": params, "zigzag": zigzag,
            "part": {k: v.numpy() for k, v in part.items()},
            "seq_rank": mesh.get_local_rank("seq")}


def _train_lm_arm():
    from covalent_tpu_plugin_torch.models import train
    from covalent_tpu_plugin_torch.parallel.mesh import MeshPlan

    out = train.train_lm(mesh_plan=MeshPlan(seq=2), attention="ring", **TRAIN_LM)
    return {"losses": out["losses"], "mesh": out["mesh"], "world_size": out["world_size"]}


def _two_process_arms(state, batches):
    return {**{arm: _lm_arm(arm, state, batches) for arm in TWO}, "train_lm": _train_lm_arm()}


def _four_process_arms(state, batches):
    return {arm: _lm_arm(arm, state, batches) for arm in FOUR}


def _reference(plan: dict, attention: str, batches):
    """The reference's sharded steps on a virtual mesh: initial params (as
    numpy), losses, grad norms and params after two steps."""
    n = int(np.prod(list(plan.values())))
    mesh = ref_make_mesh(RefPlan(**plan), jax.devices()[:n])
    cfg = ref_tf.TransformerConfig(**TINY, dtype=jnp.float32, attention=attention, mesh=mesh,
                                   scan_layers=True)
    model = ref_tf.TransformerLM(cfg)
    sample = ref_shard_batch({"tokens": batches[0]["tokens"]}, mesh)["tokens"][:, :-1]
    state, shardings = ref_train.make_sharded_train_state(
        model, optax.adamw(3e-4), jax.random.PRNGKey(0), sample, mesh)
    initial = jax.tree.map(np.asarray, flax.core.meta.unbox(state.params))
    step = ref_train.make_train_step(ref_train.lm_loss, mesh, shardings)
    losses, norms, after_two = [], [], None
    for i, batch in enumerate(batches):
        state, metrics = step(state, ref_shard_batch({"tokens": batch["tokens"]}, mesh))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if i == 1:
            after_two = jax.tree.map(np.asarray, flax.core.meta.unbox(state.params))
    return initial, losses, norms, after_two


@pytest.fixture(scope="module")
def reference():
    batches = _batches()
    return {"batches": batches,
            "lm": {arm: _reference(plan, attention, batches)
                   for arm, (plan, _, attention) in ARMS.items()}}


@pytest.fixture(scope="module")
def port(reference):
    """One 2-process gang (the seq=2 arms and train_lm) and one 4-process
    gang (fsdp2 x seq2), from the reference's initial weights (every arm
    starts from the same PRNGKey(0) parameters)."""
    state = convert.params_from_jax(reference["lm"]["ring_seq2"][0], _torch_config("ring"))
    batches = reference["batches"]
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        two = run_gang(_two_process_arms, 2, (state, batches), timeout_s=300)
        four = run_gang(_four_process_arms, 4, (state, batches), timeout_s=300)
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    runs = {arm: [rank[arm] for rank in two] for arm in [*TWO, "train_lm"]}
    runs.update({arm: [rank[arm] for rank in four] for arm in FOUR})
    return {"runs": runs, "state": state}


@pytest.mark.parametrize("arm", list(ARMS))
def test_seq_losses_match_the_reference(port, reference, arm):
    _, want, _, _ = reference["lm"][arm]
    for rank in port["runs"][arm]:
        np.testing.assert_allclose(rank["losses"], want, rtol=0, atol=LOSS_ATOL)


@pytest.mark.parametrize("arm", list(ARMS))
def test_seq_grad_norms_match_the_reference(port, reference, arm):
    _, _, want, _ = reference["lm"][arm]
    for rank in port["runs"][arm]:
        np.testing.assert_allclose(rank["norms"], want, rtol=NORM_RTOL)


@pytest.mark.parametrize("arm", list(ARMS))
def test_seq_params_match_the_reference_after_two_steps(port, reference, arm):
    _, _, _, want = reference["lm"][arm]
    want = convert.params_from_jax(want, _torch_config(ARMS[arm][2]))
    for rank in port["runs"][arm]:
        assert set(rank["params"]) == set(want)
        for name, value in rank["params"].items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("arm", list(ARMS))
def test_each_seq_rank_takes_its_part_of_the_shifted_sequence(port, reference, arm):
    """Inputs and labels are cut from the globally shifted sequence at the
    rank's global positions: zigzag stripes i and 2n-1-i for the ring,
    contiguous halves for Ulysses."""
    plan, _, attention = ARMS[arm]
    tokens = reference["batches"][0]["tokens"]
    rows = BATCH // plan.get("fsdp", 1)
    for i, rank in enumerate(port["runs"][arm]):
        assert rank["zigzag"] == (attention == "ring")
        me = rank["seq_rank"]
        stripe = (SEQ - 1) // 4
        want_pos = (np.r_[me * stripe:(me + 1) * stripe, (3 - me) * stripe:(4 - me) * stripe]
                    if rank["zigzag"] else np.arange(me * 8, (me + 1) * 8))
        block = i // 2 if plan.get("fsdp", 1) > 1 else 0
        mine = tokens[block * rows:(block + 1) * rows]
        cut = rank["part"]
        np.testing.assert_array_equal(cut["positions"], want_pos)
        np.testing.assert_array_equal(cut["tokens"], mine[:, :-1][:, want_pos])
        np.testing.assert_array_equal(cut["labels"], mine[:, 1:][:, want_pos])


def test_train_lm_on_a_seq_gang_gives_one_processs_losses(port):
    alone = train.train_lm(attention="reference", **TRAIN_LM)
    for rank in port["runs"]["train_lm"]:
        assert rank["world_size"] == 2 and rank["mesh"]["seq"] == 2
        np.testing.assert_allclose(rank["losses"], alone["losses"], rtol=0, atol=LOSS_ATOL)


class _SeqMesh:  # a mesh whose seq axis has two ranks
    def __getitem__(self, axis):
        return type("Axis", (), {"size": lambda self: 2 if axis == "seq" else 1})()


def test_a_seq_split_takes_a_language_model_batch():
    with pytest.raises(ValueError, match="a batch split over 'seq'"):
        sharding._seq_cut({"image": np.zeros((2, 4))}, _SeqMesh(), False)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_a_seq_forward_without_positions_raises(attention):
    """shard_batch is the one source of a rank's global positions: the model
    derives none of its own."""
    model = torch_tf.TransformerLM(_torch_config(attention), device="cpu")
    for module in model.modules():
        if hasattr(module, "sequence_parallel"):
            module.sequence_parallel(_SeqMesh())
    with pytest.raises(ValueError, match="over seq=2 needs the global positions"):
        model(torch.zeros((1, 8), dtype=torch.long))


def test_pipeline_parallelism_is_refused_naming_its_slice():
    """GPipe is ported (tests/test_torch_pipeline.py): ``apply_rules`` over
    ``pipe`` refuses a model with no layers to split, and a pipeline stage
    sharded over ``tensor`` (not ported), naming what is missing."""
    from covalent_tpu_plugin_torch.parallel.mesh import MeshPlan

    class Mesh:
        mesh_dim_names = ("data", "fsdp", "tensor", "seq", "pipe")

        def __init__(self, sizes):
            self.sizes = sizes

        def size(self, i):
            return self.sizes.get(self.mesh_dim_names[i], 1)

    assert sharding.mesh_plan(Mesh({"pipe": 2})) == MeshPlan(pipe=2)
    with pytest.raises(ValueError, match="Linear has no layers to split over pipe"):
        sharding.apply_rules(torch.nn.Linear(2, 2), Mesh({"pipe": 2}))
    with pytest.raises(NotImplementedError, match="composes with data only"):
        sharding.apply_rules(torch.nn.Linear(2, 2), Mesh({"pipe": 2, "tensor": 2}))
