"""Sharded training of the port against the reference's, on the CPU.

The small LM of ``__graft_entry__.py:dryrun_multichip`` (2 layers, d_model
64, 4 heads, vocab 256, f32, ``attention="reference"``) trains 3 AdamW
steps as a gang of 2 processes (``MeshPlan(fsdp=2)``, ``MeshPlan(tensor=2)``)
and of 4 (``MeshPlan(fsdp=2, tensor=2)``), gloo, one rank a CPU.  The
reference trains the same steps with ``make_sharded_train_state`` +
``make_train_step`` on a virtual CPU mesh of the same plan, and the port
starts from the reference's initial weights (``params_from_jax``).  The
bounds are the single-process ones of ``tests/test_torch_train.py``: losses
atol 1e-5, parameters (gathered with ``full_tensor()``) atol 2e-5 after two
steps; the gradient norms at rtol 1e-5.  The 2-process runs must also match
one process at the same global batch.  GQA arms (``n_kv_heads`` 2: a rank's
query heads are one group; ``n_kv_heads`` 1: they are half of one) hold the
replicated k/v projections of the rules' ``kv_heads`` under ``tensor=2``,
alone and with ``fsdp=2``.  Two arms change the step: the fused loss
(``vocab_chunk`` 64) under ``tensor=2``, each rank streaming its half of the
vocabulary, and gradient accumulation (2 microbatches of 4 rows) under
``fsdp=2``, each microbatch split over the ranks, against the reference's
``lm_loss(vocab_chunk=64)`` and ``make_train_step(accumulate_steps=2)``.

The data-parallel CNN (``MeshPlan(data=2)``, BASELINE config 4) against the
reference's ``make_classifier_train_step`` on a 2-device data mesh: losses
at rtol 1e-4, the bound of the single-process CNN in
``tests/test_torch_mnist.py`` (its convolutions sum 288 products a pixel in
another order), and parameters after two steps at atol 1e-4, a tenth of one
Adam step (lr 1e-3): as for the LM's 2e-5 (7% of one AdamW step at 3e-4), an
element whose gradient is near Adam's eps takes a visibly different
normalised step when its gradient sums in another order (measured: one
element of 802816 in ``fc.weight`` 6.9e-5 apart).
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
from jax.sharding import NamedSharding, PartitionSpec

from covalent_tpu_plugin.models import mlp as ref_mlp
from covalent_tpu_plugin.models import train as ref_train
from covalent_tpu_plugin.models import transformer as ref_tf
from covalent_tpu_plugin.parallel import MeshPlan as RefPlan
from covalent_tpu_plugin.parallel import make_mesh as ref_make_mesh
from covalent_tpu_plugin.parallel import shard_batch as ref_shard_batch
from covalent_tpu_plugin_torch.models import convert, data, train
from covalent_tpu_plugin_torch.models import mlp as torch_mlp
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.parallel.launch import run_gang

LOSS_ATOL = 1e-5
PARAM_ATOL = 2e-5
NORM_RTOL = 1e-5
CNN_LOSS_RTOL = 1e-4
CNN_PARAM_ATOL = 1e-4
STEPS = 3

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=64)
#: the global batch: 8 rows of 17 tokens (the loss reads 16)
BATCH, SEQ = 8, 17
CNN_BATCH = 16

#: arm -> (plan, processes, n_kv_heads, step options: vocab_chunk, accumulate_steps)
LM_ARMS = {"fsdp2": (dict(fsdp=2), 2, None, {}), "tensor2": (dict(tensor=2), 2, None, {}),
           "fsdp2_tensor2": (dict(fsdp=2, tensor=2), 4, None, {}),
           "gqa_tensor2": (dict(tensor=2), 2, 2, {}), "mqa_tensor2": (dict(tensor=2), 2, 1, {}),
           "gqa_fsdp2_tensor2": (dict(fsdp=2, tensor=2), 4, 2, {}),
           "fused_tensor2": (dict(tensor=2), 2, None, dict(vocab_chunk=64)),
           "accumulate_fsdp2": (dict(fsdp=2), 2, None, dict(accumulate_steps=2))}
TWO = [arm for arm, (_, n, _, _) in LM_ARMS.items() if n == 2]
FOUR = [arm for arm, (_, n, _, _) in LM_ARMS.items() if n == 4]


def _torch_config(kv_heads=None):
    return torch_tf.TransformerConfig(**TINY, n_kv_heads=kv_heads, dtype=torch.float32,
                                      attention="reference")


def _batches():
    return list(data.synthetic_lm_batches(STEPS, BATCH, SEQ, TINY["vocab_size"], seed=0))


def _microbatched(batches, accumulate_steps=1):
    """``batches``, each cut into microbatches on a leading axis when the step
    accumulates."""
    if accumulate_steps == 1:
        return batches
    return [{"tokens": b["tokens"].reshape(accumulate_steps, -1, SEQ)} for b in batches]


def _step(model, optimizer, mesh=None, vocab_chunk=None, accumulate_steps=1):
    return train.make_train_step(
        model, optimizer, loss_fn=lambda m, b: train.lm_loss(m, b, vocab_chunk=vocab_chunk),
        accumulate_steps=accumulate_steps, mesh=mesh)


def _cnn_batches():
    return [torch_mlp.synthetic_mnist(CNN_BATCH, seed=s) for s in range(STEPS)]


def _full(param) -> torch.Tensor:
    return (param.full_tensor() if hasattr(param, "full_tensor") else param).detach().clone()


def _lm_arm(arm, states, batches, place_after):
    """One rank: the LM of ``arm`` sharded over its plan from its weights in
    ``states`` (by ``n_kv_heads``); losses, grad norms and the full
    parameters after two steps."""
    import torch

    from covalent_tpu_plugin_torch.models import convert, train
    from covalent_tpu_plugin_torch.models import transformer as tf
    from covalent_tpu_plugin_torch.parallel.mesh import MeshPlan, make_mesh

    plan, _, kv_heads, opts = LM_ARMS[arm]
    state = states[kv_heads]
    batches = _microbatched(batches, opts.get("accumulate_steps", 1))
    model = tf.TransformerLM(_torch_config(kv_heads), device="cpu")
    mesh = make_mesh(MeshPlan(**plan), device_type="cpu")
    if place_after:
        # shard first, then place the converted weights onto the mesh
        model, optimizer, shardings = train.make_sharded_train_state(model, train.adamw, mesh)
        convert.place_on_mesh(model, state)
    else:
        model.load_state_dict(state)
        model, optimizer, shardings = train.make_sharded_train_state(model, train.adamw, mesh)
    step = _step(model, optimizer, mesh, **opts)
    losses, norms, params = [], [], None
    for i, batch in enumerate(batches):
        metrics = step(batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if i == 1:
            params = {n: _full(p) for n, p in model.named_parameters()}
    return {"losses": losses, "norms": norms, "params": params, "shardings": shardings}


def _cnn_arm(state, batches):
    from covalent_tpu_plugin_torch.models import mlp, train
    from covalent_tpu_plugin_torch.parallel.mesh import MeshPlan, make_mesh

    net = mlp.MnistCNN(device="cpu")
    net.load_state_dict(state)
    mesh = make_mesh(MeshPlan(data=2), device_type="cpu")
    net, optimizer, _ = train.make_sharded_train_state(net, train.adam, mesh)
    step = train.make_classifier_train_step(net, optimizer, mesh=mesh)
    losses, params = [], None
    for i, batch in enumerate(batches):
        losses.append(float(step(batch)["loss"]))
        if i == 1:
            params = {n: _full(p) for n, p in net.named_parameters()}
    return {"losses": losses, "params": params}


def _placements(model) -> dict:
    return {n: str(getattr(p, "placements", "plain")) for n, p in model.named_parameters()}


def _config_mesh_arm():
    """The LM built with ``TransformerConfig(mesh=...)`` shards itself as
    ``apply_rules`` shards a built one."""
    import dataclasses

    from covalent_tpu_plugin_torch.models import transformer as tf
    from covalent_tpu_plugin_torch.parallel import sharding
    from covalent_tpu_plugin_torch.parallel.mesh import MeshPlan, make_mesh

    mesh = make_mesh(MeshPlan(tensor=2), device_type="cpu")
    built = tf.TransformerLM(dataclasses.replace(_torch_config(), mesh=mesh), device="cpu")
    applied = sharding.apply_rules(tf.TransformerLM(_torch_config(), device="cpu"), mesh)
    return _placements(built), _placements(applied)


def _two_process_arms(states, cnn_state, batches, cnn_batches):
    return {**{arm: _lm_arm(arm, states, batches, False) for arm in TWO},
            "cnn_data2": _cnn_arm(cnn_state, cnn_batches),
            "config_mesh": _config_mesh_arm()}


def _four_process_arms(states, batches):
    # weights placed after sharding
    return {arm: _lm_arm(arm, states, batches, True) for arm in FOUR}


def _reference_lm(plan: dict, kv_heads, batches, vocab_chunk=None, accumulate_steps=1):
    """The reference's sharded steps on a virtual mesh: initial params (as
    numpy), losses, grad norms and params after two steps.  With
    accumulation each microbatch is split over the batch axes (dim 1)."""
    n = int(np.prod(list(plan.values())))
    mesh = ref_make_mesh(RefPlan(**plan), jax.devices()[:n])
    cfg = ref_tf.TransformerConfig(**TINY, n_kv_heads=kv_heads, dtype=jnp.float32,
                                   attention="reference", mesh=mesh, scan_layers=True)
    model = ref_tf.TransformerLM(cfg)
    sample = ref_shard_batch({"tokens": batches[0]["tokens"]}, mesh)["tokens"][:, :-1]
    state, shardings = ref_train.make_sharded_train_state(
        model, optax.adamw(3e-4), jax.random.PRNGKey(0), sample, mesh)
    initial = jax.tree.map(np.asarray, flax.core.meta.unbox(state.params))
    step = ref_train.make_train_step(
        lambda p, apply_fn, b: ref_train.lm_loss(p, apply_fn, b, vocab_chunk=vocab_chunk),
        mesh, shardings, accumulate_steps=accumulate_steps)
    micro = NamedSharding(mesh, PartitionSpec(None, ("data", "fsdp")))
    losses, norms, after_two = [], [], None
    for i, batch in enumerate(batches):
        if accumulate_steps > 1:
            (tokens,) = _microbatched([batch], accumulate_steps)
            placed = {"tokens": jax.device_put(tokens["tokens"], micro)}
        else:
            placed = ref_shard_batch({"tokens": batch["tokens"]}, mesh)
        state, metrics = step(state, placed)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if i == 1:
            after_two = jax.tree.map(np.asarray, flax.core.meta.unbox(state.params))
    return initial, losses, norms, after_two


def _reference_cnn(batches):
    mesh = ref_make_mesh(RefPlan(data=2), jax.devices()[:2])
    model = ref_mlp.MnistCNN()
    sample = ref_shard_batch({"image": batches[0]["image"]}, mesh)["image"]
    state, shardings = ref_train.make_sharded_train_state(
        model, optax.adam(1e-3), jax.random.PRNGKey(0), sample, mesh)
    initial = jax.tree.map(np.asarray, flax.core.meta.unbox(state.params))
    step = ref_train.make_classifier_train_step(mesh, shardings)
    losses, after_two = [], None
    for i, batch in enumerate(batches):
        state, metrics = step(state, ref_shard_batch(dict(batch), mesh))
        losses.append(float(metrics["loss"]))
        if i == 1:
            after_two = jax.tree.map(np.asarray, flax.core.meta.unbox(state.params))
    return initial, losses, after_two


@pytest.fixture(scope="module")
def reference():
    batches = _batches()
    lm = {arm: _reference_lm(plan, kv, batches, **opts)
          for arm, (plan, _, kv, opts) in LM_ARMS.items()}
    return {"batches": batches, "lm": lm, "cnn": _reference_cnn(_cnn_batches())}


@pytest.fixture(scope="module")
def port(reference):
    """The port's arms: one 2-process gang (the 2-process LM arms, the CNN)
    and one 4-process gang (fsdp2 x tensor2, weights placed after
    sharding)."""
    # every reference arm of one n_kv_heads starts from the same PRNGKey(0) params
    states = {kv: convert.params_from_jax(reference["lm"][arm][0], _torch_config(kv))
              for arm, (_, _, kv, _) in reversed(LM_ARMS.items())}
    cnn_state = convert.cnn_params_from_jax(reference["cnn"][0])
    batches, cnn_batches = reference["batches"], _cnn_batches()
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        two = run_gang(_two_process_arms, 2, (states, cnn_state, batches, cnn_batches),
                       timeout_s=300)
        four = run_gang(_four_process_arms, 4, (states, batches), timeout_s=300)
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    runs = {arm: [rank[arm] for rank in two] for arm in [*TWO, "cnn_data2", "config_mesh"]}
    runs.update({arm: [rank[arm] for rank in four] for arm in FOUR})
    return {"runs": runs, "states": states, "cnn_state": cnn_state}


def _assert_params(got: dict, want: dict, atol: float) -> None:
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("arm", list(LM_ARMS))
def test_sharded_losses_match_the_reference(port, reference, arm):
    _, want, _, _ = reference["lm"][arm]
    for rank in port["runs"][arm]:
        np.testing.assert_allclose(rank["losses"], want, rtol=0, atol=LOSS_ATOL)


@pytest.mark.parametrize("arm", list(LM_ARMS))
def test_sharded_grad_norms_match_the_reference(port, reference, arm):
    _, _, want, _ = reference["lm"][arm]
    for rank in port["runs"][arm]:
        np.testing.assert_allclose(rank["norms"], want, rtol=NORM_RTOL)


@pytest.mark.parametrize("arm", list(LM_ARMS))
def test_sharded_params_match_the_reference_after_two_steps(port, reference, arm):
    _, _, _, want = reference["lm"][arm]
    want = convert.params_from_jax(want, _torch_config(LM_ARMS[arm][2]))
    for rank in port["runs"][arm]:
        _assert_params(rank["params"], want, PARAM_ATOL)


@pytest.mark.parametrize("arm", TWO)
def test_two_processes_match_one_at_the_same_global_batch(port, arm):
    _, _, kv_heads, opts = LM_ARMS[arm]
    model = torch_tf.TransformerLM(_torch_config(kv_heads), device="cpu")
    model.load_state_dict(port["states"][kv_heads])
    step = _step(model, train.adamw(model), **opts)
    losses, params = [], None
    for i, batch in enumerate(_microbatched(_batches(), opts.get("accumulate_steps", 1))):
        losses.append(float(step(batch)["loss"]))
        if i == 1:
            params = {n: p.detach().clone() for n, p in model.named_parameters()}
    for rank in port["runs"][arm]:
        np.testing.assert_allclose(rank["losses"], losses, rtol=0, atol=LOSS_ATOL)
        _assert_params(rank["params"], params, PARAM_ATOL)


@pytest.mark.parametrize("arm, sharded", [
    # the tensor axis has extent 1 under fsdp2: FSDP2 is the only road
    ("fsdp2", {"layers.0.attention.q_proj.weight": (None, "fsdp"), "embedding": (None, "fsdp")}),
    ("tensor2", {"layers.0.attention.q_proj.weight": ("tensor", None),
                 "layers.0.attention.out_proj.weight": (None, "tensor"),
                 "layers.0.mlp.wi.weight": ("tensor", None), "embedding": ("tensor", None),
                 "lm_head.weight": ("tensor", None), "ln_final.scale": (None,)}),
    ("fsdp2_tensor2", {"layers.1.mlp.wo.weight": ("fsdp", "tensor"),
                       "layers.1.ln_mlp.scale": ("fsdp",)}),
    # GQA k/v projections: kv_heads, replicated over tensor
    ("gqa_tensor2", {"layers.0.attention.q_proj.weight": ("tensor", None),
                     "layers.0.attention.k_proj.weight": (None, None),
                     "layers.0.attention.v_proj.weight": (None, None)}),
    ("gqa_fsdp2_tensor2", {"layers.0.attention.k_proj.weight": (None, "fsdp"),
                           "layers.0.attention.q_proj.weight": ("tensor", "fsdp")}),
])
def test_param_shardings_follow_the_rules(port, arm, sharded):
    """Which mesh axes shard which dimensions: the reference's logical rules
    (axes of extent 1 read None)."""
    got = port["runs"][arm][0]["shardings"]
    for name, spec in sharded.items():
        assert got[name] == spec, name


def test_data_parallel_cnn_matches_the_reference_classifier_step(port, reference):
    _, want_losses, want_params = reference["cnn"]
    want = convert.cnn_params_from_jax(want_params)
    for rank in port["runs"]["cnn_data2"]:
        np.testing.assert_allclose(rank["losses"], want_losses, rtol=CNN_LOSS_RTOL)
        _assert_params(rank["params"], want, CNN_PARAM_ATOL)


def test_a_config_mesh_shards_the_model_as_apply_rules_does(port):
    for built, applied in port["runs"]["config_mesh"]:
        assert built == applied
        assert built["layers.0.attention.q_proj.weight"] == "(Shard(dim=0),)"
        assert built["ln_final.scale"] == "(Replicate(),)"


def test_a_mesh_plan_needs_the_gang():
    from covalent_tpu_plugin_torch.parallel import MeshPlan

    with pytest.raises(RuntimeError, match="GPUExecutor\\(workers"):
        train.train_lm(steps=1, batch_size=2, seq_len=16, device="cpu",
                       mesh_plan=MeshPlan(fsdp=2), **{k: v for k, v in TINY.items()})
