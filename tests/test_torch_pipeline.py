"""Pipeline parallelism (GPipe over ``pipe``) of the port against the reference's, on the CPU.

The reference's ``tests/test_pipeline.py`` is the guide.  A toy stack of 8
``tanh(x @ w)`` layers runs over ``MeshPlan(pipe=4)`` (a gloo gang of 4, one
rank a stage): the outputs and each stage's gradients against the dense
stack, with 4 microbatches and with 2 (fewer than the stages).

The small LM of ``tests/test_torch_sharded_train.py`` with 4 layers (d_model
64, 4 heads, vocab 256, f32, ``attention="reference"``) trains 3 AdamW steps
under ``MeshPlan(pipe=2)`` (a gang of 2, 2 microbatches of 4 rows; also with
``remat``, at a ``rope_base`` of 500000, and with 1 microbatch: fewer than
the stages) and ``MeshPlan(data=2, pipe=2)`` (a gang of 4, each ``data`` rank
2 microbatches of 2 rows).  The reference trains the same steps with
``jax.value_and_grad`` of ``pipeline_lm_loss`` on a virtual CPU mesh of the
same plan and ``optax.adamw(3e-4)``; the port starts from the reference's
initial weights (``params_from_jax``), and each rank holds its stage's
layers.  The bounds are those of ``tests/test_torch_sharded_train.py``:
losses atol 1e-5, the gradient norms rtol 1e-5 (every stage's layers and the
replicated parameters counted once), each rank's parameters after two steps
atol 2e-5.  The 2-process runs must also match one process at the same
global batch, and ``train_lm`` on a ``pipe=2`` gang must give one process's
losses.
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

from covalent_tpu_plugin.models import transformer as ref_tf
from covalent_tpu_plugin.models.pipeline_lm import pipeline_lm_loss as ref_pipeline_lm_loss
from covalent_tpu_plugin.parallel import MeshPlan as RefPlan
from covalent_tpu_plugin.parallel import make_mesh as ref_make_mesh
from covalent_tpu_plugin.parallel.pipeline import pipeline_stages as ref_pipeline_stages
from covalent_tpu_plugin_torch.models import convert, data, train
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.parallel.launch import run_gang
from covalent_tpu_plugin_torch.parallel.pipeline import pipeline_stages

LOSS_ATOL = 1e-5
PARAM_ATOL = 2e-5
NORM_RTOL = 1e-5
TOY_ATOL = 1e-5
STEPS = 3

TINY = dict(vocab_size=256, d_model=64, n_layers=4, n_heads=4, d_ff=128, max_seq=64)
BATCH, SEQ = 8, 17

#: arm -> (plan, processes, microbatches, config overrides)
LM_ARMS = {
    "pipe2": (dict(pipe=2), 2, 2, {}),
    "pipe2_remat": (dict(pipe=2), 2, 2, dict(remat=True)),
    "pipe2_rope": (dict(pipe=2), 2, 2, dict(rope_base=500_000.0)),
    "pipe2_one_micro": (dict(pipe=2), 2, 1, {}),
    "pipe2_data2": (dict(data=2, pipe=2), 4, 2, {}),
}
TWO = [arm for arm, (_, n, _, _) in LM_ARMS.items() if n == 2]
FOUR = [arm for arm, (_, n, _, _) in LM_ARMS.items() if n == 4]
TOY_LAYERS, TOY_D, TOY_STAGES = 8, 16, 4
TRAIN_LM = dict(steps=2, batch_size=4, seq_len=16, device="cpu", dtype=torch.float32,
                attention="reference", **TINY)


def _torch_config(**overrides):
    return torch_tf.TransformerConfig(**TINY, dtype=torch.float32, attention="reference",
                                      **overrides)


def _batches():
    return list(data.synthetic_lm_batches(STEPS, BATCH, SEQ, TINY["vocab_size"], seed=0))


def _toy():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((TOY_LAYERS, TOY_D, TOY_D)) * 0.3).astype(np.float32)
    micro = rng.standard_normal((4, 6, TOY_D)).astype(np.float32)
    return ws, micro


def _toy_stage(stage_ws, x):
    for w in stage_ws:
        x = torch.tanh(x @ w)
    return x


def _toy_arm(n_micro):
    """This rank's stage of the toy stack over pipe=4: the pipeline's outputs
    and the gradients of ``(outputs ** 2).sum()`` for its stage."""
    from covalent_tpu_plugin_torch.parallel.mesh import MeshPlan, make_mesh
    from covalent_tpu_plugin_torch.parallel.pipeline import pipelined

    ws, micro = _toy()
    mesh = make_mesh(MeshPlan(pipe=TOY_STAGES), device_type="cpu")
    stage = mesh.get_local_rank("pipe")
    mine = pipeline_stages(torch.tensor(ws), TOY_STAGES)[stage].clone().requires_grad_()
    out = pipelined(_toy_stage, mesh)(mine, torch.tensor(micro[:n_micro]))
    (out ** 2).sum().backward()
    return {"stage": stage, "out": out.detach().numpy(), "grad": mine.grad.numpy()}


def _lm_arm(arm, state, batches):
    """One rank of ``arm``: the LM split over its plan from ``state`` (the
    whole model's); losses, grad norms and this rank's parameters after two
    steps, with its stage index."""
    from covalent_tpu_plugin_torch.models import train
    from covalent_tpu_plugin_torch.models import transformer as tf
    from covalent_tpu_plugin_torch.models.pipeline_lm import pipeline_lm_loss
    from covalent_tpu_plugin_torch.parallel.mesh import MeshPlan, make_mesh

    plan, _, n_micro, overrides = LM_ARMS[arm]
    model = tf.TransformerLM(_torch_config(**overrides), device="cpu")
    model.load_state_dict(state)
    mesh = make_mesh(MeshPlan(**plan), device_type="cpu")
    model, optimizer, _ = train.make_sharded_train_state(model, train.adamw, mesh)
    step = train.make_train_step(
        model, optimizer, loss_fn=lambda m, b: pipeline_lm_loss(m, b, mesh, n_micro), mesh=mesh)
    losses, norms, params = [], [], None
    for i, batch in enumerate(batches):
        metrics = step(batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if i == 1:
            params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return {"losses": losses, "norms": norms, "params": params,
            "stage": mesh.get_local_rank("pipe")}


def _errors(state, batches):
    """The errors a pipelined model raises: a batch n_micro does not split,
    and a plain forward of a split model."""
    from covalent_tpu_plugin_torch.models import transformer as tf
    from covalent_tpu_plugin_torch.models.pipeline_lm import pipeline_lm_loss
    from covalent_tpu_plugin_torch.parallel import sharding
    from covalent_tpu_plugin_torch.parallel.mesh import MeshPlan, make_mesh

    mesh = make_mesh(MeshPlan(pipe=2), device_type="cpu")
    model = sharding.apply_rules(tf.TransformerLM(_torch_config(), device="cpu"), mesh)
    out = {"layers": len(model.layers)}
    tokens = torch.as_tensor(batches[0]["tokens"][:3])
    for name, call in (("n_micro", lambda: pipeline_lm_loss(model, {"tokens": tokens}, mesh, 2)),
                       ("forward", lambda: model(tokens[:, :-1]))):
        try:
            call()
        except ValueError as exc:
            out[name] = str(exc)
    return out


def _two_process_arms(state, batches):
    from covalent_tpu_plugin_torch.models import train
    from covalent_tpu_plugin_torch.parallel import MeshPlan

    return {**{arm: _lm_arm(arm, state, batches) for arm in TWO},
            "errors": _errors(state, batches),
            "train_lm": train.train_lm(**TRAIN_LM, mesh_plan=MeshPlan(pipe=2), n_micro=2)}


def _four_process_arms(state, batches):
    from covalent_tpu_plugin_torch.parallel import sharding
    from covalent_tpu_plugin_torch.parallel.mesh import MeshPlan, make_mesh

    out = {arm: _lm_arm(arm, state, batches) for arm in FOUR}
    out["toy"] = _toy_arm(4)
    out["toy_two_micro"] = _toy_arm(2)
    try:
        sharding.apply_rules(torch_tf.TransformerLM(_torch_config(), device="cpu"),
                             make_mesh(MeshPlan(tensor=2, pipe=2), device_type="cpu"))
    except NotImplementedError as exc:
        out["tensor_refused"] = str(exc)
    return out


def _reference(plan: dict, n_micro: int, batches, **overrides):
    """The reference's pipelined steps on a virtual mesh: initial params (as
    numpy), losses, grad norms and params after two steps."""
    n = int(np.prod(list(plan.values())))
    mesh = ref_make_mesh(RefPlan(**plan), jax.devices()[:n])
    cfg = ref_tf.TransformerConfig(**TINY, dtype=jnp.float32, attention="reference",
                                   scan_layers=True, **overrides)
    model = ref_tf.TransformerLM(cfg)
    params = flax.core.meta.unbox(model.init(
        jax.random.PRNGKey(0), jnp.asarray(batches[0]["tokens"][:, :-1]))["params"])
    initial = jax.tree.map(np.asarray, params)
    tx = optax.adamw(3e-4)

    @jax.jit
    def step(params, opt_state, tokens):
        loss, grads = jax.value_and_grad(lambda p: ref_pipeline_lm_loss(
            model, p, {"tokens": tokens}, mesh, n_micro))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, optax.global_norm(grads)

    opt_state = tx.init(params)
    losses, norms, after_two = [], [], None
    for i, batch in enumerate(batches):
        params, opt_state, loss, norm = step(params, opt_state, jnp.asarray(batch["tokens"]))
        losses.append(float(loss))
        norms.append(float(norm))
        if i == 1:
            after_two = jax.tree.map(np.asarray, params)
    return initial, losses, norms, after_two


@pytest.fixture(scope="module")
def reference():
    batches = _batches()
    lm = {arm: _reference(plan, n_micro, batches, **overrides)
          for arm, (plan, _, n_micro, overrides) in LM_ARMS.items()}
    return {"batches": batches, "lm": lm}


@pytest.fixture(scope="module")
def port(reference):
    """One 2-process gang (the pipe2 arms, the errors, ``train_lm``) and one
    4-process gang (pipe2 x data2, the toy stack over pipe=4)."""
    # every reference arm starts from the same PRNGKey(0) params
    state = convert.params_from_jax(reference["lm"]["pipe2"][0], _torch_config())
    batches = reference["batches"]
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        two = run_gang(_two_process_arms, 2, (state, batches), timeout_s=300)
        four = run_gang(_four_process_arms, 4, (state, batches), timeout_s=300)
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    runs = {key: [rank[key] for rank in two] for key in two[0]}
    runs.update({key: [rank[key] for rank in four] for key in four[0]})
    return {"runs": runs, "state": state}


def _toy_dense(n_micro):
    ws, micro = _toy()
    ws = torch.tensor(ws, requires_grad=True)
    out = torch.stack([_toy_stage(ws, torch.tensor(m)) for m in micro[:n_micro]])
    (out ** 2).sum().backward()
    return out.detach().numpy(), ws.grad.numpy()


@pytest.mark.parametrize("arm, n_micro", [("toy", 4), ("toy_two_micro", 2)])
def test_pipeline_forward_matches_dense(port, arm, n_micro):
    """Every stage gets the last stage's outputs; with 2 microbatches over 4
    stages (the bubble-dominated edge) every microbatch still comes out."""
    want, _ = _toy_dense(n_micro)
    for rank in port["runs"][arm]:
        np.testing.assert_allclose(rank["out"], want, rtol=0, atol=TOY_ATOL)


@pytest.mark.parametrize("arm, n_micro", [("toy", 4), ("toy_two_micro", 2)])
def test_pipeline_gradients_match_dense(port, arm, n_micro):
    _, grads = _toy_dense(n_micro)
    want = pipeline_stages(torch.tensor(grads), TOY_STAGES).numpy()
    assert sorted(rank["stage"] for rank in port["runs"][arm]) == list(range(TOY_STAGES))
    for rank in port["runs"][arm]:
        np.testing.assert_allclose(rank["grad"], want[rank["stage"]], rtol=0, atol=1e-4)


@pytest.mark.parametrize("layers, stages", [(6, 4), (12, 5)])
def test_pipeline_stages_validates_divisibility(layers, stages):
    with pytest.raises(ValueError) as want:
        ref_pipeline_stages(jnp.zeros((layers, 4, 4)), stages)
    for value in (torch.zeros(layers, 4, 4), list(range(layers))):
        with pytest.raises(ValueError) as got:
            pipeline_stages(value, stages)
        assert str(got.value) == str(want.value)
    assert [len(s) for s in pipeline_stages(list(range(layers)), 2)] == [layers // 2] * 2


@pytest.mark.parametrize("arm", list(LM_ARMS))
def test_pipelined_losses_match_the_reference(port, reference, arm):
    _, want, _, _ = reference["lm"][arm]
    for rank in port["runs"][arm]:
        np.testing.assert_allclose(rank["losses"], want, rtol=0, atol=LOSS_ATOL)


@pytest.mark.parametrize("arm", list(LM_ARMS))
def test_pipelined_grad_norms_match_the_reference(port, reference, arm):
    _, _, want, _ = reference["lm"][arm]
    for rank in port["runs"][arm]:
        np.testing.assert_allclose(rank["norms"], want, rtol=NORM_RTOL)


@pytest.mark.parametrize("arm", ["pipe2", "pipe2_data2"])
def test_each_stage_holds_its_layers_after_two_steps(port, reference, arm):
    """Each rank's parameters (its stage's layers, numbered from 0, and the
    replicated embedding, final norm and head) against the reference's."""
    _, _, _, after_two = reference["lm"][arm]
    for rank in port["runs"][arm]:
        want = convert.params_from_jax(after_two, _torch_config(), stage=(rank["stage"], 2))
        assert set(rank["params"]) == set(want)
        assert sum(name.endswith("ln_attn.scale") for name in want) == TINY["n_layers"] // 2
        for name, value in rank["params"].items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("arm", ["pipe2", "pipe2_remat"])
def test_two_stages_match_one_process_at_the_same_global_batch(port, arm):
    overrides = LM_ARMS[arm][3]
    model = torch_tf.TransformerLM(_torch_config(**overrides), device="cpu")
    model.load_state_dict(port["state"])
    step = train.make_train_step(model, train.adamw(model))
    losses = [float(step(batch)["loss"]) for batch in _batches()]
    for rank in port["runs"][arm]:
        np.testing.assert_allclose(rank["losses"], losses, rtol=0, atol=LOSS_ATOL)


def test_train_lm_on_a_pipe_gang_matches_one_process(port):
    one = train.train_lm(**TRAIN_LM)
    for rank_out in port["runs"]["train_lm"]:
        np.testing.assert_allclose(rank_out["losses"], one["losses"], rtol=0, atol=LOSS_ATOL)
        assert rank_out["mesh"]["pipe"] == 2 and rank_out["world_size"] == 2


def test_pipeline_errors_name_the_reference_s_conditions(port):
    """A batch that n_micro does not split raises the reference's text; a
    split model holds its stage's layers and refuses a plain forward."""
    for rank in port["runs"]["errors"]:
        assert rank["n_micro"] == "batch 3 not divisible by n_micro 2"
        assert rank["layers"] == TINY["n_layers"] // 2
        assert "pipeline_lm_forward" in rank["forward"]
    for message in port["runs"]["tensor_refused"]:
        assert "composes with data only" in message
