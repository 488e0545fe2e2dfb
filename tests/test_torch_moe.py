"""The port's Switch MoE against the reference's, on the CPU.

``MoEMlp`` alone (d_model 16, 4 experts, f32) against the reference's module
on the same weights, at capacity factors 4.0 ("roomy", nothing dropped) and
0.25 ("tight", tokens dropped onto the residual): outputs atol 1e-5 and the
load-balance aux, near 1 when the routing is uniform.  Then the small LM of
``tests/test_torch_sharded_train.py`` (2 layers, d_model 64, vocab 256, f32,
``attention="reference"``) with 4 experts at the tight factor trains 3 AdamW
steps on ``lm_loss_with_moe_aux``: on one process, as a gloo gang of 2 under
``MeshPlan(tensor=2)`` (2 experts a rank) and under ``MeshPlan(data=2)`` and
``MeshPlan(fsdp=2)`` (each rank half the rows: the capacity, the slots' order
and the aux's means must follow the global batch, as the reference's traced
program does).  The reference trains the same steps with
``make_sharded_train_state`` + ``make_train_step`` on a virtual CPU mesh of
the same plan.  Bounds of ``tests/test_torch_sharded_train.py``: losses atol
1e-5, grad norms rtol 1e-5, parameters after two steps atol 2e-5.

``models/convert.py`` carries the MoE parameters from stacked and unrolled
reference trees (the logits must agree at atol 1e-4, the bound of
``tests/test_torch_transformer.py``), and a pipe rank's stage of the layers.
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
from covalent_tpu_plugin.models.moe import MoEMlp as RefMoEMlp
from covalent_tpu_plugin.models.moe import collect_moe_aux as ref_collect_moe_aux
from covalent_tpu_plugin.models.moe import lm_loss_with_moe_aux as ref_moe_loss
from covalent_tpu_plugin.parallel import MeshPlan as RefPlan
from covalent_tpu_plugin.parallel import make_mesh as ref_make_mesh
from covalent_tpu_plugin.parallel import shard_batch as ref_shard_batch
from covalent_tpu_plugin_torch.models import convert, data, train
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.models.moe import MoEMlp, collect_moe_aux, lm_loss_with_moe_aux
from covalent_tpu_plugin_torch.parallel.launch import run_gang

OUT_ATOL = 1e-5
LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
PARAM_ATOL = 2e-5
NORM_RTOL = 1e-5
STEPS = 3
TIGHT = 0.25

SMALL = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2, d_ff=32, max_seq=16,
             moe_experts=4)
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=64,
            moe_experts=4, moe_capacity_factor=TIGHT)
BATCH, SEQ = 8, 17
#: arm -> (plan, processes)
ARMS = {"one": ({}, 1), "tensor2": (dict(tensor=2), 2), "data2": (dict(data=2), 2),
        "fsdp2": (dict(fsdp=2), 2)}
GANG = [arm for arm, (_, n) in ARMS.items() if n == 2]


def _module_pair(capacity_factor, scale=1.0, seed=0):
    """The reference's MoEMlp and the port's on the same weights, and an input."""
    ref_cfg = ref_tf.TransformerConfig(**SMALL, dtype=jnp.float32, attention="reference",
                                       moe_capacity_factor=capacity_factor)
    cfg = torch_tf.TransformerConfig(**SMALL, dtype=torch.float32, attention="reference",
                                     moe_capacity_factor=capacity_factor)
    x = (np.random.default_rng(seed).standard_normal((2, 8, 16)) * scale).astype(np.float32)
    ref = RefMoEMlp(ref_cfg)
    variables = ref.init(jax.random.PRNGKey(1), x)
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(variables["params"]))
    port = MoEMlp(cfg, "cpu", None)
    port.load_state_dict({"router": torch.tensor(params["router"]["kernel"].T),
                          "wi": torch.tensor(params["wi"]), "wo": torch.tensor(params["wo"])})
    return ref, variables, port, x


@pytest.mark.parametrize("capacity_factor", [4.0, TIGHT], ids=["roomy", "tight"])
def test_moe_matches_the_reference(capacity_factor):
    ref, variables, port, x = _module_pair(capacity_factor)
    want, state = ref.apply(variables, x, mutable=["intermediates"])
    got = port(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=OUT_ATOL)
    (aux,) = jax.tree_util.tree_leaves(state["intermediates"])
    np.testing.assert_allclose(float(port.aux.detach()), float(aux), rtol=1e-6)
    dropped = int((np.abs(got.reshape(-1, 16)).max(axis=1) == 0).sum())
    if capacity_factor < 1:  # tight: some tokens must actually be dropped
        assert dropped > 0
    else:
        assert dropped == 0


def test_moe_aux_is_near_one_when_the_routing_is_uniform():
    ref, variables, port, x = _module_pair(2.0, scale=1e-3, seed=2)
    port(torch.tensor(x))
    _, state = ref.apply(variables, x, mutable=["intermediates"])
    (want,) = jax.tree_util.tree_leaves(state["intermediates"])
    # near-zero router logits -> near-uniform gates -> aux ~= 1 (its minimum)
    got = float(port.aux.detach())
    assert 0.9 < got < 1.6
    np.testing.assert_allclose(got, float(want), rtol=1e-6)


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "unrolled"])
def test_convert_carries_the_moe_params(scan_layers):
    """The router, ``wi`` and ``wo`` of every layer from a stacked or an
    unrolled reference tree: logits, the summed aux and the aux-aware loss."""
    cfg = dict(TINY, max_seq=64)
    ref = ref_tf.TransformerLM(ref_tf.TransformerConfig(
        **cfg, dtype=jnp.float32, attention="reference", scan_layers=scan_layers))
    tokens = data.synthetic_lm_batch(2, SEQ, TINY["vocab_size"], seed=4)["tokens"]
    params = flax.core.meta.unbox(ref.init(jax.random.PRNGKey(0), tokens[:, :-1])["params"])
    logits, state = ref.apply({"params": params}, tokens[:, :-1], mutable=["intermediates"])
    model = torch_tf.TransformerLM(torch_tf.TransformerConfig(
        **cfg, dtype=torch.float32, attention="reference"), device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params),
                                                  model.config), strict=True)
    got = model(torch.tensor(tokens[:, :-1]).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(float(collect_moe_aux(model).detach()),
                               float(ref_collect_moe_aux(state["intermediates"])), rtol=1e-6)
    loss = lm_loss_with_moe_aux(model, {"tokens": tokens})
    want = ref_moe_loss(params, ref.apply, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=0, atol=LOSS_ATOL)


def test_convert_takes_a_pipe_rank_s_stage():
    """``stage=(i, n)``: stage i's layers, numbered from 0 as that rank's
    model holds them, and the replicated parameters; they load strictly
    into a model split over pipe."""
    cfg = dict(TINY, n_layers=4, moe_experts=0)
    ref = ref_tf.TransformerLM(ref_tf.TransformerConfig(**cfg, dtype=jnp.float32,
                                                        attention="reference"))
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(
        ref.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]))
    config = torch_tf.TransformerConfig(**cfg, dtype=torch.float32, attention="reference")
    whole = convert.params_from_jax(params, config)
    for index in range(2):
        stage = convert.params_from_jax(params, config, stage=(index, 2))
        model = torch_tf.TransformerLM(config, device="cpu")
        model.layers = model.layers[:2]  # as pipeline_parallel keeps them
        model.load_state_dict(stage, strict=True)
        for name, value in stage.items():
            if name.startswith("layers."):
                i, rest = name[len("layers."):].split(".", 1)
                source = f"layers.{int(i) + 2 * index}.{rest}"
            else:
                source = name
            assert torch.equal(value, whole[source]), name
    with pytest.raises(ValueError, match="not divisible by 3 pipeline stages"):
        convert.params_from_jax(params, config, stage=(0, 3))


def test_moe_decoding_raises_by_name():
    """MoE decoding is ported (``tests/test_torch_moe_serve.py`` holds it to
    the reference): ``decode=True`` constructs and a cached forward runs.
    What stays refused names its slice: a cached forward of a
    tensor-parallel model, the MoE's serving form included."""
    assert torch_tf.TransformerConfig(**SMALL, decode=True).decode
    from covalent_tpu_plugin_torch.models.decode import init_cache

    model = torch_tf.TransformerLM(torch_tf.TransformerConfig(
        **SMALL, dtype=torch.float32, attention="reference"), device="cpu")
    cache = init_cache(model, 1)
    with torch.no_grad():
        assert model(torch.zeros(1, 4, dtype=torch.long), cache=cache).shape == (1, 4, 64)
        # the serving form leaves the training-only aux out where no gradient runs
        torch_tf.use_batch_invariant(model)
        model(torch.zeros(1, 4, dtype=torch.long), cache=init_cache(model, 1))
    assert float(collect_moe_aux(model)) == 0.0
    layer = model.layers[0]
    layer.attention.tp = layer.mlp.tp = object()
    with pytest.raises(NotImplementedError, match=r"slice 4, part 3\(b\)"):
        layer.attention(torch.zeros(1, 1, 16), init_cache(model, 1)[0])
    with pytest.raises(NotImplementedError, match=r"item 1\(b\)"):
        layer.mlp(torch.zeros(1, 1, 16), per_row=True)


def test_moe_refuses_a_sequence_split():
    """Under ``seq`` a rank's tokens are not a block of the global token
    order the routing follows: refused, not approximated."""

    class Mesh:
        def __getitem__(self, axis):
            return type("Axis", (), {"size": lambda self: 2 if axis == "seq" else 1})()

    module = MoEMlp(torch_tf.TransformerConfig(**SMALL), "cpu", None)
    with pytest.raises(NotImplementedError, match="seq > 1"):
        module.batch_parallel(Mesh())


def _torch_config():
    return torch_tf.TransformerConfig(**TINY, dtype=torch.float32, attention="reference")


def _batches():
    return list(data.synthetic_lm_batches(STEPS, BATCH, SEQ, TINY["vocab_size"], seed=0))


def _full(param) -> torch.Tensor:
    return (param.full_tensor() if hasattr(param, "full_tensor") else param).detach().clone()


def _train(model, optimizer, batches, mesh=None):
    step = train.make_train_step(model, optimizer, loss_fn=lm_loss_with_moe_aux, mesh=mesh)
    losses, norms, params = [], [], None
    for i, batch in enumerate(batches):
        metrics = step(batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if i == 1:
            params = {n: _full(p) for n, p in model.named_parameters()}
    return {"losses": losses, "norms": norms, "params": params}


def _gang_arms(state, batches):
    from covalent_tpu_plugin_torch.models import train
    from covalent_tpu_plugin_torch.parallel.mesh import MeshPlan, make_mesh

    out = {}
    for arm in GANG:
        model = torch_tf.TransformerLM(_torch_config(), device="cpu")
        model.load_state_dict(state)
        mesh = make_mesh(MeshPlan(**ARMS[arm][0]), device_type="cpu")
        model, optimizer, shardings = train.make_sharded_train_state(model, train.adamw, mesh)
        out[arm] = {**_train(model, optimizer, batches, mesh), "shardings": shardings}
    return out


def _reference(plan: dict, batches):
    n = max(1, int(np.prod(list(plan.values()))))
    mesh = ref_make_mesh(RefPlan(**plan), jax.devices()[:n])
    cfg = ref_tf.TransformerConfig(**TINY, dtype=jnp.float32, attention="reference", mesh=mesh,
                                   scan_layers=True)
    model = ref_tf.TransformerLM(cfg)
    sample = ref_shard_batch({"tokens": batches[0]["tokens"]}, mesh)["tokens"][:, :-1]
    state, shardings = ref_train.make_sharded_train_state(
        model, optax.adamw(3e-4), jax.random.PRNGKey(0), sample, mesh)
    initial = jax.tree.map(np.asarray, flax.core.meta.unbox(state.params))
    step = ref_train.make_train_step(ref_moe_loss, mesh, shardings)
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
            "runs": {arm: _reference(plan, batches) for arm, (plan, _) in ARMS.items()}}


@pytest.fixture(scope="module")
def port(reference):
    """The one-process arm here, the 2-process arms in one gloo gang."""
    state = convert.params_from_jax(reference["runs"]["one"][0], _torch_config())
    batches = reference["batches"]
    model = torch_tf.TransformerLM(_torch_config(), device="cpu")
    model.load_state_dict(state)
    runs = {"one": [_train(model, train.adamw(model), batches)]}
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        ranks = run_gang(_gang_arms, 2, (state, batches), timeout_s=300)
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    runs.update({arm: [rank[arm] for rank in ranks] for arm in GANG})
    return runs


@pytest.mark.parametrize("arm", list(ARMS))
def test_moe_losses_match_the_reference(port, reference, arm):
    _, want, _, _ = reference["runs"][arm]
    for rank in port[arm]:
        np.testing.assert_allclose(rank["losses"], want, rtol=0, atol=LOSS_ATOL)


@pytest.mark.parametrize("arm", list(ARMS))
def test_moe_grad_norms_match_the_reference(port, reference, arm):
    _, _, want, _ = reference["runs"][arm]
    for rank in port[arm]:
        np.testing.assert_allclose(rank["norms"], want, rtol=NORM_RTOL)


@pytest.mark.parametrize("arm", list(ARMS))
def test_moe_params_match_the_reference_after_two_steps(port, reference, arm):
    want = convert.params_from_jax(reference["runs"][arm][3], _torch_config())
    for rank in port[arm]:
        assert set(rank["params"]) == set(want)
        for name, value in rank["params"].items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)


def test_experts_shard_over_tensor(port):
    for rank in port["tensor2"]:
        got = rank["shardings"]
        assert got["layers.0.mlp.wi"] == ("tensor", None, None)
        assert got["layers.0.mlp.wo"] == ("tensor", None, None)
        assert got["layers.1.mlp.router"] == (None, None)


def test_a_batch_split_changes_no_routing(port):
    """Every sharded arm takes the one-process steps: the global capacity,
    slot order and aux (at the tight factor tokens are dropped, so a
    per-rank capacity would show)."""
    for arm in GANG:
        for rank in port[arm]:
            np.testing.assert_allclose(rank["losses"], port["one"][0]["losses"], rtol=0,
                                       atol=LOSS_ATOL)


@pytest.mark.parametrize("vocab_chunk", [None, 64])
def test_the_aux_weight_scales_the_aux(vocab_chunk):
    """The aux-aware loss is the LM loss (standard or fused) plus the
    weighted aux of the same forward."""
    model = torch_tf.TransformerLM(_torch_config(), device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    batch = _batches()[0]
    plain = train.lm_loss(model, batch, vocab_chunk=vocab_chunk)
    aux = collect_moe_aux(model)
    with_aux = lm_loss_with_moe_aux(model, batch, aux_weight=0.5, vocab_chunk=vocab_chunk)
    np.testing.assert_allclose(float(with_aux.detach()), float((plain + 0.5 * aux).detach()),
                               rtol=1e-6)
