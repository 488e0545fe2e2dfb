"""The port's training path against the reference's, on the CPU.

Both LMs run in float32 at a tiny width from the same weights (converted
with ``params_from_jax``) and the same numpy batches.  Two AdamW steps of the
port are held against two ``optax.adamw(3e-4)`` steps of the reference.
Tolerances: losses atol 1e-5; parameters atol 2e-5 after two steps.  An
AdamW step moves a weight by at most ~lr = 3e-4 whatever its gradient, so
the parameters stay within a few f32 ulps of the reference except where a
gradient is near AdamW's eps, where the two gradient sums (taken in another
order) can give a visibly different normalised step; 2e-5 is 7% of one step.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from covalent_tpu_plugin.models import train as jax_train
from covalent_tpu_plugin.models import transformer as jax_tf
from covalent_tpu_plugin.models.data import synthetic_lm_batches as jax_batches
from covalent_tpu_plugin_torch.models import convert, data, train
from covalent_tpu_plugin_torch.models import transformer as torch_tf

LOSS_ATOL = 1e-5
PARAM_ATOL = 2e-5

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=128)


def _setup(vocab_chunk=None, **overrides):
    jcfg = jax_tf.TransformerConfig(
        **TINY, **overrides, dtype=jnp.float32, param_dtype=jnp.float32,
        logits_dtype=jnp.float32, attention="reference",
    )
    tcfg = torch_tf.TransformerConfig(
        **TINY, **overrides, dtype=torch.float32, param_dtype=torch.float32,
        logits_dtype=torch.float32, attention="flash",
    )
    jmodel = jax_tf.TransformerLM(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(variables["params"]))
    model = torch_tf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(params, tcfg), strict=True)
    return jmodel, params, model, tcfg


def _jax_steps(jmodel, params, batches, vocab_chunk=None):
    tx = optax.adamw(3e-4)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: jax_train.lm_loss(p, jmodel.apply, batch, vocab_chunk=vocab_chunk)
        )(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for batch in batches:
        params, opt_state, loss = step(params, opt_state,
                                       {"tokens": jnp.asarray(batch["tokens"])})
        losses.append(float(loss))
    return jax.tree.map(np.asarray, params), losses


@pytest.mark.parametrize("vocab_chunk,overrides", [
    (None, {}),
    (64, {"n_kv_heads": 2}),
    (None, {"sliding_window": 16, "attention_sinks": 2}),
])
def test_two_adamw_steps_match_optax(vocab_chunk, overrides):
    jmodel, params, model, tcfg = _setup(**overrides)
    batches = list(data.synthetic_lm_batches(
        steps=2, batch_size=2, seq_len=33, vocab_size=TINY["vocab_size"], seed=3,
    ))
    want_params, want_losses = _jax_steps(jmodel, params, batches, vocab_chunk)

    step = train.make_train_step(
        model, train.adamw(model),
        loss_fn=lambda m, b: train.lm_loss(m, b, vocab_chunk=vocab_chunk),
    )
    losses = [float(step(batch)["loss"]) for batch in batches]

    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_ATOL)
    want = convert.params_from_jax(want_params, tcfg)
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)


def test_adamw_matches_optax_defaults():
    """One step on a fixed gradient: the port's optimizer is optax.adamw(3e-4)."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 7), dtype=np.float32)
    grads = [rng.standard_normal((5, 7), dtype=np.float32) for _ in range(3)]
    tx = optax.adamw(3e-4)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)

    model = torch.nn.Linear(7, 5, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.tensor(p0))
    opt = train.adamw(model)
    for g in grads:
        model.weight.grad = torch.tensor(g)
        opt.step()
    # unit-scale weights: a few f32 ulps from another order of operations
    np.testing.assert_allclose(model.weight.detach().numpy(), np.asarray(jp),
                               rtol=0, atol=1e-6)


def test_accumulated_step_equals_full_batch_step():
    """accumulate_steps=2 over two halves of a batch takes the same step as
    the whole batch (mean losses, equal microbatches)."""
    _, _, model_full, _ = _setup()
    _, _, model_acc, _ = _setup()
    batch = data.synthetic_lm_batch(4, 33, TINY["vocab_size"], seed=5)
    micro = {"tokens": batch["tokens"].reshape(2, 2, 33)}

    full = train.make_train_step(model_full, train.adamw(model_full))(batch)
    acc = train.make_train_step(
        model_acc, train.adamw(model_acc), accumulate_steps=2
    )(micro)
    np.testing.assert_allclose(float(acc["loss"]), float(full["loss"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(acc["grad_norm"]), float(full["grad_norm"]),
                               rtol=1e-5)
    for (name, a), (_, b) in zip(model_acc.named_parameters(), model_full.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    with pytest.raises(ValueError, match="leading microbatch axis"):
        train.make_train_step(model_acc, train.adamw(model_acc), accumulate_steps=3)(micro)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_steps_equal_the_plain_steps(policy):
    """Each block rematerialised (every activation recomputed, or all but the
    2-D products' outputs): two AdamW steps take the plain steps' losses,
    grad norms and parameters bit for bit."""
    batches = list(data.synthetic_lm_batches(2, 2, 33, TINY["vocab_size"], seed=3))
    runs = []
    for remat in (False, True):
        _, _, model, _ = _setup(remat=remat, remat_policy=policy)
        step = train.make_train_step(model, train.adamw(model))
        metrics = [step(batch) for batch in batches]
        runs.append(([float(m["loss"]) for m in metrics], [float(m["grad_norm"]) for m in metrics],
                     [p.detach().clone() for p in model.parameters()]))
    (losses, norms, params), (r_losses, r_norms, r_params) = runs
    assert r_losses == losses and r_norms == norms
    assert all(torch.equal(a, b) for a, b in zip(params, r_params))


def test_remat_policy_is_checked_as_the_reference_checks_it():
    with pytest.raises(ValueError) as want:
        cfg = jax_tf.TransformerConfig(**TINY, remat=True, remat_policy="some")
        jax_tf.TransformerLM(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    with pytest.raises(ValueError) as got:
        torch_tf.TransformerConfig(**TINY, remat=True, remat_policy="some")
    assert str(got.value) == str(want.value)


def test_batches_are_byte_identical_to_reference():
    for got, want in zip(data.synthetic_lm_batches(3, 2, 65, 1000, seed=7),
                         jax_batches(3, 2, 65, 1000, seed=7)):
        assert got["tokens"].dtype == want["tokens"].dtype
        assert got["tokens"].tobytes() == want["tokens"].tobytes()


def test_fused_loss_refuses_a_quantized_head():
    _, _, model, _ = _setup()
    model.lm_head.weight = torch.nn.Parameter(
        torch.zeros_like(model.lm_head.weight, dtype=torch.int8), requires_grad=False
    )
    batch = data.synthetic_lm_batch(1, 9, TINY["vocab_size"])
    with pytest.raises(ValueError, match="plain float lm_head"):
        train.lm_loss(model, batch, vocab_chunk=64)


def test_train_lm_electron_on_cpu():
    """The slice's electron at a tiny size: losses finite and falling, no
    kernel launched on CPU tensors."""
    out = train.train_lm(steps=4, batch_size=2, seq_len=32, device="cpu", **TINY)
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    assert out["tokens_per_step"] == 64 and out["device"] == "cpu"
