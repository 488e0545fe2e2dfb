"""The port's LM and fused loss against the reference's, on the CPU.

Both LMs run in float32 at a tiny width; the port's weights come from the
reference's through ``params_from_jax``.  Logits are held to atol 1e-4 and
parameter gradients to atol 1e-5 plus 1e-3 of the largest gradient entry of
the tensor (two layers of float32 matmuls, summed in another order).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covalent_tpu_plugin.models import transformer as jax_tf
from covalent_tpu_plugin.models.train import cross_entropy_loss as jax_xent_loss
from covalent_tpu_plugin.ops.xent import fused_cross_entropy as jax_fused_xent
from covalent_tpu_plugin_torch.models import convert
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.models.train import cross_entropy_loss
from covalent_tpu_plugin_torch.ops.xent import fused_cross_entropy

LOGIT_ATOL = 1e-4
GRAD_ATOL, GRAD_RTOL_OF_MAX = 1e-5, 1e-3

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=128)


def _configs(**overrides):
    scan = overrides.pop("scan_layers", True)
    jax_attn = overrides.pop("jax_attention", "reference")
    port_attn = overrides.pop("port_attention", "flash")
    jcfg = jax_tf.TransformerConfig(
        **TINY, **overrides, dtype=jnp.float32, param_dtype=jnp.float32,
        logits_dtype=jnp.float32, scan_layers=scan, attention=jax_attn,
    )
    tcfg = torch_tf.TransformerConfig(
        **TINY, **overrides, dtype=torch.float32, param_dtype=torch.float32,
        logits_dtype=torch.float32, attention=port_attn,
    )
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    tokens = jnp.zeros((1, 8), jnp.int32)
    variables = jax.jit(jax_tf.TransformerLM(jcfg).init)(jax.random.PRNGKey(seed), tokens)
    params = flax.core.meta.unbox(variables["params"])
    return jax.tree.map(np.asarray, params)


def _port_model(tcfg, params):
    model = torch_tf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(params, tcfg), strict=True)
    return model


def _tokens(seed=1, batch=2, seq=64):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (batch, seq)).astype(np.int32)


def _assert_grads_close(jax_grads, model, tcfg):
    want = convert.params_from_jax(jax_grads, tcfg)
    for name, param in model.named_parameters():
        ref = want[name].numpy()
        tol = GRAD_ATOL + GRAD_RTOL_OF_MAX * np.abs(ref).max()
        np.testing.assert_allclose(param.grad.numpy(), ref, rtol=0, atol=tol, err_msg=name)


LM_CASES = {
    "mha_scan": dict(),
    "gqa_unrolled": dict(n_kv_heads=2, scan_layers=False),
    "window_sinks_scan": dict(n_kv_heads=2, sliding_window=16, attention_sinks=2),
    "window_unrolled_reference": dict(sliding_window=24, scan_layers=False,
                                      port_attention="reference"),
    "pallas_flash": dict(n_kv_heads=2, jax_attention="flash"),
}


@pytest.mark.parametrize("name", sorted(LM_CASES))
def test_lm_logits_and_grads_match_reference(name):
    jcfg, tcfg = _configs(**dict(LM_CASES[name]))
    params = _jax_params(jcfg)
    tokens = _tokens()
    model = _port_model(tcfg, params)
    jmodel = jax_tf.TransformerLM(jcfg)

    def jax_loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(tokens[:, :-1]))
        return jax_xent_loss(logits, jnp.asarray(tokens[:, 1:])), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)

    ttokens = torch.tensor(tokens).long()
    logits = model(ttokens[:, :-1])
    loss = cross_entropy_loss(logits, ttokens[:, 1:])
    loss.backward()

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=LOGIT_ATOL)
    _assert_grads_close(jax.tree.map(np.asarray, jgrads), model, tcfg)


def test_features_and_bf16_activations_match_reference():
    """bf16 activations (the training setting) through both stacks: the
    final features agree to bf16 rounding."""
    jcfg, tcfg = _configs()
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    params = _jax_params(jcfg)
    tokens = _tokens(seq=32)
    model = _port_model(tcfg, params)
    feats = model(torch.tensor(tokens).long(), return_features=True)
    jfeats = jax.jit(lambda p, t: jax_tf.TransformerLM(jcfg).apply(
        {"params": p}, t, return_features=True
    ))(params, jnp.asarray(tokens))
    assert feats.dtype == torch.bfloat16
    np.testing.assert_allclose(feats.float().detach().numpy(),
                               np.asarray(jfeats, np.float32), rtol=0, atol=0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 32), dtype=np.float32)
    w = 0.1 * rng.standard_normal((32, 256), dtype=np.float32)
    labels = rng.integers(0, 256, 64).astype(np.int32)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)

    jloss, (jdx, jdw) = jax.value_and_grad(
        lambda x, w: jax_fused_xent(x, w, jnp.asarray(labels), 64), argnums=(0, 1)
    )(jnp.asarray(x, jdtype), jnp.asarray(w))
    xt = torch.tensor(x).to(tdtype).requires_grad_()
    wt = torch.tensor(w).requires_grad_()
    loss = fused_cross_entropy(xt, wt, torch.tensor(labels), 64)
    loss.backward()

    assert xt.grad.dtype == tdtype and wt.grad.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=1e-5)
    dx_atol = 1e-6 if dtype == "float32" else 1e-4  # bf16 dx is rounded once
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(jdx, np.float32),
                               rtol=0, atol=dx_atol)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), rtol=0, atol=1e-6)
    # and against the unfused loss on the same logits
    logits = xt.detach().float() @ wt.detach().to(tdtype).float()
    np.testing.assert_allclose(
        float(cross_entropy_loss(logits, torch.tensor(labels))), float(loss.detach()), atol=1e-5
    )


def test_fused_cross_entropy_refuses_uneven_chunks():
    with pytest.raises(ValueError, match="must be divisible by chunk"):
        fused_cross_entropy(torch.zeros(4, 8), torch.zeros(8, 100), torch.zeros(4).long(), 64)


def test_cross_entropy_mask_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 8, 16), dtype=np.float32)
    labels = rng.integers(0, 16, (2, 8))
    mask = (rng.random((2, 8)) > 0.3).astype(np.float32)
    want = jax_xent_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    got = cross_entropy_loss(torch.tensor(logits), torch.tensor(labels), torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)


def test_rotary_matches_reference():
    x = np.random.default_rng(6).standard_normal((2, 64, 4, 32), dtype=np.float32)
    want = np.asarray(jax_tf._rotary(jnp.asarray(x), base=500000.0))
    got = torch_tf._rotary(torch.tensor(x), base=500000.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_converter_refuses_mismatched_trees():
    jcfg, tcfg = _configs(scan_layers=False)
    params = _jax_params(jcfg)
    with pytest.raises(ValueError, match="more than 1 layers"):
        convert.params_from_jax(params, dataclasses.replace(tcfg, n_layers=1))
    params["lm_head"]["lora_a"] = np.zeros(1)
    with pytest.raises(ValueError, match="only plain float dense layers"):
        convert.params_from_jax(params, tcfg)
    jcfg, tcfg = _configs()
    with pytest.raises(ValueError, match="depth"):
        convert.params_from_jax(_jax_params(jcfg), dataclasses.replace(tcfg, n_layers=3))


def test_default_device_is_the_card():
    """Without a device the LM asks for CUDA; with no card it raises rather
    than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_tf.TransformerLM(torch_tf.TransformerConfig(**TINY))


@pytest.mark.parametrize("knob,value,slice_name", [
    ("decode", True, "slice 2"),
    ("quantized_kv_cache", True, "slice 2"),
    ("quantized", True, "slice 3"),
    ("lora_rank", 4, "slice 3"),
    ("attention", "ring", "mesh"),
    ("attention", "ulysses", "mesh"),
])
def test_later_slice_knobs_raise(knob, value, slice_name):
    """Knobs of earlier slices are ported and construct: the serving knobs of
    slice 2 and the weights knobs of slice 3 (int8 weights, LoRA; their
    parity is ``tests/test_torch_quant.py`` and ``test_torch_lora.py``).
    Sequence-parallel attention (slice 4, part 2) constructs, and a forward
    without a mesh raises the reference's error."""
    if slice_name in ("slice 2", "slice 3"):
        assert getattr(torch_tf.TransformerConfig(**{knob: value}), knob) == value
        return
    if slice_name == "mesh":
        config = torch_tf.TransformerConfig(**TINY, dtype=torch.float32, **{knob: value})
        model = torch_tf.TransformerLM(config, device="cpu")
        ref = jax_tf.TransformerLM(jax_tf.TransformerConfig(
            **TINY, dtype=jnp.float32, **{knob: value}))
        tokens = _tokens(seq=16)
        with pytest.raises(ValueError) as want:
            ref.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
        with pytest.raises(ValueError) as got:
            model(torch.tensor(tokens).long())
        assert str(got.value) == str(want.value) == f"attention={value!r} requires config.mesh"
        return
    with pytest.raises(NotImplementedError, match=slice_name):
        torch_tf.TransformerConfig(**{knob: value})


def test_config_validation_matches_reference():
    for kwargs in (dict(sliding_window=0), dict(attention_sinks=2),
                   dict(rolling_cache=True)):
        with pytest.raises(ValueError) as ref:
            jax_tf.TransformerConfig(**kwargs)
        with pytest.raises(ValueError) as port:
            torch_tf.TransformerConfig(**kwargs)
        assert str(port.value) == str(ref.value)
    assert torch_tf.lm_125m_config().head_dim == jax_tf.lm_125m_config().head_dim == 64
