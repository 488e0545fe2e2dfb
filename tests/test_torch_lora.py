"""The port's LoRA / QLoRA against the reference's, on the CPU.

One tiny LM (2 layers, d_model 64, 4 heads, a 256 vocabulary) on both
sides, the port's weights converted from the reference's LoRA tree
(``params_from_jax`` carries ``lora_a``/``lora_b`` and the int8 kernels).
Tolerances: logits atol 1e-4 in float32, which pins the function; with
bf16 activations a cosine above 0.9995 and atol 0.06.  The bf16 bound is
wider than a plain model's because the adapter's rank-4 products amplify
what differs in rounding: XLA on the CPU keeps excess precision between
fused ops (``xla_allow_excess_precision``), so the reference skips roundings
of ``h = x @ A`` and of ``u * alpha / r`` that the port makes, as the
reference's own function on the TPU makes them.  With that precision off
(``XLA_FLAGS=--xla_allow_excess_precision=false``, in a process of its own)
the same logits are held to a plain model's bound instead: 8 bf16
roundings of the largest logit (``tests/test_torch_decode.py``).  Three AdamW steps' losses
atol 1e-5 and adapter leaves atol 2e-5
(f32 gradients summed in another order, normalised by Adam).  The wire form
is exact: ``adapter_leaves`` in the reference's order, shapes and dtype, and
its digest equal to the reference's ``adapter_digest``.
"""

import dataclasses
import os
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from covalent_tpu_plugin.models import lora as jax_lora
from covalent_tpu_plugin.models import transformer as jax_tf
from covalent_tpu_plugin.models.train import lm_loss as jax_lm_loss
from covalent_tpu_plugin_torch.models import convert, lora, quant
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.models.data import synthetic_lm_batches

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=32)
F32_ATOL = 1e-4
BF16_COSINE, BF16_ATOL = 0.9995, 0.06
LOSS_ATOL, LEAF_ATOL = 1e-5, 2e-5
RANK = 4
#: a plain model's bf16 bound, in roundings (2^-8) of the largest logit
PLAIN_BF16_ROUNDINGS = 8


def _configs(dtype="float32", **overrides):
    overrides = {**TINY, **overrides}
    jcfg = jax_tf.TransformerConfig(**overrides, dtype=getattr(jnp, dtype),
                                    attention="reference", scan_layers=False)
    tcfg = torch_tf.TransformerConfig(**overrides, dtype=getattr(torch, dtype),
                                      attention="reference")
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    variables = jax.jit(jax_tf.TransformerLM(jcfg).init)(jax.random.PRNGKey(seed),
                                                         jnp.zeros((1, 4), jnp.int32))
    return flax.core.meta.unbox(variables["params"])


def _randomize_b(params, seed):
    """Non-zero ``lora_b`` leaves (``add_lora``'s are zero: the identity)."""
    mask = jax.tree_util.tree_leaves(jax_lora.lora_mask(params))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    out = [leaf if not m or leaf.shape[0] != RANK
           else jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32) * 0.05)
           for leaf, m in zip(leaves, mask)]
    return jax.tree_util.tree_unflatten(treedef, out)


def _port(tcfg, params):
    model = torch_tf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg),
                          strict=True)
    return model


def _lora_cfg(tcfg, quantized=False):
    return dataclasses.replace(tcfg, lora_rank=RANK, lora_alpha=16.0, quantized=quantized)


def _tokens(seed=1, batch=2, seq=12):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (batch, seq)).astype(
        np.int32)


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
        return
    cosine = (got.ravel() @ want.ravel()) / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cosine > BF16_COSINE
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


def _jax_logits(model, params, tokens):
    return np.asarray(jax.jit(lambda p, t: model.apply({"params": p}, t))(
        params, jnp.asarray(tokens)), np.float32)


def _lora_reference(dtype, quantized):
    """The reference's LoRA (or QLoRA) LM with non-zero ``lora_b``: its tree
    and its logits on ``_tokens()``."""
    jcfg, _ = _configs(dtype)
    build = jax_lora.quantize_then_lora if quantized else jax_lora.add_lora
    lmodel, lparams = build(jax_tf.TransformerLM(jcfg), _jax_params(jcfg), rank=RANK, alpha=16.0)
    lparams = _randomize_b(lparams, seed=7)
    return lparams, _jax_logits(lmodel, lparams, _tokens())


def _port_logits(dtype, quantized, lparams):
    """The port's logits on ``_tokens()`` from the reference's tree, on the
    plain route and on the serving route (batch-invariant, the adapter's
    products per row)."""
    model = _port(_lora_cfg(_configs(dtype)[1], quantized), lparams)
    tokens = torch.tensor(_tokens()).long()
    with torch.no_grad():
        got = model(tokens).float().numpy()
        routed = torch_tf.use_batch_invariant(model)(tokens).float().numpy()
    return got, routed


@pytest.mark.parametrize("quantized", [False, True], ids=["lora", "qlora"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_forward_with_nonzero_b_matches_the_reference(dtype, quantized):
    lparams, want = _lora_reference(dtype, quantized)
    for got in _port_logits(dtype, quantized, lparams):
        _close(got, want, dtype)


#: The bf16 reference logits of both adapters, computed with XLA's excess
#: precision off (the flag is read when JAX starts, so in a process of its own).
_WITHOUT_EXCESS_PRECISION = """
import os
import sys
import numpy as np
sys.path[:0] = [sys.argv[1], os.path.dirname(sys.argv[1])]
import test_torch_lora as t
np.savez(sys.argv[2], **{kind: t._lora_reference("bfloat16", kind == "qlora")[1]
                         for kind in ("lora", "qlora")})
"""


@pytest.fixture(scope="module")
def reference_without_excess_precision(tmp_path_factory):
    path = tmp_path_factory.mktemp("no_excess_precision") / "logits.npz"
    flags = os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags.strip())
    subprocess.run([sys.executable, "-c", _WITHOUT_EXCESS_PRECISION,
                    os.path.dirname(os.path.abspath(__file__)), str(path)],
                   env=env, check=True, timeout=600)
    return dict(np.load(path))


@pytest.mark.parametrize("quantized", [False, True], ids=["lora", "qlora"])
def test_bf16_lora_without_excess_precision_is_within_a_plain_models_bound(
        quantized, reference_without_excess_precision):
    """The cause the bf16 bound above states, checked: with the reference's
    excess precision off, the port's bf16 LoRA and QLoRA logits (both
    routes) are within a plain model's bound of the reference's."""
    lparams, _ = _lora_reference("bfloat16", quantized)
    want = reference_without_excess_precision["qlora" if quantized else "lora"]
    tol = PLAIN_BF16_ROUNDINGS * 2.0**-8 * np.abs(want).max()
    for got in _port_logits("bfloat16", quantized, lparams):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("quantized", [False, True], ids=["lora", "qlora"])
def test_add_lora_is_the_identity_at_init(quantized):
    _, tcfg = _configs()
    base = torch_tf.TransformerLM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    if quantized:
        base = quant.quantize_lm(base)
    lmodel = lora.add_lora(base, RANK)
    assert lmodel.config.lora_rank == RANK and lmodel.config.quantized == quantized
    tokens = torch.tensor(_tokens()).long()
    with torch.no_grad():
        assert torch.equal(lmodel(tokens), base(tokens))
    mask = lora.lora_mask(lmodel)
    assert sum(mask.values()) == 2 * 6 * TINY["n_layers"]
    assert all(name.endswith(("lora_a", "lora_b")) for name, m in mask.items() if m)
    assert isinstance(lmodel.lm_head, quant.QuantDense if quantized else torch_tf.Dense)


def test_three_lora_train_steps_match_the_reference():
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg)
    lmodel, lparams = jax_lora.add_lora(jax_tf.TransformerLM(jcfg), params, rank=RANK)
    state = jax_lora.make_lora_train_state(lparams, optax.adamw(1e-3))
    jstep = jax_lora.make_lora_train_step(jax_lm_loss, lmodel.apply)
    model = _port(_lora_cfg(tcfg), lparams)
    optimizer = lora.make_lora_train_state(model, lr=1e-3)
    step = lora.make_lora_train_step(model, optimizer)
    base_before = {n: p.detach().clone() for n, p in model.named_parameters()
                   if not lora.lora_mask(model)[n]}
    for batch in synthetic_lm_batches(steps=3, batch_size=2, seq_len=13,
                                      vocab_size=TINY["vocab_size"], seed=4):
        state, jloss = jstep(state, {"tokens": jnp.asarray(batch["tokens"])})
        loss = step(batch)["loss"]
        np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=LOSS_ATOL)
    want = jax_lora.adapter_leaves(jax_lora.lora_train_params(state))
    got = lora.adapter_leaves(model)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=LEAF_ATOL)
    for name, param in model.named_parameters():
        if name in base_before:
            assert torch.equal(param, base_before[name]), name
            assert not param.requires_grad


def test_qlora_trains_only_the_adapters():
    _, tcfg = _configs()
    base = torch_tf.TransformerLM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model = lora.quantize_then_lora(base, RANK)
    optimizer = lora.make_lora_train_state(model, lr=3e-2)
    step = lora.make_lora_train_step(model, optimizer)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = [float(step(b)["loss"]) for b in synthetic_lm_batches(
        steps=4, batch_size=2, seq_len=13, vocab_size=TINY["vocab_size"], seed=2)]
    assert all(np.isfinite(losses))
    mask = lora.lora_mask(model)
    for name, param in model.named_parameters():
        assert torch.equal(param, before[name]) != mask[name] or (
            name.endswith("lora_a") and torch.equal(param, before[name])), name
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters()
               if n.endswith("lora_b"))


def test_merge_lora_equals_the_adapted_forward_and_the_reference():
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg)
    lmodel, lparams = jax_lora.add_lora(jax_tf.TransformerLM(jcfg), params, rank=RANK)
    lparams = _randomize_b(lparams, seed=9)
    plain_model, merged = jax_lora.merge_lora(lmodel, lparams)
    model = _port(_lora_cfg(tcfg), lparams)
    plain = lora.merge_lora(model)
    assert plain.config.lora_rank == 0
    tokens = torch.tensor(_tokens()).long()
    with torch.no_grad():
        np.testing.assert_allclose(plain(tokens).numpy(), model(tokens).numpy(), rtol=0,
                                   atol=F32_ATOL)
    want = convert.params_from_jax(jax.tree.map(np.asarray, merged), tcfg)
    for name, tensor in plain.state_dict().items():
        np.testing.assert_allclose(tensor.numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    with pytest.raises(ValueError, match="float base"):
        lora.merge_lora(lora.quantize_then_lora(torch_tf.TransformerLM(tcfg, device="cpu"),
                                                RANK))


@pytest.mark.parametrize("n_layers,n_kv_heads", [(2, None), (12, 2)])
def test_adapter_leaves_are_the_reference_wire_form(n_layers, n_kv_heads):
    """The reference's key-sorted flatten: ``layer_10`` before ``layer_2``,
    attention (k, out, q, v) before mlp (wi, wo), lora_a before lora_b, in
    the DenseGeneral shapes; the digest equal to the reference's."""
    jcfg, tcfg = _configs(n_layers=n_layers, n_kv_heads=n_kv_heads)
    params = _jax_params(jcfg)
    _, lparams = jax_lora.add_lora(jax_tf.TransformerLM(jcfg), params, rank=RANK)
    lparams = _randomize_b(lparams, seed=n_layers)
    want = [np.asarray(leaf) for leaf in jax_lora.adapter_leaves(lparams)]
    model = _port(_lora_cfg(tcfg), lparams)
    got = lora.adapter_leaves(model)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(g.dtype == np.float32 for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert lora.adapter_digest(got) == jax_lora.adapter_digest(want)
    # the installer reads the wire form back into the port's layout
    state = lora.adapter_state(model, want)
    params_now = dict(model.named_parameters())
    assert all(torch.equal(value, params_now[name]) for name, value in state.items())
    if n_layers == 12:
        head = [s[0] for s in lora._wire_sites(model)]
        assert head[0][0] == "layer_0" and head[2 * 6][0] == "layer_1"
        assert head[4 * 6][0] == "layer_10" and head[-1][0] == "layer_9"
        q_b = head.index(("layer_0", "attention", "q_proj", "lora_b"))
        assert got[q_b].shape == (RANK, 4, 16)
        out_a = head.index(("layer_0", "attention", "out_proj", "lora_a"))
        assert got[out_a].shape == (4, 16, RANK)


def test_adapter_state_refuses_another_geometry():
    _, tcfg = _configs()
    model = lora.add_lora(torch_tf.TransformerLM(tcfg, device="cpu"), RANK)
    leaves = lora.adapter_leaves(model)
    with pytest.raises(ValueError, match="leaves"):
        lora.adapter_state(model, leaves[:-1])
    with pytest.raises(ValueError, match="rank or geometry"):
        lora.adapter_state(model, [np.zeros((3,) + leaf.shape[1:], np.float32)
                                   if i == 1 else leaf for i, leaf in enumerate(leaves)])
    with pytest.raises(ValueError, match="carries adapters"):
        lora.add_lora(model, RANK)
    with pytest.raises(ValueError, match="rank must be"):
        lora.add_lora(torch_tf.TransformerLM(tcfg, device="cpu"), 0)


def test_train_lora_electron_on_the_cpu():
    """The fine-tune electron at a tiny width: losses finite, the base bit-
    unchanged, every adapter leaf moved after the first step, the digest the
    registry's."""
    from covalent_tpu_plugin_torch.serving.registry import adapter_content_digest

    for quantized in (False, True):
        result = lora.train_lora(steps=3, batch_size=2, seq_len=16, rank=RANK,
                                 quantized=quantized, device="cpu", **TINY)
        assert all(np.isfinite(result["losses"])) and len(result["losses"]) == 3
        assert result["base_unchanged"]
        assert result["adapter_leaves_moved"] == result["adapter_leaves_total"] == 24
        assert result["digest"] == adapter_content_digest(result["leaves"])
