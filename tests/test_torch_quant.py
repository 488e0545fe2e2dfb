"""The port's int8 weight-only quantization against the reference's, on the CPU.

The same numpy weights go through ``covalent_tpu_plugin.models.quant`` and
``covalent_tpu_plugin_torch.models.quant``.  ``quantize_array`` and
``quantize_lm`` are held **bit-equal** (int8 values and f32 scales alike,
and the port's quantized state dict equal to ``params_from_jax`` of the
reference's quantized tree).  The quantized LM's logits (2 layers, d_model
64, 4 heads, a 256 vocabulary) are held to atol 1e-4 in float32 (two layers
of f32 products summed in another order) and, with bf16 activations, to a
logit cosine above 0.9999 and atol 0.05 (bf16 rounds every dense output on
both sides; a one-ulp difference of a pre-rounding sum can move an output
by 1/128 of it).  Each decode mode's twin is held to the reference's twin
through the decode path (prefill, then two steps) at the same tolerances.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covalent_tpu_plugin.models import decode as jax_decode
from covalent_tpu_plugin.models import quant as jax_quant
from covalent_tpu_plugin.models import transformer as jax_tf
from covalent_tpu_plugin_torch.models import convert, decode, quant
from covalent_tpu_plugin_torch.models import transformer as torch_tf

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=32)
F32_ATOL = 1e-4
BF16_COSINE, BF16_ATOL = 0.9999, 0.05


def _configs(dtype="float32", **overrides):
    jcfg = jax_tf.TransformerConfig(**TINY, **overrides, dtype=getattr(jnp, dtype),
                                    attention="reference", scan_layers=False)
    tcfg = torch_tf.TransformerConfig(**TINY, **overrides, dtype=getattr(torch, dtype),
                                      attention="reference")
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    variables = jax.jit(jax_tf.TransformerLM(jcfg).init)(jax.random.PRNGKey(seed),
                                                         jnp.zeros((1, 4), jnp.int32))
    return flax.core.meta.unbox(variables["params"])


def _port(tcfg, params):
    model = torch_tf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg),
                          strict=True)
    return model


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


@pytest.mark.parametrize("shape,n_feature_dims", [
    ((16, 8), 1), ((32, 4, 8), 2), ((4, 8, 64), 1), ((64, 256), 1),
])
def test_quantize_array_is_bit_equal_to_the_reference(shape, n_feature_dims):
    w = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    w[0] = 0.0  # an all-zero input row: the 1e-8 floor stays out of the way
    w.reshape(-1)[3] = 1e-12  # a tiny value rounds to 0 in both
    q_ref, s_ref = jax_quant.quantize_array(jnp.asarray(w), n_feature_dims)
    q, s = quant.quantize_array(w, n_feature_dims)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(s_ref).view(np.uint32))
    assert int(q.abs().max()) == 127


def test_quantize_array_of_an_all_zero_channel_uses_the_floor():
    w = np.zeros((8, 3), np.float32)
    w[:, 1] = np.linspace(-1, 1, 8)
    q_ref, s_ref = jax_quant.quantize_array(jnp.asarray(w), 1)
    q, s = quant.quantize_array(w, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert s[0] == np.float32(1e-8) / np.float32(127.0)


def test_quantize_lm_state_is_bit_equal_to_the_reference():
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg)
    _, qparams = jax_quant.quantize_lm(jax_tf.TransformerLM(jcfg), params)
    qcfg = torch_tf.TransformerConfig(**{**tcfg.__dict__, "quantized": True})
    want = convert.params_from_jax(jax.tree.map(np.asarray, qparams), qcfg)
    qmodel = quant.quantize_lm(_port(tcfg, params))
    got = qmodel.state_dict()
    assert set(got) == set(want)
    n_int8 = 0
    for name, tensor in got.items():
        assert tensor.dtype == want[name].dtype, name
        assert torch.equal(tensor, want[name]), name
        n_int8 += tensor.dtype == torch.int8
    # q/k/v/o, wi, wo of both layers and the lm_head
    assert n_int8 == 6 * TINY["n_layers"] + 1
    assert isinstance(qmodel.lm_head, quant.QuantDense)
    assert not any(p.requires_grad for n, p in qmodel.named_parameters()
                   if n.endswith(".weight") and p.dtype == torch.int8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_lm_logits_match_the_reference(dtype):
    jcfg, tcfg = _configs(dtype)
    params = _jax_params(jcfg)
    jmodel, jq = jax_quant.quantize_lm(jax_tf.TransformerLM(jcfg), params)
    tokens = _tokens()
    want = jax.jit(lambda p, t: jmodel.apply({"params": p}, t))(jq, jnp.asarray(tokens))
    qmodel = quant.quantize_lm(_port(tcfg, params))
    with torch.no_grad():
        got = qmodel(torch.tensor(tokens).long())
    _close(got.float().numpy(), np.asarray(want, np.float32), dtype)
    # the quantized model tracks the float one (the reference's own bound)
    with torch.no_grad():
        fp = _port(tcfg, params)(torch.tensor(tokens).long()).double().flatten()
    q = got.double().flatten()
    assert float(fp @ q / (fp.norm() * q.norm())) > 0.999


def _jax_decode(jmodel, params, calls):
    decoder = jax_decode._decode_model(jmodel)
    apply = jax.jit(lambda p, c, t: decoder.apply({"params": p, "cache": c}, t,
                                                  mutable=["cache"]))
    cache = jax_decode.init_cache(jmodel, calls[0].shape[0])
    out = []
    for tokens in calls:
        logits, mutated = apply(params, cache, jnp.asarray(tokens))
        cache = mutated["cache"]
        out.append(np.asarray(logits, np.float32))
    return out


@pytest.mark.parametrize("mode", ["fp", "int8", "kv_quant", "full_quant"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mode_variant_decodes_as_the_reference(mode, dtype):
    jcfg, tcfg = _configs(dtype)
    params = _jax_params(jcfg)
    jmodel, jparams = jax_quant.mode_variant(jax_tf.TransformerLM(jcfg), params, mode)
    model = _port(tcfg, params)
    twin = quant.mode_variant(model, mode)
    assert (twin is model) == (mode == "fp")
    assert twin.config.quantized == (mode in ("int8", "full_quant"))
    assert twin.config.quantized_kv_cache == (mode in ("kv_quant", "full_quant"))
    if mode == "kv_quant":
        # the KV twin shares the weights, it does not copy them
        assert twin.lm_head.weight.data_ptr() == model.lm_head.weight.data_ptr()
    tokens = _tokens(seed=3)
    calls = [tokens, tokens[:, :1], tokens[:, 1:2]]
    want = _jax_decode(jmodel, jparams, calls)
    cache = decode.init_cache(twin, 2)
    with torch.no_grad():
        got = [twin(torch.tensor(t).long(), cache=cache).float().numpy() for t in calls]
    for g, w in zip(got, want):
        _close(g, w, dtype)


def test_quantize_lm_refusals_match_the_reference():
    jcfg, tcfg = _configs(moe_experts=2)
    with pytest.raises(ValueError, match="MoE") as want:
        jax_quant.quantize_lm(jax_tf.TransformerLM(jcfg), _jax_params(jcfg))
    with pytest.raises(ValueError, match="MoE") as got:
        quant.quantize_lm(torch_tf.TransformerLM(tcfg, device="cpu"))
    assert str(got.value) == str(want.value)
    _, tcfg = _configs()
    lora_model = torch_tf.TransformerLM(
        torch_tf.TransformerConfig(**{**tcfg.__dict__, "lora_rank": 2}), device="cpu")
    with pytest.raises(ValueError, match="quantize_then_lora"):
        quant.quantize_lm(lora_model)
    with pytest.raises(ValueError, match="MoE"):
        quant.mode_variant(torch_tf.TransformerLM(_configs(moe_experts=2)[1], device="cpu"),
                           "int8")
    with pytest.raises(ValueError, match="unknown decode mode") as got:
        quant.mode_variant(lora_model, "int4")
    with pytest.raises(ValueError, match="unknown decode mode") as want:
        jax_quant.mode_variant(None, None, "int4")
    assert str(got.value) == str(want.value)
    assert quant.SERVING_MODES == jax_quant.SERVING_MODES


def test_linear_w8_plain_makes_the_reference_casts():
    """The plain twin rounds the product to the dtype, then multiplies by the
    scale rounded to the dtype: the reference's ``QuantDenseGeneral``."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    q, scale = jax_quant.quantize_array(jnp.asarray(w), 1)
    for dtype, tdtype in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = jax.jit(lambda a, k, s: jax.lax.dot_general(
            a.astype(dtype), k.astype(dtype), (((1,), (0,)), ((), ()))) * s.astype(dtype))(
            jnp.asarray(x), q, scale)
        from covalent_tpu_plugin_torch.ops import batch_invariant as bi

        got = bi.linear_w8_plain(torch.tensor(x), torch.tensor(np.asarray(q)).t().contiguous(),
                                 torch.tensor(np.asarray(scale)), tdtype)
        assert got.dtype == tdtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=0, atol=F32_ATOL if dtype == jnp.float32 else 0.05)
