"""The residual add folded into the norm after it, on the CPU.

The serving route takes each residual add and the RMSNorm after it in one
launch of ``csrc/bi_rmsnorm.cu`` (``ops.batch_invariant.add_rms_norm``);
on CPU tensors it takes ``add_rms_norm_plain``, the add and then the norm.
Here the plain version is held against the reference (``x + delta`` in
``jnp``, then the JAX package's ``RMSNorm``): the sum bit for bit, the norm
within one rounding of its type (``2**-7`` of the largest value for bf16,
``1e-4`` of it for f32: the sums of squares are taken in another order).
The model's wiring is held to its counts (a decode step of an n-layer LM
runs one norm alone and ``2 n`` fused ones) and to the route-off model's
bits.  The kernel runs only on the card: ``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covalent_tpu_plugin.models import transformer as jax_tf
from covalent_tpu_plugin_torch.models import decode
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.ops import _kernels
from covalent_tpu_plugin_torch.ops import batch_invariant as bi

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0**-7),
          "float32": (torch.float32, jnp.float32, 1e-4)}


def _to_jnp(t: torch.Tensor, dtype):
    return jnp.asarray(t.float().numpy()).astype(dtype)


@pytest.mark.parametrize("width", [64, 80, 768])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_add_rms_norm_plain_matches_the_reference(name, width):
    """``s`` bit-equal to the reference's residual add, ``y`` within one
    rounding of its ``RMSNorm`` of the sum."""
    tdtype, jdtype, tol = DTYPES[name]
    rng = np.random.default_rng(width)
    x = torch.tensor(rng.standard_normal((3, 5, width), dtype=np.float32) * 2.0).to(tdtype)
    delta = torch.tensor(rng.standard_normal((3, 5, width), dtype=np.float32)).to(tdtype)
    scale = torch.tensor(1.0 + 0.5 * rng.standard_normal(width, dtype=np.float32))
    s, y = bi.add_rms_norm_plain(x, delta, scale, tdtype)
    want_s = _to_jnp(x, jdtype) + _to_jnp(delta, jdtype)
    want_y = jax_tf.RMSNorm(jdtype).apply({"params": {"scale": jnp.asarray(scale.numpy())}},
                                          want_s)
    assert s.dtype == y.dtype == tdtype
    assert np.array_equal(s.float().numpy(), np.asarray(want_s.astype(jnp.float32)))
    want_y = np.asarray(want_y.astype(jnp.float32))
    err = np.abs(y.float().numpy() - want_y).max()
    assert err <= tol * np.abs(want_y).max(), (name, width, err)


def test_add_rms_norm_takes_the_plain_version_on_cpu():
    """CPU tensors take the plain version and launch nothing; the fused
    kernel's wrapper refuses CPU tensors."""
    rng = np.random.default_rng(1)
    x, delta = (torch.tensor(rng.standard_normal((4, 80), dtype=np.float32)) for _ in "xd")
    scale = torch.ones(80)
    _kernels.reset_launch_counts()
    got, want = bi.add_rms_norm(x, delta, scale, torch.float32), \
        bi.add_rms_norm_plain(x, delta, scale, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _kernels.serving_launch_counts()["bi_rmsnorm"] == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.bi_add_rmsnorm(x, delta, scale, torch.float32, 1e-6)


TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=32)


@pytest.fixture()
def norm_recorder(monkeypatch):
    """CPU tensors sent down the kernel route with every kernel replaced by
    its plain version; the norm's two entry points record their calls."""
    calls = []

    def norm(x, scale, dtype, eps):
        calls.append("norm")
        return bi.rms_norm_plain(x, scale, dtype, eps)

    def add_norm(x, delta, scale, dtype, eps):
        calls.append("add_norm")
        return bi.add_rms_norm_plain(x, delta, scale, dtype, eps)

    monkeypatch.setattr(bi, "_route", lambda x: True)
    for name in ("linear", "attention_scores", "attention_mix"):
        monkeypatch.setattr(bi, name, getattr(bi, name + "_plain"))
    monkeypatch.setattr(bi._kernels, "bi_rmsnorm", norm)
    monkeypatch.setattr(bi._kernels, "bi_add_rmsnorm", add_norm)
    return calls


def test_decode_step_fuses_every_residual_add_into_the_next_norm(norm_recorder):
    """With the route on, a decode step of a 2-layer LM runs the norm alone
    once (layer 0's ``ln_attn``) and fused four times (``ln_mlp`` twice, layer
    1's ``ln_attn``, ``ln_final``); its logits are the route-off model's,
    bit for bit."""
    routed = decode.inference_params(torch_tf.TransformerLM(
        torch_tf.TransformerConfig(**TINY), device="cpu",
        generator=torch.Generator().manual_seed(3)))
    plain = torch_tf.TransformerLM(routed.config, device="cpu")
    plain.load_state_dict(routed.state_dict())
    torch_tf.use_batch_invariant(routed)
    rng = np.random.default_rng(4)
    prompt = torch.as_tensor(rng.integers(0, 256, (3, 6)))
    step = torch.as_tensor(rng.integers(0, 256, (3, 1)))
    logits = []
    with torch.no_grad():
        for model in (routed, plain):
            cache = decode.init_cache(model, 3)
            model(prompt, cache=cache)
            norm_recorder.clear()
            logits.append(model(step, cache=cache))
            if model is routed:
                assert sorted(norm_recorder) == ["add_norm"] * 4 + ["norm"], norm_recorder
                assert norm_recorder[0] == "norm"
    assert norm_recorder == []  # the route-off model calls no kernel
    assert torch.equal(logits[0], logits[1])


def test_plain_route_runs_the_layer_ops_in_their_order():
    """Off the route (training), the model's features and gradients are
    the bits of the layer ops run one by one as the reference orders them:
    ``x + attention(ln_attn(x))``, ``x + mlp(ln_mlp(x))``, ``ln_final``."""
    model = torch_tf.TransformerLM(torch_tf.TransformerConfig(**TINY, dtype=torch.float32),
                                   device="cpu", generator=torch.Generator().manual_seed(5))
    tokens = torch.as_tensor(np.random.default_rng(6).integers(0, 256, (2, 9)))

    def by_hand():
        x = torch.nn.functional.embedding(tokens, model.embedding)
        for layer in model.layers:
            x = x + layer.attention(layer.ln_attn(x))
            x = x + layer.mlp(layer.ln_mlp(x))
        return model.ln_final(x)

    grads = []
    for fn in (lambda: model(tokens, return_features=True), by_hand):
        model.zero_grad()
        feats = fn()
        (feats.float() ** 2).sum().backward()
        grads.append((feats.detach(), [p.grad.clone() for p in model.parameters()
                                       if p.grad is not None]))
    assert torch.equal(grads[0][0], grads[1][0])
    assert len(grads[0][1]) == len(grads[1][1]) == len(list(model.parameters())) - 1
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))
