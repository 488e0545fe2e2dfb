"""The port's attention against the reference's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The port's
``flash_attention`` runs its plain PyTorch sweeps here (CPU tensors); the
reference runs ``mha_reference`` and its Pallas ``flash_attention`` in
interpret mode.  Tolerances (float32): atol 1e-5 on outputs, 1e-4 on
gradients, which sum over up to 256 positions in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covalent_tpu_plugin.ops import attention as jax_attention
from covalent_tpu_plugin_torch.ops import _kernels
from covalent_tpu_plugin_torch.ops import attention as torch_attention

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4


def _inputs(seed, batch, heads, kv_heads, seq_q, seq_k, dim):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, heads, seq_q, dim), dtype=np.float32)
    k = rng.standard_normal((batch, kv_heads, seq_k, dim), dtype=np.float32)
    v = rng.standard_normal((batch, kv_heads, seq_k, dim), dtype=np.float32)
    g = rng.standard_normal((batch, heads, seq_q, dim), dtype=np.float32)
    return q, k, v, g


def _torch_grads(fn, q, k, v, g):
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fn(qt, kt, vt)
    (out * torch.tensor(g)).sum().backward()
    return out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()


def _jax_grads(fn, q, k, v, g):
    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    return (np.asarray(out), *(np.asarray(x) for x in grads))


def _close(got, want, atol):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def _striped_positions(seq_q, seq_k):
    """A zigzag-like query order and every other key position: each query
    sees key position 0, so no row is wholly masked."""
    rng = np.random.default_rng(7)
    return (rng.permutation(seq_q).astype(np.int32),
            (2 * np.arange(seq_k)).astype(np.int32))


CASES = {
    "causal_mha": dict(shape=(1, 4, 4, 256, 256, 32), causal=True),
    "full": dict(shape=(1, 4, 4, 256, 256, 32), causal=False),
    "gqa": dict(shape=(1, 4, 2, 256, 256, 32), causal=True),
    "window": dict(shape=(1, 4, 2, 256, 256, 32), causal=True, window=64),
    "window_sinks": dict(shape=(1, 4, 2, 256, 256, 32), causal=True, window=64, sinks=4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_matches_reference_and_pallas(name):
    case = CASES[name]
    q, k, v, g = _inputs(0, *case["shape"])
    opts = {key: case[key] for key in ("window", "sinks") if key in case}
    causal = case["causal"]

    port = _torch_grads(
        lambda q, k, v: torch_attention.flash_attention(q, k, v, causal, **opts),
        q, k, v, g,
    )
    oracle = _jax_grads(
        lambda q, k, v: jax_attention.mha_reference(q, k, v, causal, **opts),
        q, k, v, g,
    )
    pallas = _jax_grads(
        lambda q, k, v: jax_attention.flash_attention(q, k, v, causal, **opts),
        q, k, v, g,
    )
    for want in (oracle, pallas):
        _close(port[:1], want[:1], FWD_ATOL)
        _close(port[1:], want[1:], GRAD_ATOL)


def test_flash_explicit_positions_and_uneven_lengths_match_pallas():
    q, k, v, g = _inputs(1, 1, 4, 2, 256, 128, 32)
    qpos, kpos = _striped_positions(256, 128)
    port = _torch_grads(
        lambda q, k, v: torch_attention.flash_attention(
            q, k, v, q_positions=torch.tensor(qpos), k_positions=torch.tensor(kpos)
        ),
        q, k, v, g,
    )
    pallas = _jax_grads(
        lambda q, k, v: jax_attention.flash_attention(
            q, k, v, q_positions=jnp.asarray(qpos), k_positions=jnp.asarray(kpos)
        ),
        q, k, v, g,
    )
    _close(port[:1], pallas[:1], FWD_ATOL)
    _close(port[1:], pallas[1:], GRAD_ATOL)


@pytest.mark.parametrize("window,sinks", [(None, 0), (48, 0), (48, 3)])
def test_mha_reference_matches(window, sinks):
    q, k, v, g = _inputs(2, 2, 4, 2, 128, 128, 16)
    port = _torch_grads(
        lambda q, k, v: torch_attention.mha_reference(q, k, v, window=window, sinks=sinks),
        q, k, v, g,
    )
    ref = _jax_grads(
        lambda q, k, v: jax_attention.mha_reference(q, k, v, window=window, sinks=sinks),
        q, k, v, g,
    )
    _close(port[:1], ref[:1], FWD_ATOL)
    _close(port[1:], ref[1:], GRAD_ATOL)


def test_plain_lse_matches_pallas_forward():
    """The forward's second output, the per-row log-sum-exp, is what both
    backward sweeps rebuild probabilities from."""
    q, k, v, _ = _inputs(3, 1, 4, 4, 256, 256, 32)
    _, lse = torch_attention.flash_fwd_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), None, None, True, 64, 4
    )
    _, jax_lse = jax_attention._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, True,
        None, None, True, window=64, sinks=4,
    )
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax_lse)[..., 0], rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("requested,seq_len", [(512, 4098), (1024, 1000), (512, 384), (64, 100)])
def test_fit_block_matches_reference(requested, seq_len):
    try:
        want = jax_attention._fit_block(requested, seq_len)
    except ValueError as err:
        with pytest.raises(ValueError) as port_err:
            torch_attention._fit_block(requested, seq_len)
        assert str(port_err.value) == str(err)
    else:
        assert torch_attention._fit_block(requested, seq_len) == want


def test_flash_refuses_what_the_reference_refuses():
    q = torch.zeros(1, 1, 4098, 16)
    with pytest.raises(ValueError) as port_err:
        torch_attention.flash_attention(q, q, q)
    with pytest.raises(ValueError) as ref_err:
        jax_attention.flash_attention(*(jnp.zeros((1, 1, 4098, 16)),) * 3)
    assert str(port_err.value) == str(ref_err.value)

    q = torch.zeros(1, 1, 256, 16)
    with pytest.raises(ValueError, match="must be divisible by block sizes"):
        torch_attention.flash_attention(q, q, q, block_q=96)
    with pytest.raises(ValueError, match="GQA needs query heads"):
        torch_attention.flash_attention(q, torch.zeros(1, 2, 256, 16), q)
    with pytest.raises(ValueError, match="requires causal"):
        torch_attention.flash_attention(q, q, q, causal=False, window=8)
    with pytest.raises(ValueError, match="require a window"):
        torch_attention.flash_attention(q, q, q, sinks=2)


def test_band_tile_needed_matches_reference():
    rng = np.random.default_rng(4)
    for _ in range(200):
        qpos = rng.integers(0, 512, 16)
        kpos = rng.integers(0, 512, 16)
        causal = bool(rng.integers(0, 2))
        window = int(rng.integers(1, 128)) if causal and rng.integers(0, 2) else None
        sinks = int(rng.integers(0, 8)) if window else 0
        want = bool(jax_attention._band_tile_needed(
            jnp.asarray(qpos), jnp.asarray(kpos), causal, window, sinks
        ))
        got = torch_attention._band_tile_needed(
            torch.tensor(qpos), torch.tensor(kpos), causal, window, sinks
        )
        assert got == want


def test_kernel_wrappers_refuse_cpu_and_bad_inputs():
    q = torch.zeros(1, 2, 64, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_fwd(q, q, q, None, None, True, None, 0)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_bwd_dq(q, q, q, q, lse, lse, None, None, True, None, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_bwd_dkdv(q, q, q, q, lse, lse, None, None, True, None, 0)
    assert set(_kernels.launch_counts()) == {"flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"}


def test_flash_dispatch_is_by_device():
    """CPU tensors take the plain sweeps and launch nothing."""
    _kernels.reset_launch_counts()
    q, k, v, g = _inputs(5, 1, 2, 2, 128, 128, 16)
    _torch_grads(lambda q, k, v: torch_attention.flash_attention(q, k, v), q, k, v, g)
    assert _kernels.launch_counts() == {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        torch_attention._pick(None, None, torch.zeros(1, device="meta"))
