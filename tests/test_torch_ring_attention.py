"""Sequence-parallel attention of the port against the reference's, on the CPU.

The reference runs ``sequence_parallel_attention`` on global (B, H, S, D)
arrays under ``shard_map`` over a virtual CPU mesh of ``seq`` = 2 and 4
(``tests/conftest.py``), its flash ring and Ulysses through the Pallas
kernels in interpret mode.  The port runs the same cases as a gloo gang of
2 and of 4 processes (``parallel.launch.run_gang``, one gang per world),
each rank on its shard of the same numpy inputs (striped first where the
layout is zigzag); the test joins the ranks' outputs and gradients and
holds them against the reference's at the bounds of
``tests/test_torch_attention.py``: f32 atol 1e-5 on outputs, 1e-4 on q/k/v
gradients (of ``sum(out * g)``).

Cases: the einsum ring, the flash ring and Ulysses; causal and not, zigzag
and contiguous; GQA (the flash ring and Ulysses; the reference's einsum
block needs equal heads); a window of 24 over 16-token shards, which cuts
the 4-ring to 3 of its 4 hops and makes the flash ring's backward re-home
the dK/dV partials (``__graft_entry__.py``'s windowed dry run); Ulysses
with a window and sinks.  Then the reference's refusals with equal
messages, and the plain f32-output versions of the three flash sweeps
against the reference's ``_flash_forward(..., out_dtype=f32)`` and
``_flash_backward(..., delta=, grad_dtype=f32)`` on bf16 inputs at a 2-ring
hop's positions (atol 4e-3 = 2^-8: one bf16 rounding of P before PV may land
on the neighbouring value).
"""

import functools
import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covalent_tpu_plugin.ops import attention as jax_attention
from covalent_tpu_plugin.ops.ring_attention import (
    _ring_steps as jax_ring_steps,
)
from covalent_tpu_plugin.ops.ring_attention import (
    _shard_indices as jax_shard_indices,
)
from covalent_tpu_plugin.ops.ring_attention import (
    sequence_parallel_attention as jax_spa,
)
from covalent_tpu_plugin.ops.ring_attention import (
    stripe_sequence as jax_stripe,
)
from covalent_tpu_plugin.parallel import MeshPlan as RefPlan
from covalent_tpu_plugin.parallel import make_mesh as ref_make_mesh
from covalent_tpu_plugin_torch.ops import attention as torch_attention
from covalent_tpu_plugin_torch.ops.ring_attention import (
    _ring_steps,
    _shard_indices,
    default_zigzag,
    stripe_sequence,
    unstripe_sequence,
)
from covalent_tpu_plugin_torch.parallel.launch import run_gang

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4
VARIANT_ATOL = 2.0**-8
BATCH, HEADS, DIM = 2, 4, 16

#: name -> (ring size, sequence length, kv heads, keyword arguments)
CASES = {
    "einsum_zigzag_2": (2, 32, 4, dict(impl="einsum")),
    "einsum_full_2": (2, 32, 4, dict(impl="einsum", causal=False)),
    "flash_zigzag_2": (2, 32, 4, dict(impl="flash")),
    "flash_contiguous_gqa_2": (2, 32, 2, dict(impl="flash", zigzag=False)),
    "flash_full_gqa_2": (2, 32, 2, dict(impl="flash", causal=False)),
    "ulysses_2": (2, 32, 4, dict(impl="ulysses")),
    "ulysses_window_sinks_gqa_2": (2, 32, 2, dict(impl="ulysses", window=12, sinks=2)),
    "einsum_window_truncated_4": (4, 64, 4, dict(impl="einsum", window=24)),
    "flash_window_truncated_4": (4, 64, 4, dict(impl="flash", window=24)),
    "flash_zigzag_gqa_4": (4, 64, 2, dict(impl="flash")),
    "ulysses_4": (4, 64, 4, dict(impl="ulysses")),
}
RINGS = (2, 4)


def _inputs(name: str):
    n, seq, kv_heads, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    shapes = ((BATCH, HEADS, seq, DIM), (BATCH, kv_heads, seq, DIM),
              (BATCH, kv_heads, seq, DIM), (BATCH, HEADS, seq, DIM))
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _layout(name: str) -> bool:
    """Whether the case's shards are zigzag-striped (the reference's rule
    unless the case names one)."""
    n, seq, _, kwargs = CASES[name]
    zigzag = kwargs.get("zigzag")
    if zigzag is None:
        zigzag = default_zigzag(kwargs.get("causal", True), n, seq, kwargs.get("window"),
                                kwargs["impl"])
    return zigzag


def _rank_cases(cases: dict, zigzags: dict) -> dict:
    """One rank of the gang: each case's output and q/k/v gradients on this
    rank's shards; then the refusals' messages."""
    import torch
    import torch.distributed as dist

    from covalent_tpu_plugin_torch.ops.ring_attention import (
        sequence_parallel_attention,
        stripe_sequence,
    )
    from covalent_tpu_plugin_torch.parallel.mesh import MeshPlan, make_mesh

    n = dist.get_world_size()
    mesh = make_mesh(MeshPlan(seq=n), device_type="cpu")
    me = mesh.get_local_rank("seq")
    out = {}
    for name, (arrays, kwargs) in cases.items():
        tensors = [torch.tensor(a) for a in arrays]
        if zigzags[name]:
            tensors = [stripe_sequence(t, n) for t in tensors]
        span = tensors[0].shape[2] // n
        q, k, v, g = (t[:, :, me * span:(me + 1) * span].contiguous() for t in tensors)
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        result = sequence_parallel_attention(q, k, v, mesh, **kwargs)
        (result * g).sum().backward()
        out[name] = [t.detach().numpy() for t in (result, q.grad, k.grad, v.grad)]
    refusals = {}
    for label, (heads, seq_local, kwargs) in REFUSALS.items():
        x = torch.zeros(1, heads, seq_local, DIM)
        try:
            sequence_parallel_attention(x, x, x, mesh, **kwargs)
        except ValueError as exc:
            refusals[label] = str(exc)
    out["refusals"] = refusals
    return out


#: label -> (heads, a rank's sequence length, keyword arguments): what the
#: reference refuses (a global sequence of 9 n tokens does not split into 2n
#: stripes)
REFUSALS = {
    "sinks_with_ring": (4, 16, dict(impl="flash", window=8, sinks=2)),
    "indivisible_heads": (3, 16, dict(impl="ulysses")),
    "zigzag_indivisible": (4, 9, dict(impl="einsum", zigzag=True)),
    "window_not_causal": (4, 16, dict(impl="einsum", causal=False, window=8)),
    "unknown_impl": (4, 16, dict(impl="dense")),
}


@functools.lru_cache(maxsize=None)
def _reference_case(name: str):
    n, _, _, kwargs = CASES[name]
    mesh = ref_make_mesh(RefPlan(seq=n), jax.devices()[:n])
    q, k, v, g = (jnp.asarray(a) for a in _inputs(name))

    def loss(q, k, v):
        out = jax_spa(q, k, v, mesh, **kwargs)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return [np.asarray(t) for t in (out, *grads)]


def _reference_refusal(n: int, label: str) -> str:
    heads, seq_local, kwargs = REFUSALS[label]
    mesh = ref_make_mesh(RefPlan(seq=n), jax.devices()[:n])
    x = jnp.zeros((1, heads, seq_local * n, DIM), jnp.float32)
    with pytest.raises(ValueError) as exc:
        jax_spa(x, x, x, mesh, **kwargs)
    return str(exc.value)


@pytest.fixture(scope="module")
def port():
    """Every case on the gang of its ring size: one gang of 2, one of 4."""
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        runs = {}
        for n in RINGS:
            cases = {name: (_inputs(name), CASES[name][3]) for name in CASES
                     if CASES[name][0] == n}
            zigzags = {name: _layout(name) for name in cases}
            runs[n] = run_gang(_rank_cases, n, (cases, zigzags), timeout_s=300)
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    return runs


def _joined(ranks: list, name: str) -> list:
    """The ranks' outputs and gradients along the sequence, in natural order."""
    n = CASES[name][0]
    joined = [np.concatenate([rank[name][i] for rank in ranks], axis=2) for i in range(4)]
    if _layout(name):
        joined = [unstripe_sequence(torch.tensor(t), n).numpy() for t in joined]
    return joined


@pytest.mark.parametrize("name", list(CASES))
def test_output_matches_the_reference(port, name):
    got = _joined(port[CASES[name][0]], name)[0]
    want = _reference_case(name)[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_the_reference(port, name):
    got = _joined(port[CASES[name][0]], name)[1:]
    want = _reference_case(name)[1:]
    for label, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_ATOL, err_msg=label)


@pytest.mark.parametrize("label", list(REFUSALS))
def test_refusals_match_the_reference(port, label):
    for n in RINGS:
        for rank in port[n]:
            assert rank["refusals"][label] == _reference_refusal(n, label)


def test_the_window_truncates_the_4_ring():
    """The windowed cases run 3 of 4 hops (so the flash ring re-homes its
    dK/dV partials), as the reference's ring does."""
    assert _ring_steps(4, 16, 24, False) == jax_ring_steps(4, 16, 24, False) == 3
    assert _ring_steps(4, 16, 24, True) == jax_ring_steps(4, 16, 24, True) == 4
    assert _ring_steps(2, 16, None, False) == 2


@pytest.mark.parametrize("n, seq_local, zigzag", [(2, 16, True), (4, 8, True), (4, 8, False)])
def test_shard_indices_and_stripes_match_the_reference(n, seq_local, zigzag):
    for shard in range(n):
        want = np.asarray(jax_shard_indices(jnp.int32(shard), n, seq_local, zigzag))
        np.testing.assert_array_equal(_shard_indices(shard, n, seq_local, zigzag), want)
    x = np.arange(2 * n * seq_local, dtype=np.float32).reshape(1, 1, -1, 1)
    striped = stripe_sequence(torch.tensor(x), n)
    np.testing.assert_array_equal(striped.numpy(), np.asarray(jax_stripe(jnp.asarray(x), n)))
    np.testing.assert_array_equal(unstripe_sequence(striped, n).numpy(), x)


def _hop_inputs():
    """bf16 inputs of one hop of a 2-ring: q at rank 0's stripes, k and v at
    rank 1's (zigzag), causal; dO for the backward."""
    rng = np.random.default_rng(5)
    shape = (1, 2, 128, 64)
    arrays = [rng.standard_normal(shape, dtype=np.float32) for _ in range(4)]
    qpos = _shard_indices(0, 2, 128, True)
    kpos = _shard_indices(1, 2, 128, True)
    return arrays, qpos, kpos


def _bf16(arrays):
    return ([torch.tensor(a).to(torch.bfloat16) for a in arrays],
            [jnp.asarray(a, jnp.bfloat16) for a in arrays])


def test_plain_f32_forward_matches_the_reference_kernel():
    arrays, qpos, kpos = _hop_inputs()
    (q, k, v, _), (jq, jk, jv, _) = _bf16(arrays)
    out, lse = torch_attention.flash_fwd_plain(q, k, v, torch.tensor(qpos), torch.tensor(kpos),
                                               True, None, 0, torch.float32)
    want, want_lse = jax_attention._flash_forward(
        jq, jk, jv, jnp.asarray(qpos), jnp.asarray(kpos), True, None, None, True,
        out_dtype=jnp.float32)
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=VARIANT_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], rtol=0, atol=1e-5)


def test_plain_f32_backward_matches_the_reference_kernels():
    """Both sides get the reference forward's out and lse, and one delta."""
    arrays, qpos, kpos = _hop_inputs()
    (q, k, v, g), (jq, jk, jv, jg) = _bf16(arrays)
    jqpos, jkpos = jnp.asarray(qpos), jnp.asarray(kpos)
    out, lse = jax_attention._flash_forward(jq, jk, jv, jqpos, jkpos, True, None, None, True)
    delta = jnp.sum(jg.astype(jnp.float32) * out.astype(jnp.float32), axis=-1, keepdims=True)
    want = jax_attention._flash_backward(jq, jk, jv, out, lse, jg, jqpos, jkpos, True, True,
                                         delta=delta, grad_dtype=jnp.float32)
    args = (q, k, v, g, torch.tensor(np.asarray(lse)[..., 0]),
            torch.tensor(np.asarray(delta)[..., 0]), torch.tensor(qpos), torch.tensor(kpos),
            True, None, 0, torch.float32)
    dk, dv = torch_attention.flash_bwd_dkdv_plain(*args)
    dq = torch_attention.flash_bwd_dq_plain(*args)
    for label, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == torch.float32 and ref.dtype == jnp.float32, label
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=VARIANT_ATOL,
                                   err_msg=label)


def test_the_default_dtype_is_the_inputs():
    arrays, qpos, kpos = _hop_inputs()
    (q, k, v, g), _ = _bf16(arrays)
    out, lse = torch_attention.flash_fwd_plain(q, k, v, None, None, True, None, 0)
    f32, _ = torch_attention.flash_fwd_plain(q, k, v, None, None, True, None, 0, torch.float32)
    assert out.dtype == torch.bfloat16
    # the f32 variant is the same value before its last rounding
    assert torch.equal(f32.to(torch.bfloat16), out)
