"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  The file imports neither JAX nor the reference package, so on a
machine with the card and without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The autograd path of ``flash_attention`` on CUDA tensors (the three kernels)
is held against the same path on CPU tensors (their plain versions), in
float32: atol 1e-5 on outputs, 1e-4 on gradients, which sum over up to 256
positions in another order.
"""

import numpy as np
import pytest
import torch

from covalent_tpu_plugin_torch.ops import _kernels
from covalent_tpu_plugin_torch.ops import attention as torch_attention

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4

CASES = {
    "causal_mha": dict(shape=(1, 4, 4, 256, 256, 32), causal=True),
    "full_d64": dict(shape=(2, 4, 4, 192, 256, 64), causal=False),
    "gqa_d128": dict(shape=(1, 4, 2, 256, 256, 128), causal=True),
    "window_sinks": dict(shape=(1, 4, 2, 256, 256, 32), causal=True, window=64, sinks=4),
    "positions": dict(shape=(1, 4, 2, 256, 128, 16), causal=True, positions=True),
}


@pytest.fixture()
def card():
    """The CUDA device; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _run(device, case, seed=0):
    batch, heads, kv_heads, seq_q, seq_k, dim = case["shape"]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s, dtype=np.float32) for s in (
        (batch, heads, seq_q, dim), (batch, kv_heads, seq_k, dim),
        (batch, kv_heads, seq_k, dim), (batch, heads, seq_q, dim),
    )]
    opts = {key: case[key] for key in ("window", "sinks") if key in case}
    if case.get("positions"):
        # a shuffled query order and every other key position: each query
        # sees key position 0, so no row is wholly masked
        opts["q_positions"] = torch.tensor(rng.permutation(seq_q).astype(np.int32))
        opts["k_positions"] = torch.tensor((2 * np.arange(seq_k)).astype(np.int32))
    q, k, v = (torch.tensor(a, device=device, requires_grad=True) for a in arrays[:3])
    out = torch_attention.flash_attention(q, k, v, case["causal"], **opts)
    (out * torch.tensor(arrays[3], device=device)).sum().backward()
    return [t.detach().cpu().numpy() for t in (out, q.grad, k.grad, v.grad)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_plain_on_the_card(card, name):
    _kernels.reset_launch_counts()
    got = _run(card, CASES[name])
    torch.cuda.synchronize()
    assert _kernels.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkdv": 1, "flash_bwd_dq": 1}
    want = _run("cpu", CASES[name])
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=FWD_ATOL if i == 0 else GRAD_ATOL)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.zeros(1, 2, 64, 48, device=card)
    with pytest.raises(ValueError, match="head_dim 48"):
        _kernels.flash_fwd(q, q, q, None, None, True, None, 0)
    q = torch.zeros(1, 2, 64, 32, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.flash_fwd(q, q.transpose(2, 3).contiguous().transpose(2, 3), q,
                           None, None, True, None, 0)
    with pytest.raises(ValueError, match="dtype"):
        _kernels.flash_fwd(q, q.half(), q, None, None, True, None, 0)
