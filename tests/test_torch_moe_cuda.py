"""The MoE's serving form on the card.

The tests marked ``cuda`` need an NVIDIA card and skip without one.  The
file imports nothing of JAX, so a machine without JAX runs it without the
repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_moe_cuda.py

The expert products (``ops.batch_invariant.linear_rows``) are one launch
of ``csrc/bi_gemm_tc.cu`` with the experts as its batch and each expert's
slots stacked as rows: each expert's output must be, bit for bit, what the
kernel computes for that expert alone, and close to the plain twin (cuBLAS,
another order of summation).  An MoE block on the batch-invariant route,
routed per row as the serving engine's lanes, must give each row the same
bits in a batch of 1, 3 or 8, at a decode step and at a prefill wave, on
the 125M LM's widths (8 experts, d_model 768, d_ff 3072, bf16).
"""

import pytest
import torch

from covalent_tpu_plugin_torch.models import decode, serve
from covalent_tpu_plugin_torch.models.moe import MoEMlp
from covalent_tpu_plugin_torch.models.transformer import TransformerLM, lm_125m_config
from covalent_tpu_plugin_torch.ops import _kernels
from covalent_tpu_plugin_torch.ops import batch_invariant as bi

pytestmark = pytest.mark.cuda

EXPERTS, D_MODEL, D_FF = 8, 768, 3072
#: one bf16 rounding of the output (sums in another order), twice, of the
#: largest plain value
PRODUCT_TOL = 2.0**-7
#: the block rounds three times after the products (h, the expert output,
#: the gate's product): four roundings of its largest plain value
BLOCK_TOL = 2.0**-6


@pytest.fixture()
def device():
    """The CUDA device; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel runs only there")
    return torch.device("cuda")


def _randn(shape, device, seed, std=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * std).to(torch.bfloat16)


@pytest.mark.parametrize("rows", [1, 8, 160])
@pytest.mark.parametrize("k,n", [(D_MODEL, D_FF), (D_FF, D_MODEL)], ids=["wi", "wo"])
def test_expert_product_is_each_experts_bi_gemm_tc(device, rows, k, n):
    x = _randn((EXPERTS, rows, k), device, seed=rows)
    w = _randn((EXPERTS, n, k), device, seed=k, std=0.02)
    before = _kernels.serving_launch_counts()["bi_gemm_tc"]
    got = bi.linear_rows(x, w, torch.bfloat16)
    assert _kernels.serving_launch_counts()["bi_gemm_tc"] == before + 1
    for e in range(EXPERTS):
        alone = torch.empty(rows, n, dtype=torch.bfloat16, device=device)
        _kernels.bi_gemm(x[e], w[e], alone)
        assert torch.equal(got[e], alone), e
    plain = bi.linear_rows_plain(x, w, torch.bfloat16).float()
    err = (got.float() - plain).abs().max().item()
    assert err <= PRODUCT_TOL * max(1.0, plain.abs().max().item()), err


def _block(device, capacity_factor=1.25):
    config = lm_125m_config(moe_experts=EXPERTS, moe_capacity_factor=capacity_factor)
    module = MoEMlp(config, device, torch.Generator(device=device).manual_seed(0))
    for param in module.parameters():
        param.data = param.data.to(torch.bfloat16)
    module.batch_invariant = True
    return module


@pytest.mark.parametrize("seq", [1, 128], ids=["decode_step", "wave"])
def test_moe_block_rows_are_batch_invariant(device, seq):
    module = _block(device)
    x = _randn((8, seq, D_MODEL), device, seed=seq)
    counts = _kernels.serving_launch_counts()
    with torch.no_grad():
        whole = module(x, per_row=True)
        after = _kernels.serving_launch_counts()
        assert after["bi_gemm"] == counts["bi_gemm"] + 1          # the f32 router
        assert after["bi_gemm_tc"] == counts["bi_gemm_tc"] + 2    # the two expert products
        for size in (1, 3):
            for start in range(0, 8 - size + 1, size):
                part = module(x[start:start + size], per_row=True)
                assert torch.equal(part, whole[start:start + size]), (size, start)
        module.batch_invariant = False
        plain = module(x, per_row=True).float()
    err = (whole.float() - plain).abs().max().item()
    assert err <= BLOCK_TOL * plain.abs().max().item(), err
    # the weights were re-laid k-contiguous on the first call, once
    assert module.wi.transpose(1, 2).is_contiguous() and module.wo.transpose(1, 2).is_contiguous()


def test_a_kv_quant_twin_shares_the_relaid_experts(device):
    """The serving route lays the experts out before the engine builds its
    lane groups, so the ``kv_quant`` twin shares the weights it decodes
    with (no second copy of the experts on the card)."""
    config = lm_125m_config(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                            max_seq=64, moe_experts=4)
    model = decode.inference_params(TransformerLM(
        config, device=device, generator=torch.Generator(device=device).manual_seed(0)))
    engine = serve.ContinuousEngine(model, max_batch=2, decode_modes=("fp", "kv_quant"))
    twin = engine.group("kv_quant")._model
    for ours, theirs in zip(model.layers, twin.layers):
        for name in ("wi", "wo"):
            mine, shared = getattr(ours.mlp, name), getattr(theirs.mlp, name)
            assert mine.transpose(1, 2).is_contiguous()
            assert shared.data_ptr() == mine.data_ptr(), name
    engine.close()
