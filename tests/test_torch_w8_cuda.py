"""The int8-weight batch-invariant product on the card.

The tests marked ``cuda`` need an NVIDIA card and skip without one.  The
file imports nothing of JAX, so a machine without JAX runs it without the
repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_w8_cuda.py

``csrc/bi_gemm_w8.cu`` reads the weight as int8 and widens it to bf16 on the
way to the tensor cores (exact), so it must compute, bit for bit, what
``bi_gemm_tc`` computes on ``q.to(bfloat16)`` followed by the reference's
scale step (``bf16(y_bf16 * bf16(scale))``, or ``y_f32 * scale`` for the
f32 lm_head): at M 1, 8, 128 and 1024 on the 125M LM's shapes, on both tile
shapes, and each row of a batch equal to the same row alone.
"""

import pytest
import torch

from covalent_tpu_plugin_torch.ops import _kernels
from covalent_tpu_plugin_torch.ops import batch_invariant as bi

pytestmark = pytest.mark.cuda

#: (K, N, output dtype): q/k/v/o, wi, wo and the lm_head of the 125M LM
SHAPES = [(768, 768, torch.bfloat16), (768, 3072, torch.bfloat16),
          (3072, 768, torch.bfloat16), (768, 32768, torch.float32)]
ROWS = [1, 8, 128, 1024]


@pytest.fixture()
def device():
    """The CUDA device; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel runs only there")
    return torch.device("cuda")


def _operands(m, k, n, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
    w = torch.randn(n, k, generator=g, device=device) * 0.02
    amax = w.abs().amax(dim=1).clamp_min(1e-8)
    scale = amax / 127.0
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return x, q, scale


def _twin(x, q, scale, dtype):
    """``bi_gemm_tc`` on the widened weight, then the scale step."""
    out = torch.empty(x.shape[0], q.shape[0], dtype=dtype, device=x.device)
    _kernels.bi_gemm(x, q.to(torch.bfloat16), out)
    return out * scale.to(dtype)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n,dtype", SHAPES, ids=lambda v: str(v).replace("torch.", ""))
def test_w8_product_is_bi_gemm_tc_on_the_widened_weight(device, k, n, dtype, m):
    x, q, scale = _operands(m, k, n, device, seed=m + n)
    before = _kernels.serving_launch_counts()["bi_gemm_w8"]
    got = bi.linear_w8(x, q, scale, dtype)
    assert _kernels.serving_launch_counts()["bi_gemm_w8"] == before + 1
    want = _twin(x, q, scale, dtype)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want), f"{int((got != want).sum())} elements differ"
    plan = _kernels.plan_bi_gemm(torch.bfloat16, torch.int8, (1, 1, 1, m, n, k))
    assert plan.route == "w8"
    # the plain twin computes the same function (another order of summation)
    plain = bi.linear_w8_plain(x.float(), q, scale, dtype).float()
    torch.testing.assert_close(got.float(), plain, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("k,n,dtype", SHAPES, ids=lambda v: str(v).replace("torch.", ""))
def test_w8_rows_are_batch_invariant(device, k, n, dtype):
    """Each row of a batch of 8, 128 and 1024 (skinny, skinny or wide by
    the shape, wide) equals that row alone, bit for bit."""
    x, q, scale = _operands(8, k, n, device, seed=k)
    wave = torch.cat([x, _operands(1016, k, n, device, seed=k + 1)[0]])
    whole = bi.linear_w8(wave, q, scale, dtype)
    for m in (8, 128, 1024):
        batch = bi.linear_w8(wave[:m], q, scale, dtype)
        assert torch.equal(batch, whole[:m]), m
        differ = [r for r in range(m)
                  if not torch.equal(bi.linear_w8(wave[r:r + 1], q, scale, dtype)[0], batch[r])]
        assert not differ, (m, differ[:8])


def test_w8_takes_a_bf16_scale_and_odd_k(device):
    """A scale already cast to bf16 (``inference_params`` after quantizing)
    and K off a multiple of 8 (copied onto runs, zero-padded) keep the
    equality."""
    x, q, scale = _operands(5, 100, 64, device, seed=3)
    got = bi.linear_w8(x, q, scale.to(torch.bfloat16), torch.bfloat16)
    assert torch.equal(got, _twin(x, q, scale.to(torch.bfloat16), torch.bfloat16))


def test_w8_refuses_f32_features_under_an_f32_product(device):
    x, q, scale = _operands(2, 64, 64, device, seed=4)
    with pytest.raises(ValueError, match="no kernel"):
        bi.linear_w8(x.float(), q, scale, torch.float32)
