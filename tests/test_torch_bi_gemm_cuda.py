"""The f32-operand batch-invariant product (``csrc/bi_gemm.cu``) on the card.

The tests marked ``cuda`` need an NVIDIA card and skip without one.  The
file imports nothing of JAX, so a machine without JAX runs it without the
repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_bi_gemm_cuda.py

The route sums every output element in one order fixed by K (FMA chains
over segments of 64, added in segment order), whichever tile takes it: each
row of a batch of 8, 128 and 1024 is the same row computed alone, bit for
bit, across the switch between the skinny and the wide tiles.  Against the
plain version (``F.linear`` / ``einsum`` in f32, TF32 off) the sums differ
only in order: ``F32_TOL`` of the largest value, at least 1, for an f32
output, one bf16 rounding (``BF16_TOL``) for a bf16 output.
"""

import pytest
import torch

from covalent_tpu_plugin_torch.ops import _kernels
from covalent_tpu_plugin_torch.ops import batch_invariant as bi

pytestmark = pytest.mark.cuda

#: f32 sums in another order: a few ulps of the largest partial sum
F32_TOL = 1e-4
#: the f32 total rounded to bf16 once; the plain side rounds its own total
BF16_TOL = 2.0**-7

#: (N, K, weight dtype): the MoE's router, the lm_head on f32 features, an
#: f32 model's q/k/v/o, MLP wi and wo
SHAPES = {"router": (8, 768, torch.bfloat16), "lm_head": (32768, 768, torch.bfloat16),
          "f32_qkvo": (768, 768, torch.float32), "f32_mlp_wi": (3072, 768, torch.float32),
          "f32_mlp_wo": (768, 3072, torch.float32)}


@pytest.fixture()
def device():
    """The CUDA device; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen, device=gen.device) * scale).to(dtype)


def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    bound = tol * max(1.0, want.float().abs().max().item())
    assert err <= bound, f"max abs err {err} > {bound}"


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_f32_route_matches_plain_and_rows_are_batch_invariant(device, name):
    """Every row of a batch of 8, 128 and 1024 equals that row alone (the
    skinny tiles at M 1; at 1024 the lm_head's wide tiles), and the batch is
    within ``F32_TOL`` of the plain version."""
    n, k, wdtype = SHAPES[name]
    gen = torch.Generator(device=device).manual_seed(n + k)
    w = _randn(gen, n, k, dtype=wdtype, scale=0.02)
    wave = _randn(gen, 1024, k)
    whole = bi.linear(wave, w, torch.float32)
    _close(whole, bi.linear_plain(wave, w, torch.float32), F32_TOL)
    for batch in (8, 128, 1024):
        part = bi.linear(wave[:batch], w, torch.float32)
        assert torch.equal(part, whole[:batch]), (name, batch)
        plan = _kernels.bi_gemm_plan(wave[:batch], w, part)
        assert plan.route == "fma" and plan.seg_k == _kernels.FMA_SEG_K, plan
        differ = [r for r in range(batch)
                  if not torch.equal(bi.linear(wave[r:r + 1], w, torch.float32)[0], part[r])]
        assert not differ, (name, batch, differ[:8])


def test_lm_head_takes_both_tile_kinds(device):
    """The lm_head's plan is skinny at M 1 and 8 and wide at M 128 and 1024:
    the bit-equality above crosses the switch."""
    tiles = {m: _kernels.plan_fma((1, 1, 1, m, 32768, 768)).tiles for m in (1, 8, 128, 1024)}
    assert tiles == {1: "skinny", 8: "skinny", 128: "wide", 1024: "wide"}


@pytest.mark.parametrize("k", [1, 7, 63, 65, 100, 200, 777])
@pytest.mark.parametrize("m", [1, 8, 40, 300])
def test_odd_k_and_k_off_a_segment(device, k, m):
    """K odd, below a segment, just past one, and off a multiple of 4 (the
    wide tiles, at M 300, then stage by plain loads); rows equal alone."""
    gen = torch.Generator(device=device).manual_seed(k * 1000 + m)
    w = _randn(gen, 6000, k, dtype=torch.bfloat16)
    assert _kernels.bi_gemm_plan(_randn(gen, m, k), w, torch.empty(m, 6000, device=device)) \
        .tiles == ("wide" if m == 300 else "skinny")
    x = _randn(gen, m, k)
    got = bi.linear(x, w, torch.float32)
    _close(got, bi.linear_plain(x, w, torch.float32), F32_TOL)
    for r in (0, m // 2, m - 1):
        assert torch.equal(bi.linear(x[r:r + 1], w, torch.float32)[0], got[r]), (k, m, r)


@pytest.mark.parametrize("pair", ["f32_bf16", "bf16_f32", "f32_f32", "bf16_bf16"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=lambda d: str(d).removeprefix("torch."))
@pytest.mark.parametrize("m", [1, 8, 1024])
def test_every_dtype_pair_and_output(device, pair, out_dtype, m):
    """The kernel takes f32 x bf16, bf16 x f32 and f32 x f32 (and bf16 x
    bf16, which the serving route sends to the tensor cores; the launch
    below forces it) with an f32 or a bf16 output, on both tile kinds (M
    1024 takes the wide tiles)."""
    a_dtype, w_dtype = (getattr(torch, {"f32": "float32", "bf16": "bfloat16"}[t])
                        for t in pair.split("_"))
    gen = torch.Generator(device=device).manual_seed(m)
    x, w = _randn(gen, m, 768, dtype=a_dtype), _randn(gen, 2048, 768, dtype=w_dtype, scale=0.05)
    out = torch.empty(m, 2048, dtype=out_dtype, device=device)
    sizes, a_s, w_s, c_s = _kernels._bi_operands(x, w, out)
    before = _kernels.serving_launch_counts()["bi_gemm"]
    _kernels.launch_fma(x, w, out, sizes, a_s + w_s + c_s, _kernels.plan_fma(sizes))
    assert _kernels.serving_launch_counts()["bi_gemm"] == before + 1
    want = torch.einsum("mk,nk->mn", x.float(), w.float())
    _close(out, want.to(out_dtype), F32_TOL if out_dtype == torch.float32 else BF16_TOL)
    alone = torch.empty(1, 2048, dtype=out_dtype, device=device)
    sizes1, a1, w1, c1 = _kernels._bi_operands(x[m - 1:], w, alone)
    _kernels.launch_fma(x[m - 1:], w, alone, sizes1, a1 + w1 + c1, _kernels.plan_fma(sizes1))
    assert torch.equal(alone[0], out[m - 1])


@pytest.mark.parametrize("queries", [1, 128])
def test_f32_attention_products_broadcast_and_transposed(device, queries):
    """An f32 model's decode attention: the scores read the keys in place
    (broadcast over the GQA group, stride 0), the mix reads v transposed
    (k stride = the cache's row); each batch row equals that row alone."""
    gen = torch.Generator(device=device).manual_seed(queries)
    b, cache, heads, groups, d = 8, 512, 4, 3, 64
    q = _randn(gen, b, queries, heads, groups, d)
    kv = _randn(gen, b, cache, heads, d)
    probs = torch.softmax(_randn(gen, b, heads, groups, queries, cache) * 4, -1)
    scores = bi.attention_scores(q, kv)
    mixed = bi.attention_mix(probs, kv)
    _close(scores, bi.attention_scores_plain(q, kv), F32_TOL)
    _close(mixed, bi.attention_mix_plain(probs, kv), F32_TOL)
    assert _kernels.bi_gemm_plan(probs, kv.permute(0, 2, 3, 1)[:, :, None].expand(
        b, heads, groups, d, cache), mixed.permute(0, 2, 3, 1, 4)).route == "fma"
    for r in (0, 5, b - 1):
        assert torch.equal(bi.attention_scores(q[r:r + 1], kv[r:r + 1])[0], scores[r])
        assert torch.equal(bi.attention_mix(probs[r:r + 1], kv[r:r + 1])[0], mixed[r])


def test_moe_router_rows_alone(device):
    """The MoE router's shape at a decode step (8 rows) and an admission
    wave of one 128-token prompt: each row its own bits."""
    gen = torch.Generator(device=device).manual_seed(5)
    router = _randn(gen, 8, 768, dtype=torch.bfloat16, scale=0.02)
    wave = _randn(gen, 128, 768)
    whole = bi.linear(wave, router, torch.float32)
    for m in (1, 8, 128):
        assert torch.equal(bi.linear(wave[:m], router, torch.float32), whole[:m]), m
    assert all(torch.equal(bi.linear(wave[r:r + 1], router, torch.float32)[0], whole[r])
               for r in range(128))


def test_wrapper_refuses_what_the_kernel_does_not_take(device):
    """No fallback: a launch the kernel refuses raises."""
    x = torch.zeros(4, 64, device=device)
    w = torch.zeros(16, 64, device=device)
    out = torch.empty(4, 16, device=device)
    sizes, a_s, w_s, c_s = _kernels._bi_operands(x, w, out)
    bad = _kernels.GemmPlan("fma", 128, 1, "skinny", nt=64, rs=4)  # another segment
    with pytest.raises(RuntimeError, match="CUDA error"):
        _kernels.launch_fma(x, w, out, sizes, a_s + w_s + c_s, bad)
    bad = _kernels.GemmPlan("fma", _kernels.FMA_SEG_K, 1, "skinny", nt=12, rs=4)  # cw not a divisor
    with pytest.raises(RuntimeError, match="CUDA error"):
        _kernels.launch_fma(x, w, out, sizes, a_s + w_s + c_s, bad)
