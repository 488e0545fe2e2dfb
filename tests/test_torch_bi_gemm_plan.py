"""The batch-invariant product's planner and the serving wrappers' casts, on
the CPU.

``_kernels.plan_bi_gemm`` picks the route of every product the serving
paths take to the card (bf16 x bf16 on the tensor cores, ``tc`` or ``mix``;
a pair with an f32 operand on the CUDA cores, ``fma``) and its tiles.  A
row's bits at batch 1 and in a batch rest on one rule: the route follows
from the dtypes and the segments from K, never from M, N or the batch,
while the tiles may.  bf16 operands the tensor-core kernels cannot read in
place (a row stride or a base off 16-byte runs, K off a multiple of 8) are
copied onto those runs first, whatever M, so they keep the route.  The
kernels themselves run only on the card (``tests/test_torch_kernels.py``);
the planner, the copies and the casts are plain Python, held here.
"""

import numpy as np
import pytest
import torch

from covalent_tpu_plugin_torch.models import decode
from covalent_tpu_plugin_torch.models.transformer import TransformerConfig, TransformerLM
from covalent_tpu_plugin_torch.ops import _kernels
from covalent_tpu_plugin_torch.ops import batch_invariant as bi

ROWS = (1, 7, 8, 15, 16, 17, 63, 64, 65, 128, 1024, 4096)
COLUMNS = (8, 64, 512, 768, 3072, 32768)
BATCHES = ((1, 1, 1), (8, 12, 1), (2, 4, 3))
DTYPE_PAIRS = {
    (torch.bfloat16, torch.bfloat16): "tc",
    (torch.float32, torch.float32): "fma",
    (torch.float32, torch.bfloat16): "fma",
    (torch.bfloat16, torch.float32): "fma",
}


@pytest.mark.parametrize("k", [8, 16, 64, 72, 512, 768, 3072, 4096])
def test_route_and_segments_follow_dtypes_and_k_alone(k):
    """Every (M, N, batch) gives one route for a dtype pair and one segment
    split for K; the tiles do change with M (skinny and wide on both the
    tensor cores and the CUDA cores)."""
    for (a_dtype, w_dtype), route in DTYPE_PAIRS.items():
        for transposed in (False, True):
            orders, tiles = set(), set()
            for m in ROWS:
                for n in COLUMNS:
                    for batch in BATCHES:
                        plan = _kernels.plan_bi_gemm(a_dtype, w_dtype, (*batch, m, n, k),
                                                     transposed)
                        orders.add((plan.route, plan.seg_k, plan.segments))
                        tiles.add(plan.tiles)
            if route == "fma":
                assert orders == {("fma", _kernels.FMA_SEG_K, -(-k // 64))}, (a_dtype, w_dtype)
                assert tiles == {"skinny", "wide"}, (a_dtype, w_dtype, tiles)
            elif transposed:
                assert orders == {("mix", 256, -(-k // 256))} and tiles == {"mix"}
            else:
                assert orders == {("tc", 256, -(-k // 256))} and tiles == {"skinny", "wide"}


def _attention_operands(b: int, q: int, cache: int = 512, heads: int = 12, d: int = 64):
    """The decode attention's operands as ``batch_invariant`` hands them to
    ``bi_gemm``: (scores a, w, out), (mix a, w, out)."""
    qg = torch.zeros(b, q, heads, 1, d, dtype=torch.bfloat16)
    k = torch.zeros(b, cache, heads, d, dtype=torch.bfloat16)
    keys = k.permute(0, 2, 1, 3)[:, :, None].expand(b, heads, 1, cache, d)
    scores = torch.empty(b, heads, 1, q, cache)
    probs = torch.zeros(b, heads, 1, q, cache, dtype=torch.bfloat16)
    values = k.permute(0, 2, 3, 1)[:, :, None].expand(b, heads, 1, d, cache)
    mixed = torch.empty(b, q, heads, 1, d).permute(0, 2, 3, 1, 4)
    return (qg.permute(0, 2, 3, 1, 4), keys, scores), (probs, values, mixed)


def test_attention_products_keep_their_route_and_order_at_every_shape():
    """The scores read the keys in place (route tc), the mix reads the
    values transposed (route mix), one order each at 1 or 8 rows, 1 or 128
    queries; f32 operands of the same layout take the CUDA cores."""
    seen = {"scores": set(), "mix": set()}
    for b in (1, 8):
        for q in (1, 128):
            for name, operands in zip(("scores", "mix"), _attention_operands(b, q)):
                plan = _kernels.bi_gemm_plan(*operands)
                seen[name].add((plan.route, plan.seg_k, plan.segments))
    assert seen == {"scores": {("tc", 256, 1)}, "mix": {("mix", 256, 2)}}
    (qa, keys, scores), (probs, values, mixed) = _attention_operands(8, 1)
    assert _kernels.bi_gemm_plan(qa.float(), keys.float(), scores).route == "fma"
    assert _kernels.bi_gemm_plan(probs.float(), values.float(), mixed).route == "fma"


def _bf16(*shape):
    return torch.tensor(np.random.default_rng(3).standard_normal(shape, dtype=np.float32),
                        dtype=torch.bfloat16)


#: bf16 operands off the tensor cores' 16-byte runs, for M rows: name ->
#: (a, w, out, the route they take once copied).
OFF_RUNS = {
    # A's rows 772 apart (a slice of a wider buffer)
    "row_stride": lambda m: (_bf16(m, 772)[:, :768], _bf16(96, 768), torch.empty(m, 96), "tc"),
    # A's k stride 2
    "k_stride": lambda m: (_bf16(m, 1536)[:, ::2], _bf16(96, 768), torch.empty(m, 96), "tc"),
    # K = 764, off a multiple of 8, in both
    "k_off_8": lambda m: (_bf16(m, 764), _bf16(96, 764), torch.empty(m, 96), "tc"),
    # A's base 2 bytes off 16
    "a_base": lambda m: (_bf16(m * 768 + 1)[1:].view(m, 768), _bf16(96, 768),
                         torch.empty(m, 96), "tc"),
    # W's base 2 bytes off 16
    "w_base": lambda m: (_bf16(m, 768), _bf16(96 * 768 + 1)[1:].view(96, 768),
                         torch.empty(m, 96), "tc"),
    # a transposed W (cache-like) of 12 columns, off the mix's runs of 8
    "w_transposed_n12": lambda m: (_bf16(m, 64), _bf16(64, 12).t(), torch.empty(m, 12), "tc"),
}


@pytest.mark.parametrize("name", sorted(OFF_RUNS))
def test_operands_off_the_runs_are_copied_onto_them_whatever_m(name):
    """The same layout at M = 1 and M = 8 takes the same route (the tensor
    cores, as bf16 always does), its operands copied onto aligned runs:
    the values and, where K was padded, exact zeros after them."""
    for m in (1, 8):
        a, w, out, route = OFF_RUNS[name](m)
        got_a, got_w, sizes, _strides, plan = _kernels._bi_prepare(a, w, out)
        assert plan.route == route and _kernels.bi_gemm_plan(a, w, out) == plan, (name, m)
        k = a.shape[-1]
        assert sizes[5] == -(-k // 8) * 8
        for orig, got in ((a, got_a), (w, got_w)):
            assert got.stride(-1) == 1 and got.data_ptr() % 16 == 0
            assert all(s % 8 == 0 for s in got.stride()[:-1])
            assert torch.equal(got[..., :k], orig)
            assert not got[..., k:].any()


def test_skinny_tiles_fit_the_kernel_and_cover_every_segment():
    """The skinny tiles' launch shape stays within the kernel's 16 warps
    and takes every segment; the mix's within its 8 warps."""
    for k in (64, 256, 512, 768, 3072, 4096, 16384):
        for n in COLUMNS:
            sizes = (1, 1, 1, 8, n, k)
            plan = _kernels.plan_bi_gemm(torch.bfloat16, torch.bfloat16, sizes)
            assert plan.tiles == "skinny" and 1 <= plan.nt * plan.rs <= 16, (k, n)
            assert plan.rs <= plan.segments and plan.seg_k == _kernels.BI_SEG_K
            mix = _kernels.plan_bi_gemm(torch.bfloat16, torch.bfloat16, sizes, True)
            assert mix.route == "mix" and 1 <= mix.nt * mix.rs <= 8, (k, n)


@pytest.mark.parametrize("k", [1, 64, 65, 768, 3072, 4096, 8192])
def test_fma_and_w8_launch_fields_fit_the_kernels(k):
    """The CUDA-core route's skinny strip is a divisor of 256 from 8 with
    256 / strip segment slots and its shared memory within the block's
    limit (csrc/bi_gemm.cu: run), its grid within CUDA's; the int8
    product's skinny blocks hold at most 12 warps, a round no more segments
    than K has, and their shared memory fits (csrc/bi_gemm_w8.cu: run)."""
    for m in ROWS:
        for n in COLUMNS:
            for batch in BATCHES:
                sizes = (*batch, m, n, k)
                plan = _kernels.plan_fma(sizes)
                assert plan == _kernels.plan_bi_gemm(torch.float32, torch.bfloat16, sizes)
                if plan.tiles == "skinny":
                    assert plan.nt in _kernels.FMA_STRIPS and plan.rs * plan.nt == 256, plan
                    assert _kernels.fma_skinny_smem(m, k, plan.nt) <= _kernels.FMA_SKINNY_SMEM
                    assert -(-n // plan.nt) <= 65535
                else:
                    assert plan.tiles == "wide" and -(-n // 128) <= 65535
                w8 = _kernels.plan_bi_gemm(torch.bfloat16, torch.int8, sizes)
                assert w8.route == "w8" and w8.seg_k == _kernels.BI_SEG_K
                assert w8.segments == -(-k // _kernels.BI_SEG_K)
                if w8.tiles == "skinny":
                    assert 1 <= w8.nt * w8.rs <= _kernels.W8_MAX_WARPS, w8
                    assert w8.rs <= w8.segments
                    assert _kernels.w8_skinny_smem(m, k, w8.nt * w8.rs, w8.rs) <= \
                        _kernels.W8_SMEM_MAX
                else:
                    assert w8.tiles == "wide"


def test_fma_skinny_strips_cover_the_card_or_every_segment():
    """The router (8 columns) gets a slot for each of its 12 segments; the
    lm_head at M 1 and 8 strips of 64 (512 blocks, 4 slots); an f32 model's
    decode attention's mix (K 512 over the cache) 8 slots of 32 columns."""
    def launch(sizes):
        plan = _kernels.plan_fma(sizes)
        return plan.tiles, plan.nt, plan.rs

    assert launch((1, 1, 1, 8, 8, 768)) == ("skinny", 8, 32)
    assert launch((1, 1, 1, 1, 32768, 768)) == ("skinny", 64, 4)
    assert launch((8, 12, 1, 1, 64, 512)) == ("skinny", 32, 8)
    assert _kernels.plan_fma((1, 1, 1, 1024, 32768, 768)).tiles == "wide"


@pytest.fixture()
def recorder(monkeypatch):
    """CPU tensors sent down the kernel route, ``bi_gemm`` replaced by a
    recorder that computes the plain product (and ``bi_rmsnorm`` and
    ``bi_add_rmsnorm`` by the plain norms): what each wrapper hands the
    kernel, and the plan the kernel would take."""
    calls = []

    def fake_bi_gemm(a, w, out):
        calls.append({"a": a.dtype, "w": w.dtype, "out": out.dtype,
                      "route": _kernels.bi_gemm_plan(a, w, out).route})
        out.copy_(torch.einsum("...mk,...nk->...mn", a.float(), w.float()))
        return out

    monkeypatch.setattr(bi, "_route", lambda x: True)
    monkeypatch.setattr(bi._kernels, "bi_gemm", fake_bi_gemm)
    monkeypatch.setattr(bi._kernels, "bi_rmsnorm", lambda x, scale, dtype, eps:
                        bi.rms_norm_plain(x, scale, dtype, eps))
    monkeypatch.setattr(bi._kernels, "bi_add_rmsnorm", lambda x, delta, scale, dtype, eps:
                        bi.add_rms_norm_plain(x, delta, scale, dtype, eps))
    return calls


def test_lm_head_hands_bf16_features_to_the_tensor_cores(recorder):
    """The serving model's lm_head (bf16 weight, f32 logits) gets the final
    norm's bf16 features as they are: bf16 A, f32 out, the tc route, and the
    plain version's logits.  Genuinely f32 features keep the f32 route."""
    cfg = TransformerConfig(vocab_size=256, d_model=64, n_layers=1, n_heads=4, d_ff=128,
                            max_seq=32)
    model = decode.inference_params(TransformerLM(cfg, device="cpu",
                                                  generator=torch.Generator().manual_seed(0)))
    head = model.lm_head
    assert head.weight.dtype == torch.bfloat16 and head.dtype == torch.float32
    rng = np.random.default_rng(0)
    feats = torch.tensor(rng.standard_normal((3, 5, 64), dtype=np.float32))
    got = bi.linear(feats.to(torch.bfloat16), head.weight, head.dtype)
    assert recorder[-1] == {"a": torch.bfloat16, "w": torch.bfloat16, "out": torch.float32,
                            "route": "tc"}
    want = bi.linear_plain(feats.to(torch.bfloat16), head.weight, head.dtype)
    assert got.dtype == torch.float32 and torch.allclose(got, want, atol=1e-5)
    bi.linear(feats, head.weight, head.dtype)
    assert recorder[-1] == {"a": torch.float32, "w": torch.bfloat16, "out": torch.float32,
                            "route": "fma"}
    # the dense layers of the same model: bf16 in, bf16 out
    dense = model.layers[0].mlp.wi
    bi.linear(feats.to(torch.bfloat16), dense.weight, dense.dtype)
    assert recorder[-1] == {"a": torch.bfloat16, "w": torch.bfloat16, "out": torch.bfloat16,
                            "route": "tc"}


def test_serving_decode_step_takes_only_the_tensor_core_routes(recorder):
    """A bf16 serving model's prefill and decode step hand every product to
    the tensor-core routes (tc, mix) and none to the f32 CUDA cores."""
    cfg = TransformerConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                            max_seq=32)
    model = decode.inference_params(TransformerLM(cfg, device="cpu",
                                                  generator=torch.Generator().manual_seed(1)))
    tokens = np.random.default_rng(2).integers(0, 256, (2, 8))
    decode.generate(model, tokens, 3)
    routes = [call["route"] for call in recorder]
    assert routes and set(routes) == {"tc", "mix"}
    assert sum(r == "mix" for r in routes) == 3 * cfg.n_layers  # prefill + 2 steps, a layer
