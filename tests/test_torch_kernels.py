"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The tests marked ``cuda`` need an NVIDIA card and skip without one; the
others check the build bookkeeping and run anywhere.  The file imports
neither JAX nor the reference package, so on a machine with the card and
without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The autograd path of ``flash_attention`` on CUDA tensors (the three kernels)
is held against the same path on CPU tensors (their plain versions), in
float32: atol 1e-5 on outputs, 1e-4 on gradients, which sum over up to 256
positions in another order.  The plain side runs on one CPU thread: with
the library's threads on a loaded machine it once gave an output 2.7e-5
from the exact value where it is otherwise within 4e-7 of it, and the card
within 6e-8 (``tools/causal_race.sh``).  The 16-bit inputs that take the tensor-core
forward, dQ and dK/dV kernels are held against the plain versions on the
card at ``chip_smoke.py``'s tolerance: one rounding of the input type times
the largest plain value (at least 1), since both make the same casts but sum
in another order and the forward rounds P against a running max.
"""

import shutil

import numpy as np
import pytest
import torch

from covalent_tpu_plugin_torch.ops import _kernels
from covalent_tpu_plugin_torch.ops import attention as torch_attention
from covalent_tpu_plugin_torch.ops.ring_attention import sequence_positions

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


def _mismatches(got, want, seed) -> list[str]:
    """For each output off by more than its tolerance: its name, largest
    error, that error's index and values, and the case's seed."""
    failures = []
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        atol = FWD_ATOL if name == "out" else GRAD_ATOL
        err = np.abs(a.astype(np.float64) - b)
        err[np.isnan(err)] = np.inf
        if err.max() > atol:
            at = np.unravel_index(int(np.argmax(err)), err.shape)
            failures.append(f"{name}: max abs error {err.max()} > {atol} at {tuple(map(int, at))} "
                            f"(card {a[at]}, plain {b[at]}; seed {seed})")
    return failures


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_plain_on_the_card(card, name):
    seed = 0
    _kernels.reset_launch_counts()
    got = _run(card, CASES[name], seed)
    torch.cuda.synchronize()
    assert _kernels.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkdv": 1, "flash_bwd_dq": 1}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = _run("cpu", CASES[name], seed)
    finally:
        torch.set_num_threads(threads)
    failures = _mismatches(got, want, seed)
    assert not failures, f"{name}: " + "; ".join(failures)


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


#: 16-bit cases of the tensor-core route (bf16/f16, head dim 64 or 128).
TC_CASES = {
    "causal_mha_d64_bf16": dict(shape=(1, 4, 4, 256, 256, 64), dtype="bfloat16", causal=True),
    "gqa_d128_f16": dict(shape=(1, 8, 2, 256, 256, 128), dtype="float16", causal=True),
    "full_ragged_bf16": dict(shape=(2, 4, 4, 192, 100, 64), dtype="bfloat16", causal=False),
    "window_sinks_bf16": dict(shape=(1, 4, 2, 512, 512, 64), dtype="bfloat16", causal=True,
                              window=128, sinks=4),
    "positions_d128_f16": dict(shape=(1, 4, 4, 256, 192, 128), dtype="float16", causal=True,
                               positions=True),
    "ragged_window_bf16": dict(shape=(1, 2, 2, 100, 100, 64), dtype="bfloat16", causal=True,
                               window=7),
    # several query heads per kv head and a ragged last query tile: what the
    # dK/dV kernel sweeps over
    "gqa_ragged_q_bf16": dict(shape=(2, 8, 2, 100, 256, 64), dtype="bfloat16", causal=False),
    # each rank's shape in the two-process gang of the 125M LM: the batch
    # cut under MeshPlan(fsdp=2), the heads under MeshPlan(tensor=2)
    "gang_fsdp2_rank_bf16": dict(shape=(4, 12, 12, 1024, 1024, 64), dtype="bfloat16",
                                 causal=True),
    "gang_tensor2_rank_bf16": dict(shape=(8, 6, 6, 1024, 1024, 64), dtype="bfloat16",
                                   causal=True),
}
EPS = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}


def _assert_close(got, want, eps):
    tol = eps * max(want.float().abs().max().item(), 1.0)
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got.float()).all() and err <= tol, f"max abs error {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TC_CASES))
def test_tensor_core_kernels_match_plain_on_the_card(card, name):
    case = TC_CASES[name]
    batch, heads, kv_heads, seq_q, seq_k, dim = case["shape"]
    dtype = getattr(torch, case["dtype"])
    rng = np.random.default_rng(7)
    q, k, v, dout = (
        torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=card).to(dtype)
        for shape in ((batch, heads, seq_q, dim), (batch, kv_heads, seq_k, dim),
                      (batch, kv_heads, seq_k, dim), (batch, heads, seq_q, dim))
    )
    qpos = kpos = None
    if case.get("positions"):
        qpos = torch.tensor(rng.permutation(seq_q).astype(np.int32), device=card)
        kpos = torch.tensor((2 * np.arange(seq_k)).astype(np.int32), device=card)
    band = (case["causal"], case.get("window"), case.get("sinks", 0))
    for kernel in _kernels.KERNELS:
        assert kernel.route(dtype, dim) == "wgmma+tma"

    _kernels.reset_launch_counts()
    out, lse = _kernels.flash_fwd(q, k, v, qpos, kpos, *band)
    out_p, lse_p = torch_attention.flash_fwd_plain(q, k, v, qpos, kpos, *band)
    delta = (dout.float() * out.float()).sum(dim=-1)
    bwd_args = (q, k, v, dout, lse, delta, qpos, kpos, *band)
    dq = _kernels.flash_bwd_dq(*bwd_args)
    dq_p = torch_attention.flash_bwd_dq_plain(*bwd_args)
    dk, dv = _kernels.flash_bwd_dkdv(*bwd_args)
    dk_p, dv_p = torch_attention.flash_bwd_dkdv_plain(*bwd_args)
    torch.cuda.synchronize()
    assert _kernels.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkdv": 1, "flash_bwd_dq": 1}
    _assert_close(out, out_p, EPS[dtype])
    _assert_close(lse, lse_p, 32 * 2.0**-23)
    _assert_close(dq, dq_p, EPS[dtype])
    _assert_close(dk, dk_p, EPS[dtype])
    _assert_close(dv, dv_p, EPS[dtype])


#: The f32-output variants (ring attention's per-hop partials): bf16 inputs
#: at one hop of a 2-ring of the 125M LM (queries at one rank's stripes, keys
#: at the other's), at head dim 128, and on the scalar route; (q rank, k rank).
VARIANT_CASES = {
    "hop_q0_k1_bf16": dict(shape=(8, 12, 12, 512, 512, 64), dtype="bfloat16", ranks=(0, 1)),
    "hop_q1_k0_bf16": dict(shape=(8, 12, 12, 512, 512, 64), dtype="bfloat16", ranks=(1, 0)),
    "hop_d128_gqa_bf16": dict(shape=(2, 8, 2, 512, 512, 128), dtype="bfloat16", ranks=(1, 0)),
    "hop_scalar_d32_f16": dict(shape=(1, 4, 2, 256, 256, 32), dtype="float16", ranks=(0, 1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(VARIANT_CASES))
def test_f32_output_variants_match_plain_on_the_card(card, name):
    """Each sweep with f32 outputs against its plain version at the 16-bit
    tolerance, and, rounded to the input type, bit-equal to the same sweep's
    16-bit output: the variant stores the same accumulator, unrounded."""
    case = VARIANT_CASES[name]
    batch, heads, kv_heads, seq_q, seq_k, dim = case["shape"]
    dtype = getattr(torch, case["dtype"])
    rng = np.random.default_rng(11)
    q, k, v, dout = (
        torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=card).to(dtype)
        for shape in ((batch, heads, seq_q, dim), (batch, kv_heads, seq_k, dim),
                      (batch, kv_heads, seq_k, dim), (batch, heads, seq_q, dim))
    )
    q_rank, k_rank = case["ranks"]
    qpos = torch.tensor(sequence_positions(2 * seq_q, 2, q_rank, True), device=card)
    kpos = torch.tensor(sequence_positions(2 * seq_k, 2, k_rank, True), device=card)
    band = (True, None, 0)
    f32 = torch.float32

    _kernels.reset_launch_counts()
    out, lse = _kernels.flash_fwd(q, k, v, qpos, kpos, *band, out_dtype=f32)
    out16, lse16 = _kernels.flash_fwd(q, k, v, qpos, kpos, *band)
    out_p, _ = torch_attention.flash_fwd_plain(q, k, v, qpos, kpos, *band, f32)
    delta = torch_attention.flash_delta(out, dout)
    bwd_args = (q, k, v, dout, lse, delta, qpos, kpos, *band)
    dq = _kernels.flash_bwd_dq(*bwd_args, grad_dtype=f32)
    dq16 = _kernels.flash_bwd_dq(*bwd_args)
    dq_p = torch_attention.flash_bwd_dq_plain(*bwd_args, f32)
    dk, dv = _kernels.flash_bwd_dkdv(*bwd_args, grad_dtype=f32)
    dk16, dv16 = _kernels.flash_bwd_dkdv(*bwd_args)
    dk_p, dv_p = torch_attention.flash_bwd_dkdv_plain(*bwd_args, f32)
    torch.cuda.synchronize()
    assert _kernels.launch_counts() == {"flash_fwd": 2, "flash_bwd_dkdv": 2, "flash_bwd_dq": 2}
    key = f"{batch}x{heads}x{seq_q}x{dim} {case['dtype']}"
    assert _kernels.launch_shapes()["flash_fwd"] == {f"{key}->float32": 1, key: 1}
    assert torch.equal(lse, lse16)
    for got, plain, low in ((out, out_p, out16), (dq, dq_p, dq16), (dk, dk_p, dk16),
                            (dv, dv_p, dv16)):
        assert got.dtype == f32 and plain.dtype == f32
        _assert_close(got, plain, EPS[dtype])
        assert torch.equal(got.to(dtype), low)


@pytest.mark.cuda
def test_routes_follow_dtype_and_head_dim(card):
    """The compiled switch: each of the three sweeps takes the tensor cores
    for 16-bit inputs at head dim 64 or 128; f32 (which they would compute
    in TF32) and the other widths stay on the scalar kernels."""
    for kernel in _kernels.KERNELS:
        for dtype in (torch.bfloat16, torch.float16):
            for dim in _kernels.HEAD_DIMS:
                want = "wgmma+tma" if dim in (64, 128) else "scalar-fma"
                assert kernel.route(dtype, dim) == want
        for dim in _kernels.HEAD_DIMS:
            assert kernel.route(torch.float32, dim) == "scalar-fma"


def test_sources_digest_covers_every_kernel_source(tmp_path, monkeypatch):
    """An edit to any *.cu or *.cuh under csrc/, or a new one, changes the
    digest that keys the built libraries, so a stale library is never
    loaded after an edit."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    sources = sorted(p for p in csrc.iterdir() if p.suffix in (".cu", ".cuh"))
    assert {"flash_common.cuh", "flash_tc.cuh", "hopper.cuh"} <= {p.name for p in sources}
    base = _kernels.sources_digest()
    for path in sources:
        text = path.read_bytes()
        path.write_bytes(text + b"\n")
        assert _kernels.sources_digest() != base, path.name
        path.write_bytes(text)
    assert _kernels.sources_digest() == base
    (csrc / "added.cuh").write_text("#pragma once\n")
    assert _kernels.sources_digest() != base


def test_chip_smoke_parity_covers_the_tensor_core_route():
    """chip_smoke.py holds the tensor-core kernels against their plain
    versions at every (16-bit type, head dim) they take, non-causal too."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sixteen_bit = [c for c in chip_smoke.PARITY_CASES if c["dtype"] in ("bfloat16", "float16")]
    covered = {(c["dtype"], c["shape"][-1]) for c in sixteen_bit}
    assert covered >= {(dt, d) for dt in ("bfloat16", "float16") for d in (64, 128)}
    assert any(not c["causal"] for c in sixteen_bit)


def test_mismatch_report_names_output_error_index_and_seed():
    """What the card test prints when a kernel disagrees with its plain
    version (checked here on made-up arrays)."""
    want = [np.zeros((1, 2, 3, 4), np.float32) for _ in range(4)]
    got = [w.copy() for w in want]
    got[2][0, 1, 2, 3] = 0.5
    got[3][0, 0, 0, 0] = np.nan
    report = _mismatches(got, want, seed=7)
    assert len(report) == 2
    assert report[0].startswith("dk: max abs error 0.5 > 0.0001 at (0, 1, 2, 3)")
    assert "seed 7" in report[0] and report[1].startswith("dv: max abs error inf")
    assert _mismatches(want, want, seed=7) == []


def test_chip_smoke_parity_covers_gqa_and_ragged_queries():
    """chip_smoke.py holds the 16-bit kernels, dK/dV among them, against
    their plain versions with several query heads per kv head and with a
    query length that leaves the last 64-row tile ragged, at both widths of
    the tensor-core route."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sixteen_bit = [c for c in chip_smoke.PARITY_CASES if c["dtype"] in ("bfloat16", "float16")]
    for dim in (64, 128):
        at_dim = [c["shape"] for c in sixteen_bit if c["shape"][-1] == dim]
        assert any(heads > kv_heads for _, heads, kv_heads, *_ in at_dim), dim
        assert any(seq_q % 64 for _, _, _, seq_q, _, _ in at_dim), dim
        assert any(h > hkv and sq % 64 and sq != sk for _, h, hkv, sq, sk, _ in at_dim), dim


# --- the serving paths' batch-invariant kernels (csrc/bi_gemm*.cu, bi_rmsnorm.cu)

#: bi kernels against their plain versions: f32 sums in another order, then
#: (bf16 outputs) one rounding that may land on the neighbouring value, at
#: most one bf16 ulp of outputs below 2 in magnitude.
BI_TOL = {torch.bfloat16: 2.0**-6, torch.float32: 1e-4}


def _bi_inputs(card, seed=0):
    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    rng = np.random.default_rng(seed)

    def t(*shape, dtype=torch.bfloat16, scale=1.0):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32) * scale,
                            device=card).to(dtype)

    # name: (kernel route, plain version, batch-major inputs)
    return {
        "linear_bf16": (lambda x, w=t(96, 80, scale=0.1): bi.linear(x, w, torch.bfloat16),
                        None, (t(13, 80),)),
        "linear_f32_bf16_weight": (
            lambda x, w=t(160, 80, scale=0.1): bi.linear(x, w, torch.float32),
            None, (t(13, 80, dtype=torch.float32),)),
        "attention_scores_gqa": (bi.attention_scores, bi.attention_scores_plain,
                                 (t(13, 3, 2, 2, 64), t(13, 40, 2, 64))),
        "attention_mix_gqa": (bi.attention_mix, bi.attention_mix_plain,
                              (torch.softmax(t(13, 2, 2, 3, 40, dtype=torch.float32), -1)
                               .to(torch.bfloat16), t(13, 40, 2, 64))),
        "rmsnorm": (lambda x, s=t(80): bi.rms_norm(x, s, torch.bfloat16), None,
                    (t(13, 4, 80, scale=3.0),)),
    }


@pytest.mark.cuda
def test_batch_invariant_kernels_match_plain_on_the_card(card):
    """Each batch-invariant kernel against its plain version (the same
    casts), on bf16 and f32 inputs, GQA attention products included."""
    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((13, 80), dtype=np.float32), device=card)
    for m in (1, 8, 13):
        for dtype, wdtype in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
                              (torch.float32, torch.float32)):
            w = torch.tensor(rng.standard_normal((160, 80), dtype=np.float32) * 0.1,
                             device=card).to(wdtype)
            got = bi.linear(x[:m], w, dtype)
            want = bi.linear_plain(x[:m], w, dtype)
            assert got.dtype == want.dtype == dtype
            assert (got.float() - want.float()).abs().max().item() <= BI_TOL[dtype]
    for name, (kernel, plain, inputs) in _bi_inputs(card).items():
        if plain is None:
            continue
        got, want = kernel(*inputs), plain(*inputs)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert (got - want).abs().max().item() <= BI_TOL[torch.float32], name
    scale = torch.tensor(rng.standard_normal(80, dtype=np.float32), device=card)
    for xdtype in (torch.bfloat16, torch.float32):
        xs = (x * 3).to(xdtype)
        for out in (torch.bfloat16, torch.float32):
            got = bi.rms_norm(xs, scale.to(xdtype), out)
            want = bi.rms_norm_plain(xs, scale.to(xdtype), out)
            assert (got.float() - want.float()).abs().max().item() <= 4 * BI_TOL[out]


@pytest.mark.cuda
def test_batch_invariant_rows_bit_equal_under_batch_and_permutation(card):
    """A row's output is the same bits alone (M = 1), in a batch of 8, in a
    batch of 13 and in a permuted batch: the serving contract."""
    for name, (kernel, _plain, inputs) in _bi_inputs(card, seed=1).items():
        whole = kernel(*inputs)
        perm = torch.as_tensor(np.random.default_rng(2).permutation(13), device=card)
        permuted = kernel(*(t[perm] for t in inputs))
        first8 = kernel(*(t[:8] for t in inputs))
        for row in range(13):
            alone = kernel(*(t[row:row + 1] for t in inputs))
            assert torch.equal(whole[row:row + 1], alone), (name, row)
            if row < 8:
                assert torch.equal(first8[row:row + 1], alone), (name, row)
        assert torch.equal(permuted, whole[perm]), name


#: The 125M LM's products: (N, K, output type) of q/k/v/o, the MLP's two and
#: the lm_head (bf16 features, f32 logits).
BI_WIDTHS = {"qkvo": (768, 768, torch.bfloat16), "mlp_wi": (3072, 768, torch.bfloat16),
             "mlp_wo": (768, 3072, torch.bfloat16), "lm_head": (32768, 768, torch.float32)}
#: Row counts crossing every boundary of the tensor-core route's tiles: the
#: skinny tiles' 8 and 16 rows, the wide tiles' 64 and 128, an admission wave.
BI_ROW_SWEEP = (1, 7, 8, 15, 16, 17, 63, 64, 65, 128, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BI_WIDTHS))
def test_batch_invariant_rows_bit_equal_across_tiles_at_125m_widths(card, name):
    """Every row count of the sweep: each row of the batch equals the same
    row in the 1024-row batch (the wide tiles) and alone (M = 1, the skinny
    tiles), bit for bit, also in a permuted batch; the product is the
    tensor-core route's, within ``BI_TOL`` of its plain version."""
    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    n, k, out = BI_WIDTHS[name]
    rng = np.random.default_rng(7)
    # features of 0.25 and weights of 0.02 keep every output below 2, where
    # BI_TOL's one bf16 rounding holds
    x = torch.tensor(rng.standard_normal((1024, k), dtype=np.float32) * 0.25, device=card)
    x = x.to(torch.bfloat16)
    w = torch.tensor(rng.standard_normal((n, k), dtype=np.float32) * 0.02, device=card)
    w = w.to(torch.bfloat16)
    assert _kernels.bi_gemm_plan(x, w, torch.empty(1024, n, dtype=out, device=card)).route == "tc"
    _kernels.reset_launch_counts()
    whole = bi.linear(x, w, out)
    assert _kernels.serving_launch_counts()["bi_gemm_tc"] == 1
    want = bi.linear_plain(x, w, out)
    assert whole.dtype == out
    assert (whole.float() - want.float()).abs().max().item() <= BI_TOL[out], name
    for m in BI_ROW_SWEEP:
        rows = bi.linear(x[:m], w, out)
        assert torch.equal(rows, whole[:m]), (name, m)
        perm = torch.as_tensor(np.random.default_rng(m).permutation(m), device=card)
        assert torch.equal(bi.linear(x[:m][perm], w, out), whole[:m][perm]), (name, m)
    for row in range(1024):
        assert torch.equal(bi.linear(x[row:row + 1], w, out), whole[row:row + 1]), (name, row)
    assert _kernels.serving_launch_counts()["bi_gemm"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("queries", [1, 128])
def test_batch_invariant_attention_products_over_a_512_cache(card, queries):
    """The decode attention's scores (tensor-core route, the keys read in
    place) and mix (the mix route, the values read transposed) at 8 rows x
    12 heads over 512 cache positions: within ``BI_TOL`` of their plain
    versions, each batch row equal to that row alone and in a permuted
    batch, and each query equal to that query alone."""
    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    rng = np.random.default_rng(11 + queries)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=card).to(torch.bfloat16)

    q, cache_k, cache_v = t(8, queries, 12, 1, 64), t(8, 512, 12, 64), t(8, 512, 12, 64)
    probs = torch.softmax(t(8, 12, 1, queries, 512).float() * 4, -1).to(torch.bfloat16)
    scores_out = torch.empty(8, 12, 1, queries, 512, device=card)
    keys = cache_k.permute(0, 2, 1, 3)[:, :, None].expand(8, 12, 1, 512, 64)
    values = cache_v.permute(0, 2, 3, 1)[:, :, None].expand(8, 12, 1, 64, 512)
    assert _kernels.bi_gemm_plan(q.permute(0, 2, 3, 1, 4), keys, scores_out).route == "tc"
    mix_out = torch.empty(8, queries, 12, 1, 64, device=card).permute(0, 2, 3, 1, 4)
    assert _kernels.bi_gemm_plan(probs, values, mix_out).route == "mix"
    _kernels.reset_launch_counts()
    # name: kernel route, plain version, operands, the query dim of the
    # first operand and of the output
    products = {
        "scores": (bi.attention_scores, bi.attention_scores_plain, (q, cache_k), 1, 3),
        "mix": (bi.attention_mix, bi.attention_mix_plain, (probs, cache_v), 3, 1),
    }
    for name, (kernel, plain, (lhs, cache), lhs_dim, out_dim) in products.items():
        whole = kernel(lhs, cache)
        assert (whole - plain(lhs, cache)).abs().max().item() <= BI_TOL[torch.float32], name
        perm = torch.as_tensor(np.random.default_rng(5).permutation(8), device=card)
        assert torch.equal(kernel(lhs[perm], cache[perm]), whole[perm]), name
        for b in range(8):
            assert torch.equal(kernel(lhs[b:b + 1], cache[b:b + 1]), whole[b:b + 1]), (name, b)
        for i in sorted({0, queries // 2, queries - 1}):
            alone = kernel(lhs.narrow(lhs_dim, i, 1).contiguous(), cache)
            assert torch.equal(alone, whole.narrow(out_dim, i, 1)), (name, i)
    counts = _kernels.serving_launch_counts()
    assert counts["bi_gemm_tc"] > 0 and counts["bi_gemm_mix"] > 0 and counts["bi_gemm"] == 0


@pytest.mark.cuda
def test_tensor_core_route_bits_follow_the_values_not_their_layout(card):
    """bf16 operands take the tensor cores whatever their layout: A off the
    16-byte runs (rows 776 apart, a base 2 bytes off) and K = 764 (padded
    with zeros) are copied onto them, and the mix kernel's transposed read
    sums as the tc kernel's read of a k-contiguous copy.  At M 1, 8 and 128
    each is bit-equal to the aligned product; the CUDA-core kernel never
    runs."""
    rng = np.random.default_rng(13)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32) * scale,
                            device=card).to(torch.bfloat16)

    def product(a, w, dtype=torch.bfloat16):
        out = torch.empty(*a.shape[:-1], w.shape[-2], dtype=dtype, device=card)
        return _kernels.bi_gemm(a, w, out)

    x, w = t(128, 768, scale=0.25), t(3072, 768, scale=0.02)
    wide = torch.zeros(128, 776, dtype=torch.bfloat16, device=card)
    wide[:, :768] = x
    shifted = torch.zeros(128 * 768 + 8, dtype=torch.bfloat16, device=card)[1:1 + 128 * 768]
    shifted = shifted.view(128, 768)
    shifted.copy_(x)
    x764, w764 = x.clone(), w.clone()
    x764[:, 764:] = 0
    w764[:, 764:] = 0
    probs = torch.softmax(t(96, 128, 512).float() * 4, -1).to(torch.bfloat16)
    values = t(96, 512, 64).transpose(1, 2)  # (Z, N = 64, K = 512), n contiguous
    mix_out = torch.empty(96, 128, 64, device=card)
    assert _kernels.bi_gemm_plan(probs, values, mix_out).route == "mix"
    assert _kernels.bi_gemm_plan(wide[:8, :768], w, torch.empty(8, 3072, device=card)).route \
        == "tc"
    _kernels.reset_launch_counts()
    whole, padded = product(x, w), product(x764, w764)
    for m in (1, 8, 128):
        assert torch.equal(product(wide[:m, :768], w), whole[:m]), m
        assert torch.equal(product(shifted[:m], w), whole[:m]), m
        assert torch.equal(product(x[:m, :764], w[:, :764]), padded[:m]), m
        p = probs[:, :m].contiguous()
        assert torch.equal(product(p, values, torch.float32),
                           product(p, values.contiguous(), torch.float32)), m
    counts = _kernels.serving_launch_counts()
    assert counts["bi_gemm_tc"] > 0 and counts["bi_gemm_mix"] > 0 and counts["bi_gemm"] == 0


@pytest.mark.cuda
def test_serving_path_launches_the_batch_invariant_kernels(card):
    """``generate`` turns the route on: a small bf16 LM's decode on the card
    launches the tensor-core products, the mix and the norm (and never the
    f32 CUDA-core product), and its rows are bit-equal to batch 1."""
    from covalent_tpu_plugin_torch.models import decode
    from covalent_tpu_plugin_torch.models.transformer import TransformerConfig, TransformerLM

    cfg = TransformerConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                            max_seq=64)
    model = decode.inference_params(TransformerLM(
        cfg, device=card, generator=torch.Generator(device=card).manual_seed(0)))
    prompts = np.random.default_rng(4).integers(0, 256, (8, 12))
    _kernels.reset_launch_counts()
    batch = decode.generate(model, prompts, 10)
    counts = _kernels.serving_launch_counts()
    assert counts["bi_gemm_tc"] > 0 and counts["bi_gemm_mix"] > 0, counts
    assert counts["bi_rmsnorm"] > 0 and counts["bi_gemm"] == 0, counts
    assert _kernels.launch_counts() == {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    for row in range(8):
        assert torch.equal(batch[row:row + 1], decode.generate(model, prompts[row:row + 1], 10))


#: Widths of the norm's card tests: a multiple of 8 below one warp's 32 runs
#: (80), one off a multiple of 8 (100), the 125M LM's (768), and two past the
#: runs a lane keeps in registers (3072, 4096).
NORM_WIDTHS = (80, 100, 768, 3072, 4096)


def _norm_inputs(card, rows: int, width: int, dtype, seed: int):
    """``x``, ``delta`` (rows, width) and ``scale`` (width,) in ``dtype``."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32) * scale + shift,
                            device=card).to(dtype)

    return t(rows, width, scale=3.0), t(rows, width), t(width, scale=0.5, shift=1.0)


def _norm_tol(want: torch.Tensor) -> float:
    """One rounding of the output type (f32: sums in another order) times
    the largest plain value, at least 1: ``chip_smoke.py``'s measure."""
    return BI_TOL[want.dtype] * max(1.0, want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("width", NORM_WIDTHS)
def test_rmsnorm_kernels_match_plain_and_the_add_is_torchs(card, width):
    """The norm alone and the fused add and norm, bf16 and f32, against
    their plain versions; the fused ``s`` is torch's ``x + delta`` and the
    fused ``y`` the norm alone on ``s``, bit for bit; one launch each."""
    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    for dtype in (torch.bfloat16, torch.float32):
        x, delta, scale = _norm_inputs(card, 37, width, dtype, seed=width)
        for out in (dtype, torch.float32):
            _kernels.reset_launch_counts()
            y = bi.rms_norm(x, scale, out)
            s, y_fused = bi.add_rms_norm(x, delta, scale, out)
            assert _kernels.serving_launch_counts()["bi_rmsnorm"] == 2
            want = bi.rms_norm_plain(x, scale, out)
            want_s, want_fused = bi.add_rms_norm_plain(x, delta, scale, out)
            assert y.dtype == y_fused.dtype == out and s.dtype == dtype
            assert (y.float() - want.float()).abs().max().item() <= _norm_tol(want)
            assert (y_fused.float() - want_fused.float()).abs().max().item() <= \
                _norm_tol(want_fused)
            assert torch.equal(s, x + delta) and torch.equal(s, want_s), (dtype, out)
            assert torch.equal(y_fused, bi.rms_norm(s, scale, out)), (dtype, out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_rows_bit_equal_at_every_row_count(card, dtype):
    """Both forms at M 1, 2-7, 8, 128 and 1024 rows and each row alone give
    the bits of the same rows in the 1024-row batch, at the 125M LM's width,
    off a multiple of 8 and past the registers."""
    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    for width in (768, 100, 4096):
        x, delta, scale = _norm_inputs(card, 1024, width, dtype, seed=7)
        whole = bi.rms_norm(x, scale, dtype)
        whole_s, whole_y = bi.add_rms_norm(x, delta, scale, dtype)
        for m in (1, 2, 3, 4, 5, 6, 7, 8, 128, 1024):
            assert torch.equal(bi.rms_norm(x[:m], scale, dtype), whole[:m]), (width, m)
            s, y = bi.add_rms_norm(x[:m], delta[:m], scale, dtype)
            assert torch.equal(s, whole_s[:m]) and torch.equal(y, whole_y[:m]), (width, m)
        rows = range(1024) if width == 768 else range(0, 1024, 97)
        for row in rows:
            one = slice(row, row + 1)
            assert torch.equal(bi.rms_norm(x[one], scale, dtype), whole[one]), (width, row)
            s, y = bi.add_rms_norm(x[one], delta[one], scale, dtype)
            assert torch.equal(s, whole_s[one]) and torch.equal(y, whole_y[one]), (width, row)


@pytest.mark.cuda
def test_rmsnorm_misaligned_view_gives_the_aligned_bits(card):
    """Rows read one element at a time (a base pointer off 16 bytes) sum in
    the order of the 16-byte loads: a misaligned view of x, delta and scale
    gives the bits of an aligned copy, in both forms."""
    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    def shifted(t):
        buf = torch.zeros(t.numel() + 8, dtype=t.dtype, device=card)
        view = buf[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view

    for dtype in (torch.bfloat16, torch.float32):
        for width in (80, 768):
            x, delta, scale = _norm_inputs(card, 9, width, dtype, seed=width + 1)
            want = bi.rms_norm(x, scale, dtype)
            want_s, want_y = bi.add_rms_norm(x, delta, scale, dtype)
            sx, sd, ss = shifted(x), shifted(delta), shifted(scale)
            assert torch.equal(bi.rms_norm(sx, scale, dtype), want), (dtype, width)
            assert torch.equal(bi.rms_norm(x, ss, dtype), want), (dtype, width)
            s, y = bi.add_rms_norm(sx, sd, scale, dtype)
            assert torch.equal(s, want_s) and torch.equal(y, want_y), (dtype, width)


def test_batch_invariant_ops_take_plain_versions_on_cpu():
    """CPU tensors take the plain versions and launch nothing; the kernel
    wrappers refuse CPU tensors."""
    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((3, 5, 16), dtype=np.float32))
    w = torch.tensor(rng.standard_normal((8, 16), dtype=np.float32)).to(torch.bfloat16)
    _kernels.reset_launch_counts()
    assert torch.equal(bi.linear(x, w, torch.float32), bi.linear_plain(x, w, torch.float32))
    scale = torch.ones(16)
    assert torch.equal(bi.rms_norm(x, scale, torch.bfloat16),
                       bi.rms_norm_plain(x, scale, torch.bfloat16))
    q, k = torch.zeros(2, 1, 2, 1, 16), torch.ones(2, 7, 2, 16)
    assert torch.equal(bi.attention_scores(q, k), bi.attention_scores_plain(q, k))
    p = torch.full((2, 2, 1, 1, 7), 1 / 7)
    assert torch.equal(bi.attention_mix(p, k), bi.attention_mix_plain(p, k))
    q8 = torch.tensor(rng.integers(-127, 128, (8, 16)), dtype=torch.int8)
    s8 = torch.ones(8)
    assert torch.equal(bi.linear_w8(x, q8, s8, torch.bfloat16),
                       bi.linear_w8_plain(x, q8, s8, torch.bfloat16))
    assert _kernels.serving_launch_counts() == {"bi_gemm": 0, "bi_gemm_tc": 0, "bi_gemm_mix": 0,
                                                "bi_rmsnorm": 0, "bi_gemm_w8": 0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.bi_gemm(x[0], w, torch.empty(5, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.bi_rmsnorm(x, scale, torch.float32, 1e-6)
    with pytest.raises(ValueError, match="run on cuda or cpu"):
        bi.linear(torch.zeros(1, 2, device="meta"), w, torch.float32)


#: what the gang needs of gloo on tensors on the card (FSDP2, the
#: tensor-parallel regions, the loss and norm reductions, ring_permute)
GANG_COLLECTIVES = ("all_reduce", "all_reduce_avg", "all_reduce_max", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "all_to_all_single", "ring_permute",
                    "device_mesh", "fsdp2_step")


@pytest.mark.cuda
def test_gloo_carries_the_gangs_collectives_on_one_card(card):
    """Two ranks on one card over gloo (NCCL refuses two ranks on one
    device): every collective the gang's path issues checks out; the probe
    reports the others (point-to-point, the functional all-gather) with
    their errors."""
    from covalent_tpu_plugin_torch.parallel.probe import probe_collectives

    probe = probe_collectives(world=2, device="cuda", backend="gloo", timeout_s=300)
    assert probe["backend"] == "gloo" and probe["world"] == 2
    failed = {n: probe["collectives"][n] for n in GANG_COLLECTIVES
              if not probe["collectives"][n]["ok"]}
    assert not failed, failed
    for name, entry in probe["collectives"].items():
        assert entry["ok"] or entry.get("error"), name


def test_chip_smoke_covers_the_f32_variants_and_the_seq_gang():
    """chip_smoke.py holds the f32-output variants against their plain
    versions at both directions of a 2-ring's cross hop and at head dim 128,
    and trains the LM on the ring and on Ulysses as two-process seq gangs,
    the ring's launches all with f32 outputs."""
    chip_smoke = _chip_smoke()
    cases = chip_smoke.VARIANT_CASES
    assert {c["positions"][1:] for c in cases} >= {(0, 1), (1, 0)}
    assert {c["shape"][-1] for c in cases} == {64, 128}
    assert chip_smoke.HOP_SHAPE == (8, 12, 12, 512, 512, 64)
    arms = chip_smoke.GANG_ARMS
    assert arms["lm_ring2"] == ("lm", dict(seq=2), dict(attention="ring"), "standard")
    assert arms["lm_ulysses2"] == ("lm", dict(seq=2), dict(attention="ulysses"), "standard")
    assert chip_smoke.GANG_LAUNCHES["lm_ring2"] == {"8x12x512x64 bfloat16->float32": 24}
    assert chip_smoke.GANG_LAUNCHES["lm_ulysses2"] == {"8x6x1024x64 bfloat16": 12}


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def test_chip_smoke_covers_the_pipeline_the_moe_the_fused_loss_and_remat():
    """chip_smoke.py trains the remat and MoE arms in its train phase and the
    pipeline, the fused loss with accumulation and the MoE as tensor-parallel
    gangs, each against the train arm of the same loss, at the launches and
    rank shapes their code gives."""
    chip_smoke = _chip_smoke()
    train = {name: (road, chunk, overrides) for name, road, chunk, overrides in
             chip_smoke.TRAIN_ARMS}
    assert train["remat_dots"] == ("rpc", None, dict(remat=True, remat_policy="dots"))
    assert train["moe8"] == ("rpc", None, dict(moe_experts=8))
    assert chip_smoke.train_launches_per_step("remat_dots", "flash_fwd") == 24
    assert chip_smoke.train_launches_per_step("remat_dots", "flash_bwd_dq") == 12
    arms, launches = chip_smoke.GANG_ARMS, chip_smoke.GANG_LAUNCHES
    assert arms["lm_pipe2"] == ("lm", dict(pipe=2), dict(n_micro=4), "standard")
    assert arms["lm_tensor2_fused"] == ("lm", dict(tensor=2),
                                        dict(vocab_chunk=8192, accumulate_steps=2), "fused")
    assert arms["lm_moe_tensor2"] == ("lm", dict(tensor=2), dict(moe_experts=8), "moe8")
    assert launches["lm_pipe2"] == {"2x12x1024x64 bfloat16": 24}
    assert launches["lm_tensor2_fused"] == {"4x6x1024x64 bfloat16": 24}
    assert launches["lm_moe_tensor2"] == {"8x6x1024x64 bfloat16": 12}
    moe = {"losses": [10.0, 10.1], "moe_aux": [12.0, 30.0]}
    assert chip_smoke.lm_losses(moe) == [10.0 - 0.12, 10.1 - 0.3]
