#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``covalent_tpu_plugin_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON object per line on stdout, in this order:

1. ``device``: the card, with its name and power limit as ``nvidia-smi`` gives them.
2. ``build``: the CUDA kernels compiled from ``covalent_tpu_plugin_torch/csrc``.
3. ``parity``: each kernel against its plain PyTorch version on the card, at the
   training shape and at small GQA, window+sinks, explicit-position,
   non-causal, ragged, head dim 128, bf16, f16 and f32 cases, each with the
   tolerance it was held to.
4. ``timing``: at the training shape, and again at head dim 128, each
   kernel's device time (profiler; warm, and with the L2 cache flushed
   before every call) beside its plain version's, one PyTorch library
   call's (a yardstick only; the port never calls it) and the least time
   the card could take (``bound_ms``); and the dQ plus dK/dV kernels
   together (``backward_pair``) beside the library's backward for dq, dk
   and dv.
5. ``model_check``: a small LM on the card, flash kernels against the dense
   reference, logits and gradients.
6. ``train``: the main path.  ``GPUExecutor(transport="local")`` dispatches the
   training electron (``models.train.train_lm``): the 125M LM at full width,
   5 AdamW steps at batch 8, seq 1024, once with the standard loss and once
   with the fused vocab-chunked loss.  Losses must be finite and falling, and
   every kernel launched 12 times per step.
7. ``profile``: one training step under ``torch.profiler``: device time by
   kernel and the device's busy share; the step must run each of the three
   tensor-core kernels once per layer and no scalar kernel.
8. ``serve_check``: a small float32 LM on the card against the same model on
   the CPU: KV-cache prefill and decode logits (plain, int8 KV, rolling with
   sinks), and continuous-batching engine streams, token-equal wherever the
   CPU's top-2 logit margin exceeds 1e-4.
9. ``serve``: the serving path.  ``GPUExecutor(transport="local")`` dispatches
   the serving electron (``models.serve.serve_lm``): the 125M LM with bf16
   weights, ``generate`` at batch 8 (prompt 128, 128 new tokens) and 16
   requests through the continuous-batching engine (8 slots, sync 32).
   Every request must complete at its length, every logit be finite, the
   engine's streams equal ``continuous_generate``'s, the int8 KV cache's
   prefill logits keep cosine >= 0.999 to the float cache's, and no flash
   kernel run (the decode attention is plain products); it prints the
   agreement of engine rows with batch-1 ``generate`` rows.
10. ``serve_profile``: one batch-8 decode step of the 125M LM under
    ``torch.profiler``: device time by kind (the attention's products and
    its other kernels apart, by the ``decode_attention`` ranges), the
    device's busy share against the profiled and the unprofiled step, and
    the f32 ``lm_head``'s weight cast and product alone.
11. ``kernels``: every kernel with its launches on the main path, error, times
    and bound, and the route (tensor-core or scalar kernel) each input type
    and head dim takes.

then the card's ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
Any failed phase ends the run with a non-zero exit and no last line.  Without
a card (``torch.cuda.is_available()`` false) it exits non-zero at once.
"""

from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

#: H100 SXM data-sheet peaks (dense): tensor-core rate by input type, and HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

#: Training shape of the main path: batch, heads, kv heads, seq q, seq k, head dim.
PATH_SHAPE = (8, 12, 12, 1024, 1024, 64)
STEPS, BATCH, SEQ = 5, 8, 1024


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Time of one call of ``fn`` from CUDA events around ``iters``
    back-to-back calls after one warm-up call: device time plus whatever gap
    the host's launch cost leaves between calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


#: Bytes written between cold calls: five times the H100's 50 MB L2.
L2_FLUSH_BYTES = 256 << 20


def device_events(prof) -> list:
    """Device-side events (kernels, copies, memsets) of a profiler run,
    without user annotations mirrored onto the device timeline."""
    import torch

    return [evt for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)]


def device_ms(fn, iters: int, match: str | None = None, cold: bool = False) -> float:
    """Device time of one call of ``fn``: the summed duration of the device
    events of ``iters`` calls under torch.profiler, over ``iters``.  Host
    launch cost between calls is not counted.  ``match`` keeps only events
    whose name contains it; ``cold`` writes 256 MB before every call so the
    call finds the L2 cache cold (the write itself is not counted: give a
    ``match`` that excludes it)."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES if cold else 0, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            if cold:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    events = [e for e in device_events(prof) if match is None or match in e.name]
    if not events:
        raise AssertionError(f"the profiler recorded no device events matching {match!r}")
    return sum(e.time_range.elapsed_us() for e in events) / iters / 1e3


# --- parity: each kernel against its plain version --------------------------

#: Tolerance: ``ulps * eps(dtype) * max|plain|``.  The kernel and its plain
#: version make the same casts but sum in another order, and the forward
#: rounds P to V's type against a running max where the plain version uses
#: the final one, so bf16/f16 results may differ by about one rounding of the
#: largest value; f32 sums of up to 1024 terms differ by a few dozen ulps.
EPS = {"bfloat16": 2.0**-7, "float16": 2.0**-10, "float32": 2.0**-23}
ULPS = {"bfloat16": 1, "float16": 1, "float32": 32}
TOL_REASON = (
    "ulps * eps(dtype) * max(1, max|plain|), ulps 1 for bf16/f16 and 32 for f32: "
    "same casts, another summation order, and P rounded against the running max"
)

PARITY_CASES = [
    dict(name="path", shape=PATH_SHAPE, dtype="bfloat16", causal=True),
    dict(name="gqa_f16", shape=(2, 8, 2, 256, 256, 64), dtype="float16", causal=True),
    dict(name="window_sinks", shape=(1, 4, 2, 512, 512, 64), dtype="bfloat16",
         causal=True, window=128, sinks=4),
    dict(name="positions_f32", shape=(1, 4, 4, 256, 192, 32), dtype="float32",
         causal=True, positions=True),
    dict(name="full_f32_d128", shape=(1, 4, 4, 256, 192, 128), dtype="float32", causal=False),
    dict(name="ragged_window_d16", shape=(1, 2, 2, 100, 100, 16), dtype="float32",
         causal=True, window=7),
    # 16-bit inputs at head dim 128 (the tensor-core route's other width),
    # non-causal with S_k != S_q and a half-empty last query block, explicit
    # positions, and a ragged windowed sequence
    dict(name="gqa_bf16_d128", shape=(2, 8, 2, 256, 256, 128), dtype="bfloat16", causal=True),
    dict(name="full_bf16_ragged", shape=(1, 4, 4, 192, 100, 64), dtype="bfloat16",
         causal=False),
    dict(name="positions_f16_d128", shape=(1, 4, 4, 256, 192, 128), dtype="float16",
         causal=True, positions=True),
    dict(name="ragged_window_bf16_d128", shape=(1, 2, 2, 100, 100, 128), dtype="bfloat16",
         causal=True, window=7),
    # the two query halves of a block far apart: each 64-row warpgroup of
    # the tensor-core kernels skips several tiles the other one needs
    dict(name="split_positions_window", shape=(1, 2, 2, 128, 1100, 64), dtype="bfloat16",
         causal=True, window=64, positions="split"),
    # what only the dK/dV sweep walks: several query heads per kv head, and
    # a ragged last query tile (S_q = 100) whose missing rows the slot's lse
    # and delta must not let through, with S_k != S_q, at both widths
    dict(name="gqa_ragged_q_bf16", shape=(2, 8, 2, 100, 256, 64), dtype="bfloat16",
         causal=False),
    dict(name="gqa_ragged_q_f16_d128", shape=(2, 8, 2, 100, 256, 128), dtype="float16",
         causal=False),
]


def _case_inputs(case: dict, seed: int):
    import torch

    b, h, hkv, sq, sk, d = case["shape"]
    dtype = getattr(torch, case["dtype"])
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, dout = randn(b, h, sq, d), randn(b, hkv, sk, d), randn(b, hkv, sk, d), randn(b, h, sq, d)
    qpos = kpos = None
    if case.get("positions") == "split":
        # rows 0..63 at positions 0..63, the rest from 1000 on; keys 0..S_k-1
        qpos = torch.arange(sq, device="cuda", dtype=torch.int32)
        qpos[64:] += 1000 - 64
        kpos = torch.arange(sk, device="cuda", dtype=torch.int32)
    elif case.get("positions"):
        # a shuffled query order and every other key position: each query
        # sees key position 0, so no row is wholly masked
        qpos = torch.randperm(sq, generator=gen, device="cuda").to(torch.int32)
        kpos = (2 * torch.arange(sk, device="cuda")).to(torch.int32)
    band = (case["causal"], case.get("window"), case.get("sinks", 0))
    return q, k, v, dout, qpos, kpos, band


def _compare(name: str, got, want, dtype: str, report: dict) -> None:
    import torch

    err = (got.float() - want.float()).abs().max().item()
    tol = ULPS[dtype] * EPS[dtype] * max(want.float().abs().max().item(), 1.0)
    report[name] = {"max_abs_err": err, "tol": tol}
    if not (err <= tol and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: max abs error {err} exceeds {tol}")


def parity_case(case: dict, seed: int) -> dict:
    from covalent_tpu_plugin_torch.ops import _kernels
    from covalent_tpu_plugin_torch.ops import attention as attn

    q, k, v, dout, qpos, kpos, band = _case_inputs(case, seed)
    out, lse = _kernels.flash_fwd(q, k, v, qpos, kpos, *band)
    out_p, lse_p = attn.flash_fwd_plain(q, k, v, qpos, kpos, *band)
    # Both backward versions get the same lse and delta, from the kernel's forward.
    delta = (dout.float() * out.float()).sum(dim=-1)
    dk, dv = _kernels.flash_bwd_dkdv(q, k, v, dout, lse, delta, qpos, kpos, *band)
    dk_p, dv_p = attn.flash_bwd_dkdv_plain(q, k, v, dout, lse, delta, qpos, kpos, *band)
    dq = _kernels.flash_bwd_dq(q, k, v, dout, lse, delta, qpos, kpos, *band)
    dq_p = attn.flash_bwd_dq_plain(q, k, v, dout, lse, delta, qpos, kpos, *band)
    report: dict = {}
    dtype = case["dtype"]
    _compare("flash_fwd.out", out, out_p, dtype, report)
    _compare("flash_fwd.lse", lse, lse_p, "float32", report)
    _compare("flash_bwd_dkdv.dk", dk, dk_p, dtype, report)
    _compare("flash_bwd_dkdv.dv", dv, dv_p, dtype, report)
    _compare("flash_bwd_dq.dq", dq, dq_p, dtype, report)
    return report


# --- timing and bounds at the path shape ------------------------------------


def visible_pairs(q, k, qpos, kpos, band) -> int:
    """(query, key) pairs the band lets through, summed over batch and heads:
    the work this run's data needs."""
    from covalent_tpu_plugin_torch.ops import attention as attn

    b, h, sq, _ = q.shape
    sk = k.shape[2]
    causal, window, sinks = band
    if not causal:
        return b * h * sq * sk
    qp = attn._positions(qpos, sq, q.device)
    kp = attn._positions(kpos, sk, q.device)
    per_head = attn._band_visible(qp[:, None], kp[None, :], window, sinks).sum().item()
    return b * h * int(per_head)


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


#: The path shape at head dim 128, the tensor-core route's other width.
D128_CASE = dict(name="path_d128", shape=(8, 12, 12, 1024, 1024, 128), dtype="bfloat16",
                 causal=True)


def timing_phase(case: dict) -> dict:
    import torch
    import torch.nn.functional as F

    from covalent_tpu_plugin_torch.ops import _kernels
    from covalent_tpu_plugin_torch.ops import attention as attn

    q, k, v, dout, qpos, kpos, band = _case_inputs(case, seed=1)
    out, lse = _kernels.flash_fwd(q, k, v, qpos, kpos, *band)
    delta = (dout.float() * out.float()).sum(dim=-1)
    pairs = visible_pairs(q, k, qpos, kpos, band)
    d = q.shape[-1]
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731

    fwd_args = (q, k, v, qpos, kpos, *band)
    bwd_args = (q, k, v, dout, lse, delta, qpos, kpos, *band)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    # name: (kernel call, plain version, library yardstick, flops, bytes).
    # The library is PyTorch's fused attention: its forward, and its backward
    # asked for (dk, dv) or dq alone; the fused backward computes dq, dk and
    # dv whatever it is asked for, so both backward rows time a whole
    # backward.  Timed here only; the port never calls it.
    calls = {
        # forward: S = QK^T and PV, 2 products of 2*d flops per visible pair;
        # reads q, k, v; writes out and lse.
        "flash_fwd": (
            lambda: _kernels.flash_fwd(*fwd_args), lambda: attn.flash_fwd_plain(*fwd_args),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            4 * d * pairs, size(q, k, v, out, lse)),
        # dk/dv: recomputed S, dP = dO V^T, dV += P^T dO, dK += dS^T Q: 4
        # products; reads q, k, v, dO, lse, delta; writes dk, dv.
        "flash_bwd_dkdv": (
            lambda: _kernels.flash_bwd_dkdv(*bwd_args),
            lambda: attn.flash_bwd_dkdv_plain(*bwd_args),
            lambda: torch.autograd.grad(lib_out, (kl, vl), dout, retain_graph=True),
            8 * d * pairs, size(q, k, v, dout, lse, delta, k, v)),
        # dq: recomputed S, dP, dQ += dS K: 3 products; writes dq (q's size).
        "flash_bwd_dq": (
            lambda: _kernels.flash_bwd_dq(*bwd_args), lambda: attn.flash_bwd_dq_plain(*bwd_args),
            lambda: torch.autograd.grad(lib_out, (ql,), dout, retain_graph=True),
            6 * d * pairs, size(q, k, v, dout, lse, delta, q)),
    }
    # kernel_ms and library_ms are device time (profiler), so the host's
    # launch cost between calls, which is larger than the tensor-core
    # kernels, is not counted; *_back_to_back_ms are CUDA events around
    # back-to-back calls, host gaps included.
    results = {}
    for name, (kernel, plain, library, flops, nbytes) in calls.items():
        results[name] = dict(
            kernel_ms=device_ms(kernel, 20, match=name),
            kernel_cold_ms=device_ms(kernel, 20, match=name, cold=True),
            kernel_back_to_back_ms=time_ms(kernel, 20),
            plain_ms=time_ms(plain, 3),
            library_ms=device_ms(library, 20),
            library_back_to_back_ms=time_ms(library, 20),
            flops=flops, bytes=nbytes,
        )

    for res in results.values():
        res["bound_ms"], res["bound_by"] = bound(res["flops"], res["bytes"], case["dtype"])
    # The like-for-like backward: the two kernels that give dq, dk and dv,
    # against the library's backward asked for all three.
    results["backward_pair"] = dict(
        backward_pair_ms=device_ms(lambda: (_kernels.flash_bwd_dkdv(*bwd_args),
                                     _kernels.flash_bwd_dq(*bwd_args)), 20, match="flash_bwd_"),
        library_ms=device_ms(
            lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dout, retain_graph=True), 20),
    )
    return results


# --- small LM on the card: flash kernels against the dense reference --------


def model_check() -> dict:
    import torch

    from covalent_tpu_plugin_torch.models import TransformerConfig, TransformerLM
    from covalent_tpu_plugin_torch.models.train import cross_entropy_loss

    common = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                  d_ff=256, max_seq=256, dtype=torch.float32, sliding_window=96,
                  attention_sinks=4)
    tokens = torch.randint(0, 512, (2, 257), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))
    runs = {}
    for impl in ("flash", "reference"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = TransformerLM(TransformerConfig(**common, attention=impl), device="cuda",
                              generator=gen)
        logits = model(tokens[:, :-1])
        cross_entropy_loss(logits, tokens[:, 1:]).backward()
        runs[impl] = (logits.detach(), {n: p.grad for n, p in model.named_parameters()})
    logit_err = (runs["flash"][0] - runs["reference"][0]).abs().max().item()
    grad_err = max((runs["flash"][1][n] - g).abs().max().item()
                   for n, g in runs["reference"][1].items())
    # f32 throughout; sums in another order over up to 256 positions
    if not (logit_err <= 1e-4 and grad_err <= 1e-5):
        raise AssertionError(f"small LM: logits err {logit_err}, grad err {grad_err}")
    return {"logits_max_abs_err": logit_err, "grads_max_abs_err": grad_err,
            "tol": {"logits": 1e-4, "grads": 1e-5}}


# --- the main path: the training electron through the executor ---------------


def train_phase() -> list[dict]:
    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.models.train import train_lm

    executor = GPUExecutor(
        transport="local",
        cache_dir=str(WORK / "cache"),
        remote_cache=str(WORK / "remote"),
        remote_workdir=str(WORK / "work"),
        python_path=sys.executable,
        poll_freq=0.5,
        task_timeout=600,
        # the worker imports the port from this checkout
        task_env={"PYTHONPATH": str(ROOT)},
    )
    arms = []
    for node, vocab_chunk in enumerate((None, 8192)):
        wall = time.perf_counter()
        out = asyncio.run(executor.run(
            train_lm, [],
            dict(steps=STEPS, batch_size=BATCH, seq_len=SEQ, vocab_chunk=vocab_chunk, seed=0),
            {"dispatch_id": "chip_smoke", "node_id": node},
        ))
        out["wall_s"] = time.perf_counter() - wall
        out["vocab_chunk"] = vocab_chunk
        arms.append(out)
    return arms


def check_train(arms: list[dict]) -> None:
    import math

    for arm in arms:
        losses = arm["losses"]
        if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"losses not finite: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"loss did not fall: {losses}")
        for name, count in arm["launches"].items():
            if count != 12 * STEPS:
                raise AssertionError(f"{name} launched {count} times, expected {12 * STEPS}")
    # Same weights and batches: the two losses differ only by the fused
    # loss's bf16 cast of the lm_head weight (the reference's rule).
    first = [arm["losses"][0] for arm in arms]
    if abs(first[0] - first[1]) > 1e-2:
        raise AssertionError(f"standard and fused first losses differ: {first}")


def model_flops_per_step(n_params: int) -> float:
    """Operations one training step needs, recomputation not counted: 6 per
    non-embedding parameter per token for the matmuls (forward and
    backward), plus attention's QK^T and PV over the causal pairs (4*d per
    pair forward, twice that backward) in every layer."""
    from covalent_tpu_plugin_torch.models.transformer import lm_125m_config

    cfg = lm_125m_config()
    tokens = BATCH * SEQ
    pairs = BATCH * cfg.n_heads * SEQ * (SEQ + 1) // 2
    matmul = 6 * tokens * (n_params - cfg.vocab_size * cfg.d_model)
    return float(matmul + cfg.n_layers * 12 * cfg.head_dim * pairs)


def profile_phase() -> dict:
    """One training step of the 125M LM in this process under torch.profiler."""
    import torch

    from covalent_tpu_plugin_torch.models import data, train
    from covalent_tpu_plugin_torch.models.transformer import TransformerLM, lm_125m_config

    model = TransformerLM(lm_125m_config(), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(0))
    step = train.make_train_step(model, train.adamw(model))
    batch = data.synthetic_lm_batch(BATCH, SEQ + 1, 32768, seed=0)
    step(batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
    # Device-side events only, summed by name: CPU-side operator rows carry
    # their kernels' time too, and user annotations mirrored onto the device
    # timeline span other kernels, so either would count time twice.
    by_name: dict[str, tuple[float, int]] = {}
    for evt in device_events(prof):
        us, n = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (us + evt.time_range.elapsed_us(), n + 1)
    rows = sorted(((us, key, n) for key, (us, n) in by_name.items()), reverse=True)
    if not rows:
        raise AssertionError("the profiler recorded no device events")
    # The bf16, head dim 64 step must run each tensor-core kernel once per
    # layer and no scalar kernel.  No tag is a substring of another kernel's
    # name.
    sweeps = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")
    launched = {tag: sum(n for _, key, n in rows if tag in key)
                for sweep in sweeps for tag in (f"{sweep}_tc_kernel", f"{sweep}_kernel")}
    layers = lm_125m_config().n_layers
    if any(launched[f"{sweep}_tc_kernel"] != layers or launched[f"{sweep}_kernel"]
           for sweep in sweeps):
        raise AssertionError(f"profiled step launched {launched}; expected {layers} of each "
                             "tensor-core kernel and no scalar kernel")
    total_us = sum(r[0] for r in rows)
    kinds = {"flash_kernels": 0.0, "matmul": 0.0, "other": 0.0}
    for us, key, _ in rows:
        if "flash_" in key and "_kernel" in key:
            kinds["flash_kernels"] += us / 1e3
        elif any(tag in key for tag in ("gemm", "xmma", "cutlass", "nvjet")):
            kinds["matmul"] += us / 1e3
        else:
            kinds["other"] += us / 1e3
    return {
        "step_wall_ms": wall * 1e3,
        "device_ms": total_us / 1e3,
        "device_busy_share": total_us / 1e3 / (wall * 1e3),
        "device_ms_by_kind": kinds,
        "flash_launches_by_kernel": launched,
        "flash_ms_by_kernel": {tag: sum(us for us, key, _ in rows if tag in key) / 1e3
                               for tag in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")},
        "top": [{"name": k[:80], "ms": us / 1e3, "calls": n} for us, k, n in rows[:12]],
    }


# --- serving: KV-cache decoding, generate and the continuous-batching engine --

#: The small LM of ``serve_check``: width and depth of the CPU parity tests.
SERVE_TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                  max_seq=64)
#: f32 logits of the card against the CPU: the same products, summed in
#: another order through two layers.
SERVE_LOGIT_TOL = 1e-4
SERVE_MARGIN = 1e-4


def serve_check() -> dict:
    import numpy as np
    import torch

    from covalent_tpu_plugin_torch.models import decode, serve
    from covalent_tpu_plugin_torch.models.transformer import TransformerConfig, TransformerLM

    def pair(**overrides):
        cfg = TransformerConfig(**SERVE_TINY, **overrides, dtype=torch.float32,
                                attention="reference")
        cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            cpu.lm_head.weight.mul_(10.0)  # spread the logits: clear greedy margins
        gpu = TransformerLM(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        return cpu, gpu

    rng = np.random.default_rng(9)
    prompt = torch.tensor(rng.integers(0, 256, (4, 24)))
    calls = [prompt[:, s:s + 8] for s in range(0, 24, 8)] + [
        torch.tensor(rng.integers(0, 256, (4, 1))) for _ in range(4)]

    def decode_calls(model):
        cache = decode.init_cache(model, 4)
        with torch.no_grad():
            return [model(c.to(model.embedding.device), cache=cache).cpu() for c in calls]

    logit_errs = {}
    for name, overrides in (("plain", {}), ("int8_kv", dict(quantized_kv_cache=True)),
                            ("rolling_sinks", dict(sliding_window=8, attention_sinks=2,
                                                   rolling_cache=True))):
        cpu, gpu = pair(**overrides)
        err = max((a - b).abs().max().item()
                  for a, b in zip(decode_calls(gpu), decode_calls(cpu)))
        logit_errs[name] = err
        if not err <= SERVE_LOGIT_TOL:
            raise AssertionError(f"serve_check {name}: card logits off by {err}")

    cpu, gpu = pair()
    prompts = [rng.integers(0, 256, 3 + i % 6).astype(np.int32) for i in range(10)]
    caps = [5 + 3 * (i % 4) for i in range(10)]
    streams = []
    for model in (cpu, gpu):
        engine = serve.ContinuousEngine(model, max_batch=4, sync_steps=4, max_new_tokens=16)
        queue, got = list(range(10)), {}
        while queue or engine.busy:
            while queue and engine.busy < engine.slots:
                i = queue.pop(0)
                engine.admit(str(i), prompts[i], {"max_new_tokens": caps[i]})
            for event in engine.step():
                got.setdefault(int(event["rid"]), []).extend(event["tokens"])
        streams.append([got[i] for i in range(10)])
    # compare up to each CPU stream's first near-tie
    compared = equal = 0
    for p, want, have in zip(prompts, *streams):
        seq = torch.tensor(np.concatenate([p, want]))[None]
        with torch.no_grad():
            logits = cpu(seq)[0, p.size - 1:-1]
        top2 = torch.topk(logits, 2).values
        clear = (top2[:, 0] - top2[:, 1] > SERVE_MARGIN).tolist() + [False]
        n = clear.index(False)
        compared += n
        equal += int(have[:n] == want[:n])
        if have[:n] != want[:n]:
            raise AssertionError(f"serve_check: card stream {have} != CPU stream {want}")
    return {"logits_max_abs_err": logit_errs, "tol": SERVE_LOGIT_TOL,
            "engine_streams_equal": equal, "engine_streams": len(prompts),
            "tokens_compared": compared, "margin": SERVE_MARGIN}


def serve_phase() -> dict:
    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.models.serve import serve_lm

    executor = GPUExecutor(
        transport="local", cache_dir=str(WORK / "cache"), remote_cache=str(WORK / "remote"),
        remote_workdir=str(WORK / "work"), python_path=sys.executable, poll_freq=0.5,
        task_timeout=600, task_env={"PYTHONPATH": str(ROOT)},
    )
    wall = time.perf_counter()
    out = asyncio.run(executor.run(serve_lm, [], {"seed": 0},
                                   {"dispatch_id": "chip_smoke", "node_id": 2}))
    out["electron_wall_s"] = time.perf_counter() - wall
    serve = out["serve"]
    problems = []
    if not (serve["complete"] and out["decode"]["shape_ok"]):
        problems.append("a request is incomplete or has the wrong length")
    if not out["logits_finite"]:
        problems.append("non-finite logits")
    if not out["continuous_generate"]["streams_equal_engine"]:
        problems.append("engine streams differ from continuous_generate's")
    if not out["kv_int8_logit_cosine"] >= 0.999:
        problems.append(f"int8 KV logit cosine {out['kv_int8_logit_cosine']} < 0.999")
    if any(out["flash_launches"].values()):
        problems.append(f"the decode path launched flash kernels: {out['flash_launches']}")
    if problems:
        raise AssertionError("serve: " + "; ".join(problems))
    serve["streams"] = f"{len(serve['streams'])} streams, equal to continuous_generate's"
    return out


#: kernel-name fragments of cuBLAS/CUTLASS matrix products
MATMUL_TAGS = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitK")


def serve_profile() -> dict:
    """One batch-8 decode step of the 125M LM (bf16 weights, 8 live rows at
    position 128) under torch.profiler, in this process."""
    import numpy as np
    import torch

    from covalent_tpu_plugin_torch.models import decode, serve
    from covalent_tpu_plugin_torch.models.transformer import TransformerLM, lm_125m_config

    model = decode.inference_params(TransformerLM(
        lm_125m_config(max_seq=512), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0)))
    engine = serve.ContinuousEngine(model, max_batch=8, sync_steps=4, max_new_tokens=256)
    rng = np.random.default_rng(1)
    for i in range(8):
        engine.admit(str(i), rng.integers(0, 32768, 128), {"max_new_tokens": 256})
    step = lambda: serve._run_steps(model, engine._state, 1, 0.0, None, None, None)  # noqa: E731
    with torch.no_grad():
        engine.step()  # admission wave and 4 warm steps
        torch.cuda.synchronize()
        # the same step unprofiled: host clock around 16 steps and a sync
        unprofiled = time.perf_counter()
        for _ in range(16):
            step()
        torch.cuda.synchronize()
        unprofiled = (time.perf_counter() - unprofiled) / 16
        # the lm_head's bf16 weight goes back to f32 every step (the
        # reference's f32 logits), then an f32 product
        weight = model.lm_head.weight
        feats = torch.randn(8, 1, weight.shape[1], device="cuda")
        lm_head_cast_ms = device_ms(lambda: weight.to(torch.float32), 20)
        w32 = weight.to(torch.float32)
        lm_head_gemm_ms = device_ms(lambda: torch.nn.functional.linear(feats, w32), 20)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            wall = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - wall
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e.time_range for e in events if getattr(e, "is_user_annotation", False)
             and e.name == "decode_attention"]
    kernels = [e for e in events if not getattr(e, "is_user_annotation", False)]
    if not kernels or len(spans) != model.config.n_layers:
        raise AssertionError(f"serve_profile: {len(kernels)} device events and {len(spans)} "
                             "decode_attention ranges on the device; expected one a layer")

    def in_attention(evt) -> bool:
        r = evt.time_range
        return any(s.start <= r.start and r.end <= s.end for s in spans)

    kinds = {"attention_products": 0.0, "attention_other": 0.0, "matmul": 0.0,
             "elementwise_other": 0.0}
    by_name: dict[str, list] = {}
    for evt in kernels:
        ms = evt.time_range.elapsed_us() / 1e3
        gemm = any(tag in evt.name for tag in MATMUL_TAGS)
        if in_attention(evt):
            kinds["attention_products" if gemm else "attention_other"] += ms
        else:
            kinds["matmul" if gemm else "elementwise_other"] += ms
        entry = by_name.setdefault(evt.name, [0.0, 0])
        entry[0] += ms
        entry[1] += 1
    step_device_ms = sum(kinds.values())
    engine.close()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "step_wall_ms": wall * 1e3, "unprofiled_step_wall_ms": unprofiled * 1e3,
        "device_ms": step_device_ms,
        "device_busy_share": step_device_ms / (wall * 1e3),
        "device_busy_share_unprofiled": step_device_ms / (unprofiled * 1e3),
        "lm_head_cast_ms": lm_head_cast_ms, "lm_head_gemm_ms": lm_head_gemm_ms,
        "device_ms_by_kind": kinds, "kernel_launches": len(kernels),
        "top": [{"name": n[:80], "ms": ms, "calls": c} for n, (ms, c) in top],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    from covalent_tpu_plugin_torch.ops import _kernels

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    start = time.perf_counter()
    libs = _kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - start,
          "libraries": sorted(str(p.relative_to(ROOT)) for p in libs.values())})

    parity = {}
    for i, case in enumerate(PARITY_CASES):
        parity[case["name"]] = parity_case(case, seed=100 + i)
        torch.cuda.synchronize()
        emit({"phase": "parity", "case": case["name"], "shape": case["shape"],
              "dtype": case["dtype"], "causal": case["causal"],
              "window": case.get("window"), "sinks": case.get("sinks", 0),
              "positions": case.get("positions", False), "errors": parity[case["name"]],
              "tol_reason": TOL_REASON})

    timing = timing_phase(PARITY_CASES[0])
    emit({"phase": "timing", "shape": PATH_SHAPE, "dtype": "bfloat16", "card": smi,
          "kernels": timing})
    emit({"phase": "timing", "shape": D128_CASE["shape"], "dtype": D128_CASE["dtype"],
          "card": smi, "kernels": timing_phase(D128_CASE)})

    emit({"phase": "model_check", **model_check()})

    # The main path.  Each wrapper counts its launches in the process that
    # launches it; the electrons run in the harness subprocess, which starts
    # at 0 and reports its counts, so the path's launches are ours (0 after
    # the reset) plus the worker's.
    _kernels.reset_launch_counts()
    arms = train_phase()
    local = _kernels.launch_counts()
    check_train(arms)
    launches = {name: local[name] + sum(arm["launches"][name] for arm in arms)
                for name in local}
    model_flops = model_flops_per_step(arms[0]["n_params"])
    for arm in arms:
        steady = statistics.median(arm["step_s"][1:])
        emit({"phase": "train", "vocab_chunk": arm["vocab_chunk"], "losses": arm["losses"],
              "step_s": arm["step_s"], "steady_step_ms": steady * 1e3,
              "tokens_per_s": arm["tokens_per_step"] / steady,
              "model_flops_per_step": model_flops,
              "model_flops_utilization": model_flops / steady / PEAK_FLOPS["bfloat16"],
              "launches": arm["launches"],
              "launches_per_step": {k: n / STEPS for k, n in arm["launches"].items()},
              "n_params": arm["n_params"], "peak_mem_bytes": arm["peak_mem_bytes"],
              "electron_wall_s": arm["wall_s"], "device": arm["device"], "card": smi})

    emit({"phase": "profile", "card": smi, **profile_phase()})

    emit({"phase": "serve_check", **serve_check()})
    # The serving path.  It runs no kernel of the port (its attention is
    # plain products over the KV cache): the electron resets the launch
    # counts in its own process and reports them, and they must stay 0.
    _kernels.reset_launch_counts()
    served = serve_phase()
    if any(_kernels.launch_counts().values()):
        raise AssertionError(f"serve: flash kernels launched {_kernels.launch_counts()}")
    emit({"phase": "serve", "card": smi, **served})
    emit({"phase": "serve_profile", "card": smi, **serve_profile()})

    kernels = []
    for kernel in _kernels.KERNELS:
        res = timing[kernel.name]
        path_errs = [v["max_abs_err"] for k, v in parity["path"].items()
                     if k.startswith(kernel.name + ".")]
        kernels.append({
            "name": kernel.name, "route": "cuda",
            "source": f"covalent_tpu_plugin_torch/csrc/{kernel.source}",
            "replaces": kernel.replaces, "launches": launches[kernel.name],
            "max_abs_err": max(path_errs), "ms": res["kernel_ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["library_ms"], "ms_cold_l2": res["kernel_cold_ms"],
            # the kernel each (dtype/head dim) takes; the path is bfloat16/64
            "routes": {f"{dt}/{d}": kernel.route(getattr(torch, dt), d)
                       for dt in ("bfloat16", "float16", "float32") for d in _kernels.HEAD_DIMS},
        })
        if launches[kernel.name] < 1:
            raise AssertionError(f"{kernel.name} was not launched on the main path")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
