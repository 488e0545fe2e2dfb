#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``covalent_tpu_plugin_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON object per line on stdout, in this order:

1. ``device``: the card, with its name and power limit as ``nvidia-smi`` gives them.
2. ``build``: the CUDA kernels compiled from ``covalent_tpu_plugin_torch/csrc``.
3. ``parity``: each kernel against its plain PyTorch version on the card, at the
   training shape and at small GQA, window+sinks, explicit-position, f16 and f32
   cases, each with the tolerance it was held to.
4. ``timing``: at the training shape, each kernel's time beside its plain
   version's, one PyTorch library call's (a yardstick only; the port never
   calls it) and the least time the card could take (``bound_ms``).
5. ``model_check``: a small LM on the card, flash kernels against the dense
   reference, logits and gradients.
6. ``train``: the main path.  ``GPUExecutor(transport="local")`` dispatches the
   training electron (``models.train.train_lm``): the 125M LM at full width,
   5 AdamW steps at batch 8, seq 1024, once with the standard loss and once
   with the fused vocab-chunked loss.  Losses must be finite and falling, and
   every kernel launched 12 times per step.
7. ``profile``: one training step under ``torch.profiler``: device time by
   kernel and the device's busy share.
8. ``kernels``: every kernel with its launches on the main path, error, times
   and bound.

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
    """Device time of one call of ``fn``, from CUDA events over ``iters`` calls
    after one warm-up call."""
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
    if case.get("positions"):
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


def timing_phase() -> dict:
    import torch
    import torch.nn.functional as F

    from covalent_tpu_plugin_torch.ops import _kernels
    from covalent_tpu_plugin_torch.ops import attention as attn

    case = PARITY_CASES[0]
    q, k, v, dout, qpos, kpos, band = _case_inputs(case, seed=1)
    out, lse = _kernels.flash_fwd(q, k, v, qpos, kpos, *band)
    delta = (dout.float() * out.float()).sum(dim=-1)
    pairs = visible_pairs(q, k, qpos, kpos, band)
    d = q.shape[-1]
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731

    fwd_args = (q, k, v, qpos, kpos, *band)
    bwd_args = (q, k, v, dout, lse, delta, qpos, kpos, *band)
    results = {}
    # forward: S = QK^T and PV, 2 products of 2*d flops per visible pair;
    # reads q, k, v; writes out and lse.
    results["flash_fwd"] = dict(
        kernel_ms=time_ms(lambda: _kernels.flash_fwd(*fwd_args), 20),
        plain_ms=time_ms(lambda: attn.flash_fwd_plain(*fwd_args), 3),
        flops=4 * d * pairs, bytes=size(q, k, v, out, lse),
    )
    # dk/dv: recomputed S, dP = dO V^T, dV += P^T dO, dK += dS^T Q: 4 products;
    # reads q, k, v, dO, lse, delta; writes dk, dv.
    results["flash_bwd_dkdv"] = dict(
        kernel_ms=time_ms(lambda: _kernels.flash_bwd_dkdv(*bwd_args), 10),
        plain_ms=time_ms(lambda: attn.flash_bwd_dkdv_plain(*bwd_args), 3),
        flops=8 * d * pairs, bytes=size(q, k, v, dout, lse, delta, k, v),
    )
    # dq: recomputed S, dP, dQ += dS K: 3 products; writes dq (q's size).
    results["flash_bwd_dq"] = dict(
        kernel_ms=time_ms(lambda: _kernels.flash_bwd_dq(*bwd_args), 10),
        plain_ms=time_ms(lambda: attn.flash_bwd_dq_plain(*bwd_args), 3),
        flops=6 * d * pairs, bytes=size(q, k, v, dout, lse, delta, q),
    )

    # Library yardstick: PyTorch's fused attention, forward, and its backward
    # asked for (dk, dv) or dq alone.  Timed here only; the port never calls it.
    results["flash_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    results["flash_bwd_dkdv"]["library_ms"] = time_ms(
        lambda: torch.autograd.grad(lib_out, (kl, vl), dout, retain_graph=True), 10)
    results["flash_bwd_dq"]["library_ms"] = time_ms(
        lambda: torch.autograd.grad(lib_out, (ql,), dout, retain_graph=True), 10)

    for res in results.values():
        res["bound_ms"], res["bound_by"] = bound(res["flops"], res["bytes"], case["dtype"])
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
    # Device-side events only (kernels, copies, memsets), summed by name:
    # CPU-side operator rows carry their kernels' time too, and user
    # annotations mirrored onto the device timeline span other kernels, so
    # either would count time twice.
    by_name: dict[str, tuple[float, int]] = {}
    for evt in prof.events():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        us, n = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (us + evt.time_range.elapsed_us(), n + 1)
    rows = sorted(((us, key, n) for key, (us, n) in by_name.items()), reverse=True)
    if not rows:
        raise AssertionError("the profiler recorded no device events")
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
        "top": [{"name": k[:80], "ms": us / 1e3, "calls": n} for us, k, n in rows[:12]],
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
              "positions": bool(case.get("positions")), "errors": parity[case["name"]],
              "tol_reason": TOL_REASON})

    timing = timing_phase()
    emit({"phase": "timing", "shape": PATH_SHAPE, "dtype": "bfloat16", "card": smi,
          "kernels": timing})

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
            "library_ms": res["library_ms"],
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
