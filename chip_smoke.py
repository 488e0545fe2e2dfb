#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``covalent_tpu_plugin_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON object per line on stdout, in this order:

1. ``device``: the card, with its name and power limit as ``nvidia-smi`` gives them.
2. ``startup``: what a fresh interpreter pays before an electron's first op
   on the card: the interpreter alone, ``import torch``, ``import
   covalent_tpu_plugin_torch``, ``import torch._dynamo`` (a torch
   optimizer's first construction imports it), ``torch.cuda.init()`` and
   the first op (the context's creation); medians of 3.
3. ``build``: the CUDA kernels compiled from ``covalent_tpu_plugin_torch/csrc``.
4. ``parity``: each kernel against its plain PyTorch version on the card, at the
   training shape and at small GQA, window+sinks, explicit-position,
   non-causal, ragged, head dim 128, bf16, f16 and f32 cases, each with the
   tolerance it was held to.
5. ``timing``: at the training shape, and again at head dim 128, each
   kernel's device time (profiler; warm, and with the L2 cache flushed
   before every call) beside its plain version's, one PyTorch library
   call's (a yardstick only; the port never calls it) and the least time
   the card could take (``bound_ms``); and the dQ plus dK/dV kernels
   together (``backward_pair``) beside the library's backward for dq, dk
   and dv.
6. ``model_check``: a small LM on the card, flash kernels against the dense
   reference, logits and gradients.
7. ``train``: the main path.  ``GPUExecutor(transport="local")`` dispatches the
   training electron (``models.train.train_lm``): the 125M LM at full width,
   5 AdamW steps at batch 8, seq 1024, with the standard loss and with the
   fused vocab-chunked loss, each in a fresh interpreter (launch mode), then
   the standard loss again by RPC inside a fresh pool server.  Losses must
   be finite and falling, the RPC arm's within 1e-2 of the first arm's (the
   line says whether the bits are equal), and every kernel launched 12
   times per step in every arm.
8. ``profile``: one training step under ``torch.profiler``: device time by
   kernel and the device's busy share; the step must run each of the three
   tensor-core kernels once per layer and no scalar kernel.
9. ``serve_check``: a small float32 LM on the card against the same model on
   the CPU: KV-cache prefill and decode logits (plain, int8 KV, rolling with
   sinks), and continuous-batching engine streams, token-equal wherever the
   CPU's top-2 logit margin exceeds 1e-4.
10. ``serve``: the serving path.  ``GPUExecutor(transport="local")`` dispatches
    the serving electron (``models.serve.serve_lm``): the 125M LM with bf16
    weights, ``generate`` at batch 8 (prompt 128, 128 new tokens) and 16
    requests through the continuous-batching engine (8 slots, sync 32).
    Every request must complete at its length, every logit be finite, the
    engine's streams equal ``continuous_generate``'s, the int8 KV cache's
    prefill logits keep cosine >= 0.999 to the float cache's, and no flash
    kernel run (the decode attention is plain products); it prints the
    agreement of engine rows with batch-1 ``generate`` rows.
11. ``serve_profile``: one batch-8 decode step of the 125M LM under
    ``torch.profiler``: device time by kind (the attention's products and
    its other kernels apart, by the ``decode_attention`` ranges), the
    device's busy share against the profiled and the unprofiled step, and
    the f32 ``lm_head``'s weight cast and product alone.
12. ``session``: the serving cell through the resident session.
    ``serving.open_session`` on ``GPUExecutor(use_agent="pool")`` opens the
    125M LM (bf16 weights built on the card in the pool server from seed 0;
    the factory ships the config and the seed) and serves the ``serve``
    phase's 16 requests through one handle: open seconds, payload bytes,
    the first request's TTFT and latency (the worker cold), then on the
    warm worker tokens/s, TTFT and completion p50/p95 on the dispatcher,
    streams equal to the ``serve`` phase's with the top-2 margin of each
    that differs, the worker's peak memory and its flash launches (0).
    Then the same traffic
    again with the pool server killed once every stream has its first
    tokens: every stream must complete at its budget, its chunks contiguous
    on each generation and its delivered tokens the exact splice of them;
    the replayed tokens that differ from the delivered ones are counted.
13. ``lattice``: the source paper's own workloads (BASELINE configs 2-4), each
    electron a ``@ct.electron`` of a ``@ct.lattice`` of
    ``covalent_tpu_plugin_torch.workflow``, dispatched with ``ct.dispatch_sync``,
    in three arms, each on its own ``GPUExecutor``: ``launch`` (a fresh
    interpreter per electron), ``pool_run`` (each electron forked from the
    pool server's zygote) and ``rpc`` (each electron by digest inside the
    pool server).  Per arm: the first electron on the fresh executor
    (``pool_start_s``: the pool server's start); config 2, the bf16 4096 x
    4096 chain of 16 products rescaled by 1/4096 (TFLOP/s, MFU, ``check``
    exactly 1.0); the dispatch overhead of a warm trivial electron over 5
    probes (``last_timings``), against BASELINE's budget of 2 s; config 3,
    three fan-outs of 8 electrons (trivial, 0.3 s of sleep, one MNIST MLP
    Adam step on the card each), 3 trials each; config 4, the MNIST MLP and
    CNN (``models.train.train_mnist``: 64 batches of 256, loss first and
    last, steps/s).  Every electron must take its arm's road, and the warm
    arms' values must equal the launch arm's.  Then, with the pool server
    holding a CUDA context from the RPC electrons, one CUDA electron
    through the pool's ``run`` verb (a zygote fork) on the same pool.  No
    flash kernel runs.
14. ``kernels``: every kernel with its launches on the main path, error, times
    and bound, and the route (tensor-core or scalar kernel) each input type
    and head dim takes.

then the card's ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
Any failed phase ends the run with a non-zero exit and no last line.  Without
a card (``torch.cuda.is_available()`` false) it exits non-zero at once.
"""

from __future__ import annotations

import asyncio
import json
import os
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
#: Loss tolerance between training arms of the same weights and batches.
TRAIN_LOSS_TOL = 1e-2


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
    # A profiling window whose device activity the tracer did not deliver
    # (seen once, on a 20-call window of one GEMM) is profiled again, up to
    # three windows; a window with events is the measurement.
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                if cold:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        events = [e for e in device_events(prof) if match is None or match in e.name]
        if events:
            return sum(e.time_range.elapsed_us() for e in events) / iters / 1e3
    raise AssertionError(f"the profiler recorded no device events matching {match!r} "
                         "in three windows")


# --- startup: what a fresh interpreter pays before an electron's first op ----

#: Fresh interpreters per measurement (median reported).
STARTUP_RUNS = 3
_STARTUP_PROBE = r"""
import json, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
import covalent_tpu_plugin_torch
t2 = time.perf_counter()
import torch._dynamo
t3 = time.perf_counter()
torch.cuda.init()
t4 = time.perf_counter()
torch.ones(1, device="cuda").add_(1)
torch.cuda.synchronize()
t5 = time.perf_counter()
print(json.dumps({"import_torch_s": t1 - t0, "import_port_s": t2 - t1,
                  "import_dynamo_s": t3 - t2, "cuda_init_s": t4 - t3, "first_op_s": t5 - t4}))
"""


def startup_phase() -> dict:
    """A launch-mode electron's start, split: the interpreter alone
    (``python -c pass``), ``import torch``, ``import
    covalent_tpu_plugin_torch`` after it, ``import torch._dynamo`` (what a
    torch optimizer imports at its first construction), ``torch.cuda.init()``,
    and the first op on the card (the context's creation); each a median of
    ``STARTUP_RUNS`` fresh interpreters."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH", "")])))
    runs = []
    for _ in range(STARTUP_RUNS):
        start = time.perf_counter()
        subprocess.run([sys.executable, "-c", "pass"], check=True, timeout=120)
        interpreter = time.perf_counter() - start
        start = time.perf_counter()
        probe = subprocess.run([sys.executable, "-c", _STARTUP_PROBE], capture_output=True,
                               text=True, check=True, timeout=300, env=env)
        run = json.loads(probe.stdout.strip().splitlines()[-1])
        run.update(interpreter_s=interpreter, process_wall_s=time.perf_counter() - start)
        runs.append(run)
    return {"median": {key: statistics.median(run[key] for run in runs) for key in runs[0]},
            "runs": runs}


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
    """The training electron three times: the standard and the fused loss
    each in a fresh interpreter (launch mode, nohup + poll), then the
    standard loss over RPC inside a fresh pool server."""
    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.models.train import train_lm

    common = dict(
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
    launch = GPUExecutor(**common, use_agent=False)
    rpc = GPUExecutor(**{**common, "remote_cache": str(WORK / "remote_rpc")},
                      dispatch_mode="rpc")

    async def run_arms():
        arms = []
        try:
            for node, (executor, vocab_chunk) in enumerate(
                    ((launch, None), (launch, 8192), (rpc, None))):
                wall = time.perf_counter()
                out = await executor.run(
                    train_lm, [],
                    dict(steps=STEPS, batch_size=BATCH, seq_len=SEQ, vocab_chunk=vocab_chunk,
                         seed=0),
                    {"dispatch_id": "chip_smoke", "node_id": node},
                )
                out["wall_s"] = time.perf_counter() - wall
                out["vocab_chunk"] = vocab_chunk
                out["dispatch_mode"] = executor.last_dispatch_mode
                out["timings"] = dict(executor.last_timings)
                arms.append(out)
        finally:
            await rpc.close()
        return arms

    arms = asyncio.run(run_arms())
    if [arm["dispatch_mode"] for arm in arms] != ["launch", "launch", "rpc"]:
        raise AssertionError(f"train: roads {[arm['dispatch_mode'] for arm in arms]}")
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
    if abs(first[0] - first[1]) > TRAIN_LOSS_TOL:
        raise AssertionError(f"standard and fused first losses differ: {first}")
    # The RPC arm is the first arm's electron in another process: every
    # step's loss within the same tolerance (equal bits when the kernels
    # and the GEMMs are deterministic, reported by the train line).
    gaps = [abs(a - b) for a, b in zip(arms[2]["losses"], arms[0]["losses"])]
    if max(gaps) > TRAIN_LOSS_TOL:
        raise AssertionError(f"RPC arm's losses {arms[2]['losses']} differ from "
                             f"{arms[0]['losses']}")


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
        task_timeout=600, task_env={"PYTHONPATH": str(ROOT)}, use_agent=False,
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
    # kept for the session phase; the printed line says what was checked
    out["_streams"] = serve["streams"]
    serve["streams"] = f"{len(serve['streams'])} streams, equal to continuous_generate's"
    return out


# --- the resident serving session: open_session through the pool server ------

#: The ``serve`` cell's traffic (``serve_lm``'s defaults): 16 requests of 128
#: prompt tokens, budgets 128 (even index) and 32 (odd), 8 slots, sync 32.
SESSION = dict(requests=16, prompt_len=128, long=128, short=32, slots=8, sync_steps=32,
               decode_batch=8)


def counting_factory(inner):
    """Wrap an engine factory so that the engine's stats (and so every
    ``serve.stats`` record) carry the worker's flash-kernel launch counts,
    and ``first_wave``: the requests admitted at the first step after the
    engine was idle, for the latest burst of traffic.  Defined here, it
    ships by value; ``inner`` is the port's, pickled by reference."""

    def factory():
        from covalent_tpu_plugin_torch.ops import _kernels

        engine = inner()
        _kernels.reset_launch_counts()
        step = engine.step
        idle = [True]

        def step_and_count():
            if idle[0]:
                engine.stats["first_wave"] = engine.busy
            events = step()
            idle[0] = engine.busy == 0
            engine.stats.update({f"launches.{k}": n for k, n in _kernels.launch_counts().items()})
            return events

        engine.step = step_and_count
        return engine

    return factory


def session_prompts(vocab: int) -> tuple[list, list]:
    """The serve phase's prompts and budgets: ``serve_lm`` draws its decode
    batch from the same generator first."""
    import numpy as np

    rng = np.random.default_rng(0)
    rng.integers(0, vocab, (SESSION["decode_batch"], SESSION["prompt_len"]))
    prompts = [rng.integers(0, vocab, SESSION["prompt_len"]).astype(np.int32)
               for _ in range(SESSION["requests"])]
    caps = [SESSION["long"] if i % 2 == 0 else SESSION["short"] for i in range(len(prompts))]
    return prompts, caps


async def _serve_session(executor, serve_streams: list, config, device: str) -> dict:
    import numpy as np
    import torch

    from covalent_tpu_plugin_torch.models import decode, serve
    from covalent_tpu_plugin_torch.models.transformer import TransformerLM
    from covalent_tpu_plugin_torch.serving import open_session

    prompts, caps = session_prompts(config.vocab_size)
    factory = counting_factory(serve.lm_engine_factory(
        config=config, seed=0, device=device, max_batch=SESSION["slots"],
        sync_steps=SESSION["sync_steps"], max_new_tokens=SESSION["long"]))

    wall = time.perf_counter()
    handle = await open_session(executor, factory, stats_interval_s=1.0, open_timeout_s=300)
    open_s = time.perf_counter() - wall

    async def traffic():
        start = time.perf_counter()
        requests = await asyncio.gather(*(
            handle.request(p, params={"max_new_tokens": c}) for p, c in zip(prompts, caps)))
        return start, requests

    # the first request after the open finds the worker cold (CUDA's lazy
    # module loading, the GEMM libraries' set-up); serve_lm's serve arm runs
    # after its decode arm has warmed the same process.  Its prompt shares
    # no prefix with the timed run's, so the prefix tree stays cold for them.
    warm_prompt = np.random.default_rng(1).integers(0, config.vocab_size, SESSION["prompt_len"])
    warm = await handle.request(warm_prompt, params={"max_new_tokens": SESSION["short"]})
    await warm.result(timeout=600)

    # timed run: 16 requests at once through the one handle
    start, requests = await traffic()
    results = await asyncio.gather(*(r.result(timeout=600) for r in requests))
    wall = time.perf_counter() - start
    ttft = [r.ttft_s for r in requests]
    latency = [r.latency_s for r in requests]
    # the worker's first serve.stats after the last completion: its flash
    # launches and peak memory cover the timed run
    while handle.stats.get("served", 0) < len(prompts) + 1:
        await asyncio.sleep(0.05)
    timed_stats = dict(handle.stats)

    # the reconnect check: the same traffic again; kill the pool server once
    # every stream has its first tokens; record every token record by
    # generation to check the splice
    sup = handle.supervisor
    wire: dict = {}
    inner_sink = sup._sink

    def recording_sink(sid_g, data):
        if data.get("type") == "serve.token":
            wire.setdefault((data["rid"], sid_g), []).append((data["idx"], list(data["tokens"])))
        inner_sink(sid_g, data)

    sup._sink = recording_sink
    sup._client.watch_serve(sup._sid_g, recording_sink)
    _, again = await traffic()
    while not all(r.tokens or r.done for r in again):
        await asyncio.sleep(0.01)
    before_kill = {r.rid: len(r.tokens) for r in again}
    killed_at = time.perf_counter()
    executor._agents["localhost"]._process._proc.kill()
    while not (handle.reconnects == 1 and handle.state == "open") and handle.state != "failed":
        await asyncio.sleep(0.01)
    reconnect_s = time.perf_counter() - killed_at
    outcomes = await asyncio.gather(*(r.result(timeout=600) for r in again),
                                    return_exceptions=True)
    closed = await handle.close()
    stats = dict(handle.stats)  # the new generation's last serve.stats, sent at its close

    problems = []
    if any(len(s) != c for s, c in zip(results, caps)):
        problems.append("a stream of the timed run is incomplete")
    if not all(0 <= t < config.vocab_size for s in results for t in s):
        problems.append("a token outside the vocabulary")
    for r, c, out in zip(again, caps, outcomes):
        if isinstance(out, BaseException) or len(out) != c:
            problems.append(f"{r.rid} did not complete across the reconnect: {out!r}"[:300])
            continue
        pieces = {}
        for (rid, sid_g), records in wire.items():
            if rid != r.rid:
                continue
            idx = 0
            for got_idx, tokens in records:
                if got_idx != idx:
                    problems.append(f"{rid} on {sid_g}: chunk at idx {got_idx}, expected {idx}")
                idx += len(tokens)
            pieces[sid_g] = [t for _, tokens in records for t in tokens]
        # exactly once: what the caller got is all the first generation sent
        # before it died, then the replay's wire from there on
        first, *rest = [pieces[g] for g in sorted(pieces)]
        spliced = first + (rest[-1][len(first):] if rest else [])
        if out != spliced:
            problems.append(f"{r.rid}: delivered stream is not the splice of its generations")
    if handle.reconnects != 1:
        problems.append(f"{handle.reconnects} reconnects, expected 1")
    # replayed tokens that differ below a stream's high-water mark (not a
    # failure: the splice keeps what was delivered; ROADMAP Queue 3 item 2)
    replay_mismatches = handle.replay_mismatches
    launches = {run: {k: v for k, v in st.items() if k.startswith("launches.")}
                for run, st in (("timed_run", timed_stats), ("after_reconnect", stats))}
    if any(n for counts in launches.values() for n in counts.values()):
        problems.append(f"the session launched flash kernels: {launches}")

    # the streams against the in-process serve phase's engine rows, and
    # finite logits of the same weights (built here as the worker builds them)
    model = decode.inference_params(TransformerLM(
        config, device=device, generator=torch.Generator(device=device).manual_seed(0)))
    with torch.no_grad():
        logits = model(torch.as_tensor(np.stack(prompts), dtype=torch.long, device=device))
    if not bool(torch.isfinite(logits).all()):
        problems.append("non-finite logits")
    divergences = []
    for i, (p, want, got) in enumerate(zip(prompts, serve_streams, results)):
        if got != want:
            j = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), len(got))
            with torch.no_grad():
                margin = serve._top2_margin(model, np.concatenate([p, np.asarray(want[:j])]))
            divergences.append({"request": i, "step": j, "serve_top2_margin": margin})
    if problems:
        raise AssertionError("session: " + "; ".join(problems))
    tokens = sum(caps)
    return {
        "open_s": open_s, "payload_bytes": handle.payload_bytes,
        "first_request": {"ttft_s": warm.ttft_s, "latency_s": warm.latency_s,
                          "tokens": len(warm.tokens)},
        "requests": len(prompts), "caps": caps, "slots": handle.slots,
        "sync_steps": SESSION["sync_steps"], "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_s": {"p50": statistics.median(ttft), "p95": float(np.percentile(ttft, 95))},
        "ttft_sorted_s": sorted(ttft), "first_wave": timed_stats.get("first_wave"),
        "completion_s": {"p50": statistics.median(latency),
                         "p95": float(np.percentile(latency, 95))},
        "streams_equal_serve_phase": len(prompts) - len(divergences),
        "divergences": divergences,
        "worker_peak_mem_bytes": (timed_stats.get("device_mem") or {}).get("peak_bytes_in_use"),
        "flash_launches": launches,
        "reconnect": {"seconds": reconnect_s, "reconnects": handle.reconnects,
                      "tokens_before_kill": sum(before_kill.values()),
                      "generations": handle.generation,
                      "streams_equal_first_run": sum(o == s for o, s in zip(outcomes, results)),
                      "replay_mismatches": replay_mismatches,
                      "served": closed.get("served")},
    }


def session_phase(serve_streams: list) -> dict:
    """The ``serve`` cell through the resident session: ``open_session`` on
    ``GPUExecutor(use_agent="pool")``, the 125M LM built on the card in the
    pool server from seed 0, 16 requests through one handle, then the
    reconnect check.  Fails on an incomplete stream, a gap, a duplicate,
    non-finite logits or a flash launch; reports divergences from the serve
    phase's streams with their margins."""
    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.models.transformer import lm_125m_config

    executor = GPUExecutor(
        transport="local", cache_dir=str(WORK / "cache"), remote_cache=str(WORK / "remote"),
        python_path=sys.executable, use_agent="pool", task_env={"PYTHONPATH": str(ROOT)},
    )

    async def run():
        try:
            return await _serve_session(executor, serve_streams, lm_125m_config(max_seq=512),
                                        "cuda")
        finally:
            await executor.close()

    return asyncio.run(run())


#: kernel-name fragments of cuBLAS/CUTLASS matrix products
MATMUL_TAGS = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitK")


# --- slice 1b: the source paper's workloads as lattices (BASELINE configs 2-4) -

#: Config 2 (``bench.py:1134-1179``): n, products per chain, timed chains.
MATMUL_N, MATMUL_CHAIN, MATMUL_REPS = 4096, 16, 50
#: Config 3 (``bench.py:2413-2470``): electrons per fan-out, trials, busy seconds.
FANOUT, FANOUT_TRIALS, BUSY_S = 8, 3, 0.3
#: Config 4 (``bench.py:1181-1253``): timed epochs over the 64 batches.
MNIST_EPOCHS = 20
OVERHEAD_PROBES = 5
#: BASELINE.json's north star: under 2 s of dispatch overhead per electron.
OVERHEAD_BUDGET_S = 2.0


def matmul_chain_electron(n: int, chain_len: int, reps: int) -> dict:
    """BASELINE config 2: a chain of ``chain_len`` bf16 products of all-ones
    n x n matrices, each rescaled by 1/n so the chain stays exactly 1; the
    fetched corner doubles as the check."""
    import time

    import torch

    # cuBLAS may otherwise sum split-K partials in bf16, where a partial sum
    # of ones that is not a power of two rounds: the check would not be 1.
    # The flag is process-wide: restored on the way out, so that an RPC
    # electron leaves the resident worker as it found it.
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        x = torch.ones(n, n, dtype=torch.bfloat16, device="cuda")
        y = torch.ones_like(x)
        inv_n = 1.0 / n

        def chain():
            acc = x
            for _ in range(chain_len):
                acc = (acc @ y) * inv_n
            return acc

        out = chain()  # warm: cuBLAS handles and heuristics
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(reps):
            out = chain()
        torch.cuda.synchronize()
        seconds = (time.perf_counter() - start) / reps
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    return {"seconds": seconds, "check": out[0, 0].item(), "all_ones": bool(out.eq(1).all()),
            "device": torch.cuda.get_device_name(0)}


def trivial_electron(i: int) -> int:
    return i * i


def busy_electron(i: int, seconds: float) -> int:
    """Work of a known length: the fan-out's wall shows its concurrency."""
    import time

    time.sleep(seconds)
    return i


def mnist_step_electron(i: int) -> float:
    """One Adam step of the MNIST MLP on the card, from seed ``i``: its loss."""
    import torch

    from covalent_tpu_plugin_torch.models import (
        MLP, adam, make_classifier_train_step, synthetic_mnist)

    model = MLP(generator=torch.Generator("cuda").manual_seed(i))
    step = make_classifier_train_step(model, adam(model))
    return float(step(synthetic_mnist(256, seed=i))["loss"])


def _dispatch(ct, flow, *args) -> tuple:
    """One lattice through ``ct.dispatch_sync``: (result, wall seconds)."""
    start = time.perf_counter()
    result = ct.dispatch_sync(flow)(*args)
    wall = time.perf_counter() - start
    if result.status is not ct.Status.COMPLETED:
        raise AssertionError(f"lattice {flow.__name__}: {result.status.value}: {result.error}")
    return result.result, wall


def _percentile(values: list, q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, round(q * (len(ordered) - 1)))]


#: The lattice phase's arms: one GPUExecutor each.  ``launch`` is a fresh
#: interpreter per electron (nohup + poll); ``pool_run`` forks each electron
#: from the pool server's zygote (the pool's run verb); ``rpc`` executes
#: each electron by digest inside the pool server.
LATTICE_ARMS = {
    "launch": dict(use_agent=False),
    "pool_run": dict(use_agent=True, dispatch_mode="launch"),
    "rpc": dict(use_agent=True, dispatch_mode="rpc"),
}
#: Warm arms' values against the launch arm's.  One MNIST step's loss is
#: computed before any update from the same weights and batch: f32 products
#: that may differ only by the summation order of another GEMM algorithm
#: (rtol 1e-5).  Config 4's loss_first/loss_last come after up to 64 Adam
#: steps whose CNN backward may sum in cuDNN's atomic order, so rounding
#: can drift further along the curve (rtol 1e-3).
LOSS_RTOL = 1e-5
CONFIG4_RTOL = 1e-3
#: Events that say an electron did not take its arm's road.
WRONG_ROAD_EVENTS = ("task.rpc_fallback", "task.agent_fallback", "agent.unavailable")


def cuda_state_electron() -> dict:
    """Where it ran and whether that process holds a CUDA context."""
    import os

    import torch

    return {"pid": os.getpid(), "cuda_initialized": torch.cuda.is_initialized()}


def zygote_cuda_electron(i: int) -> dict:
    """A CUDA electron: the MNIST step on the card, with its process's pid."""
    import os

    return {"pid": os.getpid(), "loss": mnist_step_electron(i)}


def _close(executor) -> None:
    """Shut an arm's pool server down on the dispatcher's loop."""
    from covalent_tpu_plugin_torch.workflow import runner

    asyncio.run_coroutine_threadsafe(executor.close(), runner._dispatcher_loop()).result(120)


def lattice_arm(arm: str, reference: dict | None) -> tuple[list[dict], dict, dict]:
    """BASELINE configs 2-4 as lattices on one GPUExecutor of the arm: its
    lines, the MNIST workers' flash launches, and the values a later arm
    must equal."""
    import math

    import covalent_tpu_plugin_torch.workflow as ct
    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.models.train import train_mnist
    from covalent_tpu_plugin_torch.obs import events as obs_events

    work = WORK / "lattice" / arm
    executor = GPUExecutor(
        transport="local", cache_dir=str(work / "cache"), remote_cache=str(work / "remote"),
        remote_workdir=str(work / "work"), python_path=sys.executable,
        task_env={"PYTHONPATH": str(ROOT)}, task_timeout=600, **LATTICE_ARMS[arm])
    wrong_road: list = []
    listener = lambda event: wrong_road.append(event) if event.get("type") in WRONG_ROAD_EVENTS \
        else None  # noqa: E731
    obs_events.add_listener(listener)
    expected_mode = "rpc" if arm == "rpc" else "launch"
    lines, values = [], {}

    def on_arm(fn, **kwargs):
        return ct.electron(fn, executor=executor, **kwargs)

    def dispatch(flow, *args):
        out, wall = _dispatch(ct, flow, *args)
        if executor.last_dispatch_mode != expected_mode:
            raise AssertionError(f"lattice {arm}: an electron took "
                                 f"{executor.last_dispatch_mode!r}, not {expected_mode!r}")
        return out, wall

    try:
        # The first electron on a fresh executor: the pool server's start
        # (and the zygote's, overlapping it) is its connect stage.
        probe = on_arm(trivial_electron)
        probe_flow = ct.lattice(lambda i: probe(i))
        _, first_wall = dispatch(probe_flow, 0)
        first = dict(executor.last_timings)
        start = {"pool_start_s": first.get("connect"), "first_electron_wall_s": first_wall,
                 "first_wall_overhead_s": first["wall_overhead"], "first_breakdown": first}

        matmul = on_arm(matmul_chain_electron)
        out, wall = dispatch(ct.lattice(lambda: matmul(MATMUL_N, MATMUL_CHAIN, MATMUL_REPS)))
        if out["check"] != 1.0 or not out["all_ones"]:
            raise AssertionError(f"config 2 {arm}: check {out['check']}, all ones {out['all_ones']}")
        tflops = 2 * MATMUL_N**3 * MATMUL_CHAIN / out["seconds"] / 1e12
        lines.append({"config": 2, "n": MATMUL_N, "chain_len": MATMUL_CHAIN, "reps": MATMUL_REPS,
                      "chain_s": out["seconds"], "tflops": tflops,
                      "mfu": tflops * 1e12 / PEAK_FLOPS["bfloat16"], "check": out["check"],
                      "electron_wall_s": wall, "device": out["device"]})

        # The dispatch overhead of a warm trivial electron (last_timings).
        overheads, wall_overheads, walls, breakdown = [], [], [], {}
        for i in range(OVERHEAD_PROBES):
            out, wall = dispatch(probe_flow, i)
            if out != i * i:
                raise AssertionError(f"overhead probe {i}: {out}")
            breakdown = dict(executor.last_timings)
            overheads.append(breakdown["overhead"])
            wall_overheads.append(breakdown["wall_overhead"])
            walls.append(wall)
        overhead = {"dispatch_overhead_s": statistics.median(overheads),
                    "per_probe": overheads,
                    "wall_overhead_p50_s": _percentile(wall_overheads, 0.5),
                    "wall_overhead_p95_s": _percentile(wall_overheads, 0.95),
                    "electron_wall_s": statistics.median(walls), "breakdown": breakdown,
                    "budget_s": OVERHEAD_BUDGET_S,
                    "within_budget": _percentile(wall_overheads, 0.95) <= OVERHEAD_BUDGET_S}

        # Config 3: fan-outs of 8 independent electrons against 8 times one.
        kinds = {"trivial": (trivial_electron, (), lambda i, v: v == i * i),
                 "busy": (busy_electron, (BUSY_S,), lambda i, v: v == i),
                 "mnist_step": (mnist_step_electron, (), lambda i, v: math.isfinite(v) and v > 0)}
        for kind, (fn, extra, ok) in kinds.items():
            electron = on_arm(fn)
            single = ct.lattice(lambda: electron(0, *extra))
            fan = ct.lattice(lambda n: [electron(i, *extra) for i in range(n)])
            _, single_wall = dispatch(single)
            walls, values_seen = [], []
            for _ in range(FANOUT_TRIALS):
                values_seen, wall = dispatch(fan, FANOUT)
                if len(values_seen) != FANOUT or not all(
                        ok(i, v) for i, v in enumerate(values_seen)):
                    raise AssertionError(f"config 3 {arm} {kind}: {values_seen}")
                walls.append(wall)
            values[f"config3.{kind}"] = values_seen
            fanout_wall = statistics.median(walls)
            lines.append({"config": 3, "kind": kind, "electrons": FANOUT,
                          "completed": len(values_seen), "trial_walls_s": walls,
                          "fanout8_wall_s": fanout_wall, "fanout8_per_electron_s": fanout_wall / FANOUT,
                          "single_wall_s": single_wall,
                          "speedup_vs_serial": FANOUT * single_wall / fanout_wall,
                          **({"losses": values_seen} if kind == "mnist_step" else {})})

        # Config 4: the MNIST arms.
        trainer = on_arm(train_mnist)
        mnist = []
        for model in ("mlp", "cnn"):
            out, wall = dispatch(ct.lattice(lambda m: trainer(m, epochs=MNIST_EPOCHS)), model)
            losses = [out["loss_first"], out["loss_last"], out["loss_final_epoch"]]
            if not all(math.isfinite(x) for x in losses) or not out["loss_last"] < out["loss_first"]:
                raise AssertionError(f"config 4 {arm} {model}: losses {losses}")
            mnist.append(out)
            values[f"config4.{model}"] = [out["loss_first"], out["loss_last"]]
            lines.append({"config": 4, "model": model, "batch_size": out["batch_size"],
                          "n_batches": out["n_batches"], "epochs": out["epochs"],
                          "steps_per_s": out["steps_per_s"], "loss_first": out["loss_first"],
                          "loss_last": out["loss_last"],
                          "loss_final_epoch": out["loss_final_epoch"],
                          "n_params": out["n_params"], "peak_mem_bytes": out["peak_mem_bytes"],
                          "electron_wall_s": wall,
                          "dispatch_overhead_s": executor.last_timings["overhead"],
                          "wall_overhead_s": executor.last_timings["wall_overhead"],
                          "execute_s": executor.last_timings["execute"],
                          "breakdown": dict(executor.last_timings), "device": out["device"]})
        lines.append({"overhead": overhead, **start})

        if arm == "rpc":
            # The zygote: the pool server now holds a CUDA context (the RPC
            # electrons above ran on the card in it); a CUDA electron sent
            # through the pool's run verb must still run on the card.
            state = on_arm(cuda_state_electron)
            server, _ = dispatch(ct.lattice(lambda: state()))
            forked_step = on_arm(zygote_cuda_electron, metadata={"dispatch_mode": "launch"})
            expected_mode = "launch"
            forked, wall = dispatch(ct.lattice(lambda: forked_step(0)))
            if not server["cuda_initialized"] or forked["pid"] == server["pid"]:
                raise AssertionError(f"zygote check: server {server}, forked {forked}")
            want = values["config3.mnist_step"][0]
            if not math.isclose(forked["loss"], want, rel_tol=LOSS_RTOL):
                raise AssertionError(f"zygote check: loss {forked['loss']} != {want}")
            lines.append({"zygote_check": {"server_pid": server["pid"],
                                           "server_cuda_initialized": server["cuda_initialized"],
                                           "forked_pid": forked["pid"], "loss": forked["loss"],
                                           "electron_wall_s": wall},
                          "dispatch_mode": executor.last_dispatch_mode})
    finally:
        obs_events.remove_listener(listener)
        _close(executor)
    if wrong_road:
        raise AssertionError(f"lattice {arm}: {[e.get('type') for e in wrong_road]}: "
                             f"{wrong_road[0]}")
    if reference is not None:
        # Every value of a warm arm equals the launch arm's.
        diffs = {}
        for key, want in reference.items():
            got = values[key]
            if key in ("config3.trivial", "config3.busy"):
                close = got == want
            else:
                rtol = CONFIG4_RTOL if key.startswith("config4") else LOSS_RTOL
                diffs[key] = max(abs(a - b) / abs(b) for a, b in zip(got, want))
                close = len(got) == len(want) and diffs[key] <= rtol
            if not close:
                raise AssertionError(f"lattice {arm}: {key} {got} != launch arm's {want}")
        lines.append({"equal_to_launch_arm": sorted(reference), "max_rel_diff": diffs,
                      "rtol": {"config3.mnist_step": LOSS_RTOL, "config4": CONFIG4_RTOL}})
    for line in lines:
        line.setdefault("dispatch_mode", "rpc" if arm == "rpc" else "launch")
        line["arm"] = arm
    worker_launches = {name: sum(arm_out["launches"][name] for arm_out in mnist)
                       for name in mnist[0]["launches"]}
    return lines, worker_launches, values


def lattice_phase() -> tuple[list[dict], dict]:
    """BASELINE configs 2-4 as lattices, on each arm's GPUExecutor: the
    launch arm first, then the warm arms, whose values must equal its."""
    lines, launches, reference = [], {}, None
    for arm in LATTICE_ARMS:
        start = time.perf_counter()
        arm_lines, arm_launches, values = lattice_arm(arm, reference)
        reference = reference or values
        arm_lines.append({"arm": arm, "seconds": time.perf_counter() - start})
        lines.extend(arm_lines)
        for name, n in arm_launches.items():
            launches[name] = launches.get(name, 0) + n
    return lines, launches


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
    # the config file GPUExecutor reads its unset arguments from, inside the checkout
    os.environ["COVALENT_TPU_CONFIG"] = str(WORK / "config.toml")
    sys.path.insert(0, str(ROOT))
    from covalent_tpu_plugin_torch.ops import _kernels

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    emit({"phase": "startup", "card": smi, **startup_phase()})

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
        emit({"phase": "train", "dispatch_mode": arm["dispatch_mode"],
              "vocab_chunk": arm["vocab_chunk"], "losses": arm["losses"],
              "losses_bit_equal_first_arm": arm["losses"] == arms[0]["losses"],
              "max_loss_gap_first_arm": max(abs(a - b) for a, b in
                                            zip(arm["losses"], arms[0]["losses"])),
              "timings": arm["timings"],
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
    serve_streams = served.pop("_streams")
    emit({"phase": "serve", "card": smi, **served})
    emit({"phase": "serve_profile", "card": smi, **serve_profile()})
    # The resident session: the serve cell's traffic through open_session.
    emit({"phase": "session", "card": smi, **session_phase(serve_streams)})

    # BASELINE configs 2-4 as lattices: no flash kernel, here or in the
    # MNIST workers (which report their counts).
    _kernels.reset_launch_counts()
    start = time.perf_counter()
    lattice_lines, worker_launches = lattice_phase()
    lattice_s = time.perf_counter() - start
    flash = {name: n + worker_launches[name] for name, n in _kernels.launch_counts().items()}
    if any(flash.values()):
        raise AssertionError(f"lattice: flash kernels launched {flash}")
    for line in lattice_lines:
        emit({"phase": "lattice", "card": smi, **line})
    emit({"phase": "lattice", "card": smi, "seconds": lattice_s, "flash_launches": flash})

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
