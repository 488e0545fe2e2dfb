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
3. ``build``: the CUDA kernels compiled from ``covalent_tpu_plugin_torch/csrc``
   (the three flash kernels and the four batch-invariant serving kernels).
4. ``parity``: each kernel against its plain PyTorch version on the card, at the
   training shape and at small GQA, window+sinks, explicit-position,
   non-causal, ragged, head dim 128, bf16, f16 and f32 cases, each with the
   tolerance it was held to.  Then the f32-output variants (ring
   attention's per-hop partials): bf16 inputs at one hop of the ``gang``
   phase's 2-ring, (8, 12, 512, 64) causal at the zigzag positions of rank
   0's queries and rank 1's keys and the other way round, and at head dim
   128, each sweep against its plain f32 version at the bf16 tolerance and,
   rounded to bf16, bit-equal to the bf16-output kernel.
5. ``timing``: at the training shape, and again at head dim 128, each
   kernel's device time (profiler; warm, and with the L2 cache flushed
   before every call) beside its plain version's, one PyTorch library
   call's (a yardstick only; the port never calls it) and the least time
   the card could take (``bound_ms``); and the dQ plus dK/dV kernels
   together (``backward_pair``) beside the library's backward for dq, dk
   and dv.  Then the f32-output variants at the ring's hop (rank 0's
   queries, rank 1's keys): each beside the bf16-output kernel on the same
   inputs, its plain version, its bound and ``scaled_dot_product_attention``
   with the hop's boolean mask (bf16 out, no lse: a yardstick only).
6. ``model_check``: a small LM on the card, flash kernels against the dense
   reference, logits and gradients; and a small LM with Switch MoE blocks
   (tokens dropped) on the card against the same weights on the CPU: the
   aux-aware loss, the aux and every gradient.
7. ``train``: the main path.  ``GPUExecutor(transport="local")`` dispatches the
   training electron (``models.train.train_lm``): the 125M LM at full width,
   5 AdamW steps at batch 8, seq 1024, with the standard loss and with the
   fused vocab-chunked loss, each in a fresh interpreter (launch mode), then
   inside one fresh pool server by RPC (its channel on binary frames) the
   standard loss again, ``remat_dots`` (the reference's ``lm_step`` remat
   arm: each block under activation checkpointing that saves only the 2-D
   products' outputs) and ``moe8`` (every MLP a Switch MoE of 8 experts,
   capacity 1.25, the loss with the load-balance aux at 0.01).  Losses must
   be finite and falling, the RPC and remat arms' within 1e-2 of the first
   arm's (each line says whether the bits are equal; the remat line its
   peak memory and step beside the RPC standard arm's), and every kernel
   launched 12 times a step in every arm, but the flash forward 24 times
   under remat (each block's forward runs again in the backward).  Each
   line gives the launches by query shape and type.
8. ``profile``: one training step under ``torch.profiler``: device time by
   kernel and the device's busy share; the step must run each of the three
   tensor-core kernels once per layer and no scalar kernel.
9. ``serve_check``: a small float32 LM on the card against the same model on
   the CPU: KV-cache prefill and decode logits (plain, int8 KV, rolling with
   sinks), and continuous-batching engine streams, token-equal wherever the
   CPU's top-2 logit margin exceeds 1e-4.
10. ``batch_invariance``: the 125M LM (bf16 weights from seed 0), 8 prompts
    of 128 tokens, the prefill and one decode step: each serving op alone
    (every dense product, the f32 lm_head, the decode attention's two
    products, the softmax, rotary, and all 25 norms held in f32: layer 0's
    alone, the other 24 with the residual add before them, their sum too)
    on the inputs every layer saw in the batch of 8, each row against that
    row computed alone, and the first layer's input cut to 2-7 rows; then
    the model's logits of row 5 against its prompt alone.  Once on the library route
    (``F.linear``, ``einsum``, torch's RMSNorm: the diagnosis) and once on
    the batch-invariant kernels (``csrc/bi_gemm_tc.cu``,
    ``csrc/bi_gemm_mix.cu``, ``csrc/bi_rmsnorm.cu``: the serving route),
    where every op must be bit-equal and every kernel within its tolerance
    of its plain version, every fused sum equal to torch's add and every
    fused norm to the norm alone on that sum.
11. ``serving_kernels``: every product kind the serving model runs (q/k/v/o,
    the MLP's wi and wo, the lm_head on bf16 features, the decode
    attention's scores and mix), the f32-operand route and the norm, alone
    and with the residual add, at M 1, 8, 128 and 1024: device time beside
    the plain version, one PyTorch call (a yardstick only; the lm_head has
    two, bf16 and f32; the fused norm's is ``x + delta`` then
    ``F.rms_norm``), the bound, the error against the plain version and the
    route and tiles taken.
12. ``serve``: the serving path.  ``GPUExecutor(transport="local")`` dispatches
    the serving electron (``models.serve.serve_lm``): the 125M LM with bf16
    weights, ``generate`` at batch 8 (prompt 128, 128 new tokens) and 16
    requests through the continuous-batching engine (8 slots, sync 32).
    Every request must complete at its length, every logit be finite, the
    engine's streams equal ``continuous_generate``'s and, every one, batch-1
    ``generate``'s rows, the int8 KV cache's prefill logits keep cosine >=
    0.999 to the float cache's, no flash kernel run (the decode attention is
    plain products), the tensor-core products, the mix and the norm run,
    and the f32 CUDA-core product never.
13. ``serve_profile``: one batch-8 decode step of the 125M LM under
    ``torch.profiler``: device time by kind (the attention's products and
    its other kernels apart, by the ``decode_attention`` ranges), the
    device's busy share against the profiled and the unprofiled step, the
    batch-invariant kernels' launches and device time in the step by kernel
    (the f32 CUDA-core product must launch none; the norm once alone and
    once a layer for each residual add), the step's launches, the serving
    wrappers' host cost, and the f32 ``lm_head``'s weight cast and library
    product alone.
14. ``session``: the serving cell through the resident session.
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
    on each generation and its delivered tokens the exact splice of them,
    and no replayed token may differ from the one delivered.
    The channel must run on binary frames; the wire bytes per streamed
    token are counted, then again for the same 16 requests on a session
    whose executor keeps JSON lines (``agent_frames=False``), with the
    streams equal between the two encodings.
15. ``replicas``: the serve cell through ``serving.open_replica_set`` over
    two pool ``GPUExecutor`` objects on the card (two resident workers, each
    with its own 8-slot engine): the two pool servers' start at once, the
    set's open, two warm-up requests, then the 16 requests at once:
    tokens/s, TTFT and completion p50/p95, requests placed per replica,
    each worker's peak memory and flash launches (0), streams equal to the
    ``serve`` phase's with the top-2 margins of those that differ.  Then
    the 16 again with one replica's pool server killed mid-stream and its
    re-open refused (``retries=0``): every stream must complete on the
    survivor (drain-on-death), the re-routed requests are counted, and no
    replayed token may differ on any road (reconnect, reroute, hedge).
16. ``disagg``: the same 16 requests through
    ``serving.open_disaggregated_set`` on the same two executors, one
    prefill and one decode replica (the killed worker's pool server starts
    again first, alone): every request must take the KV road (16 transfers,
    0 degrades) on frames; bytes per bundle, transfer seconds p50/p95,
    TTFT, tokens/s, streams equal to the ``replicas`` phase's with margins.
17. ``recovery``: the serve cell through a dispatcher crash.  A journaling
    ``GPUExecutor`` (``COVALENT_TPU_JOURNAL_DIR``; its pool server with an
    orphan TTL) opens the session and sends the 16 requests; once a stream
    is mid-way the executor is torn down cold (no close, pipes dropped).
    A second executor on the same journal runs ``recover()``: it adopts the
    orphaned pool server through ``pool_orphan.json`` and the ``--attach``
    relay at the next epoch, re-binds the session and resumes every
    journaled stream from its high-water mark.  Then, on the recovered
    session, the 16 again with no move (the baseline), again with a planned
    ``handoff()`` mid-stream, and again with SIGTERM sent to the pool server
    mid-stream (its preemption notice starts a handoff).  Recover seconds,
    streams adopted and resumed, tokens re-emitted, each move's seconds and
    the completion it adds; every stream complete exactly once and equal to
    the ``serve`` phase's, no replayed token different on the handoff and
    preemption roads.
18. ``lattice``: the source paper's own workloads (BASELINE configs 2-4), each
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
    Adam step on the card each), 3 trials each (the launch arm's MNIST-step
    fan-out 2: its line says ``cut``); config 4, the MNIST MLP and
    CNN (``models.train.train_mnist``: 64 batches of 256, loss first and
    last, steps/s).  Every electron must take its arm's road, and the warm
    arms' values must equal the launch arm's.  Then, with the pool server
    holding a CUDA context from the RPC electrons, one CUDA electron
    through the pool's ``run`` verb (a zygote fork) on the same pool.  No
    flash kernel runs.  Each warm arm's channel must run on frames; each
    arm says how its invokes left (one to a frame, or several in a
    ``multi_invoke`` frame).
19. ``gang``: BASELINE configs 5 and 4 as two-process gang electrons on
    the one card (slice 4).  First the collective probe
    (``parallel.probe``): every collective the parallel layer issues, on
    tensors on the card, two ranks over gloo (NCCL refuses two ranks on one
    device), each ok or its error.  Then the flash kernels against their
    plain versions at each rank's shape: (4, 12, 1024, 64) under FSDP (the
    batch cut), (8, 6, 1024, 64) under tensor parallelism (the heads cut).
    Then eight electrons through ``GPUExecutor(workers=["w0", "w1"])``:
    ``lm_fsdp2`` (the 125M LM at full width, ``MeshPlan(fsdp=2)``, global
    batch 8, seq 1024, 5 steps, standard loss), ``lm_tensor2`` (the same,
    ``MeshPlan(tensor=2)``), ``cnn_data2`` (the MNIST CNN,
    ``MeshPlan(data=2)``, ``train_mnist``'s 64 batches of 256, one timed
    epoch), ``lm_ring2`` (the LM under ``MeshPlan(seq=2)`` with
    ``attention="ring"``: each rank holds the zigzag stripes of its half of
    every sequence, and every layer's attention is the ring-flash pair of
    passes on the f32-output kernels, 2 hops of (8, 12, 512, 64) a layer)
    and ``lm_ulysses2`` (``MeshPlan(seq=2)``, ``attention="ulysses"``: two
    all-to-alls around the bf16 kernels on (8, 6, 1024, 64)), ``lm_pipe2``
    (``MeshPlan(pipe=2)``: GPipe over two stages of 6 layers, 4 microbatches
    of 2 rows, each hop a ring permute; flash on (2, 12, 1024, 64)),
    ``lm_tensor2_fused`` (``MeshPlan(tensor=2)`` with the fused loss, each
    rank streaming its half of the vocabulary in chunks of 8192, and
    ``accumulate_steps=2``: 2 microbatches of 4 rows) and ``lm_moe_tensor2``
    (``MeshPlan(tensor=2)`` with 8 experts, 4 a rank).  Per electron: the
    mesh, backend and each rank's device, the losses and their largest gap
    to the ``train`` phase's arm of the same loss (the standard arm, the
    fused arm, ``moe8``; same seed and global batch; bound 1e-2), each
    rank's steady step, tokens/s, peak memory, flash launches (12 a step on
    every rank, 24 on the ring, the pipeline and the accumulated arm) and
    the query shapes and output types its kernels took, the electron's wall
    and the rendezvous; ``lm_pipe2``'s line has ``lm_fsdp2``'s step beside
    its own.  The LM arms take 3 of the 5 steps (their lines say ``cut``).
    The two ranks share one card, so the times measure the gang's
    overhead, not scaling.
20. ``ssh``: the paper's road over a real, encrypted SSH channel on
    loopback.  A minissh server (``transport/minissh.py``, in its own
    interpreter) on ``127.0.0.1:0`` with an ed25519 host key and one
    authorized client key, both generated under ``build/chip_smoke/ssh``;
    every executor pins that host key (``transport="minissh"``,
    ``strict_host_keys=True``).  Only the server's environment carries a
    marker, and every electron returns it.  Arms: BASELINE config 1 (a
    lattice of one electron returning ``socket.gethostname()``, which
    must be the dispatcher's) on the launch road (``use_agent=False``):
    the electron's wall, ``last_timings``, overhead against 2 s, the key
    exchange and authentication (the ``pool.connect`` span), the
    pre-flight, the wire bytes by codec, then 5 warm electrons; the warm
    pool over SSH: its start, 5 warm electrons on each of the ``pool_run``
    and ``rpc`` roads beside the ``lattice`` phase's local values, then
    the ``train`` cell's electron by RPC (losses within 1e-2 of the
    ``train`` phase's standard arm, 12 launches a step of each flash
    kernel); a gang whose two workers are two SSH addresses of the one
    server (``lm_fsdp2`` as in the ``gang`` phase, its rendezvous on worker
    0's host).  Any missing marker, ``task.dispatch_failed`` or electron on
    another road fails the run.  Without an SSH backend on the machine
    the phase prints one line naming what is missing and runs no arm.
21. ``agent``: the native C++ agent, resident profiling, the per-session
    serving families and fleet ``Pool`` targets, one line per step.
    ``build``: ``GPUExecutor(use_agent="native")`` compiles the port's
    ``native/agent.cc`` on first use (seconds).  ``rpc_child``: the
    ``train`` cell's electron by RPC, each invoke a fresh ``harness.py
    --rpc-child`` the agent forks: losses within 1e-2 of the ``train``
    phase's standard arm (the line says whether the bits are equal), 12
    launches a step of each flash kernel, the runner's start (the
    ``submit`` span: the agent's fork and exec of the runner until its
    ``started``; the agent's build is in ``connect``, printed apart) and
    the electron's wall.  ``capture_pool_rpc``: ``capture_profile(2 s)`` on a
    pool server while an RPC training electron runs in it: the artifact's
    digest checked, its trace's device events by flash kernel (each must be
    there).  ``serve_child``: the ``session`` phase's 16 requests on a
    session opened on a ``Pool`` over the native executor (the model in a
    ``--serve-child``): open seconds, tokens/s and TTFT beside the
    ``session`` phase's, the per-session families read back (requests,
    tokens, TTFT count and p50 bucket, queue depth, tokens/s, prefix
    counters), and 0 tokens different from the ``session`` phase's
    streams.  ``capture_serve_child``: ``capture_profile(2 s)`` on that
    session while it decodes (bursts of the 16 requests, one after the
    other, until the capture is back): the trace must hold the tensor-core
    products, the mix and the norm.  ``pool_handoff``: the 16 twice over
    (32 requests), handed off to a second ``Pool`` (a pool-mode executor)
    as soon as the first tokens arrive: the requests the supervisor
    replayed onto the new runtime (at least the 8 slots) and those of them
    already streaming, every stream complete exactly once and equal to the
    ``session`` phase's, the slot moved with the session, the handoff's
    seconds and the completion after it.
22. ``kernels``: every kernel with its launches on its path (the flash
    kernels: training, with the gang's launches beside as
    ``gang_launches``, the ``lm_ring2`` arm's f32-output launches as
    ``ring_launches`` with the variant's times under ``f32_variant``, the
    ``lm_ulysses2`` arm's as ``ulysses_launches``, the ``ssh`` phase's
    as ``ssh_launches`` and the ``agent`` phase's as ``agent_launches``; the
    batch-invariant ones: the ``serve`` phase, and
    the f32 CUDA-core product ``serve_check``'s f32 LM, with its 0 launches
    on the ``serve`` phase beside),
    error, times and bound, and the route (tensor-core or scalar kernel)
    each input type and head dim of a flash kernel takes.

then the card's ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
Every phase line carries ``elapsed_s``, the seconds since the script started.
Any failed phase ends the run with a non-zero exit and no last line.  Without
a card (``torch.cuda.is_available()`` false) it exits non-zero at once.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
_START = time.perf_counter()

#: H100 SXM data-sheet peaks (dense): tensor-core rate by input type, and HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

#: Training shape of the main path: batch, heads, kv heads, seq q, seq k, head dim.
PATH_SHAPE = (8, 12, 12, 1024, 1024, 64)
STEPS, BATCH, SEQ = 5, 8, 1024
#: Loss tolerance between training arms of the same weights and batches.
TRAIN_LOSS_TOL = 1e-2


def emit(obj: dict) -> None:
    if "phase" in obj:  # when each phase line left, from the script's start
        obj = {**obj, "elapsed_s": time.perf_counter() - _START}
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


#: One hop of the gang phase's 2-ring (lm_ring2): bf16, (B, H, S/2, D).
HOP_SHAPE = (8, 12, 12, 512, 512, 64)
#: The f32-output variants: queries at one rank's zigzag stripes, keys at the
#: other's (positions ("zigzag", q rank, k rank) of a 2-ring).
VARIANT_CASES = [
    dict(name="hop_q0_k1", shape=HOP_SHAPE, dtype="bfloat16", causal=True,
         positions=("zigzag", 0, 1)),
    dict(name="hop_q1_k0", shape=HOP_SHAPE, dtype="bfloat16", causal=True,
         positions=("zigzag", 1, 0)),
    dict(name="hop_d128", shape=(8, 12, 12, 512, 512, 128), dtype="bfloat16", causal=True,
         positions=("zigzag", 1, 0)),
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
    if isinstance(case.get("positions"), tuple):
        from covalent_tpu_plugin_torch.ops.ring_attention import sequence_positions

        _, q_rank, k_rank = case["positions"]
        qpos, kpos = (torch.as_tensor(sequence_positions(2 * length, 2, rank, True),
                                      device="cuda")
                      for length, rank in ((sq, q_rank), (sk, k_rank)))
    elif case.get("positions") == "split":
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


def variant_parity_case(case: dict, seed: int) -> dict:
    """The three sweeps with f32 outputs against their plain f32 versions
    (the bf16 tolerance: the same casts, another order of summation), and
    each rounded to bf16 against the same sweep's bf16 output, bit for bit:
    the variant stores the same accumulator without the last rounding."""
    import torch

    from covalent_tpu_plugin_torch.ops import _kernels
    from covalent_tpu_plugin_torch.ops import attention as attn

    q, k, v, dout, qpos, kpos, band = _case_inputs(case, seed)
    f32, low = torch.float32, getattr(torch, case["dtype"])
    out, lse = _kernels.flash_fwd(q, k, v, qpos, kpos, *band, out_dtype=f32)
    out_p, _ = attn.flash_fwd_plain(q, k, v, qpos, kpos, *band, f32)
    out16, lse16 = _kernels.flash_fwd(q, k, v, qpos, kpos, *band)
    delta = attn.flash_delta(out, dout)
    args = (q, k, v, dout, lse, delta, qpos, kpos, *band)
    dk, dv = _kernels.flash_bwd_dkdv(*args, grad_dtype=f32)
    dk_p, dv_p = attn.flash_bwd_dkdv_plain(*args, f32)
    dk16, dv16 = _kernels.flash_bwd_dkdv(*args)
    dq = _kernels.flash_bwd_dq(*args, grad_dtype=f32)
    dq_p = attn.flash_bwd_dq_plain(*args, f32)
    dq16 = _kernels.flash_bwd_dq(*args)
    report: dict = {}
    for name, got, want, rounded in (("flash_fwd.out", out, out_p, out16),
                                     ("flash_bwd_dkdv.dk", dk, dk_p, dk16),
                                     ("flash_bwd_dkdv.dv", dv, dv_p, dv16),
                                     ("flash_bwd_dq.dq", dq, dq_p, dq16)):
        if got.dtype != f32:
            raise AssertionError(f"{name}: the variant wrote {got.dtype}")
        _compare(name, got, want, case["dtype"], report)
        equal = bool(torch.equal(got.to(low), rounded))
        report[name]["rounds_to_bf16_kernel"] = equal
        if not equal:
            raise AssertionError(f"{name}: the f32 variant rounded to {low} differs from the "
                                 f"{low}-output kernel")
    if not torch.equal(lse, lse16):
        raise AssertionError("flash_fwd: the f32 variant's lse differs from the bf16 kernel's")
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


def variant_timing() -> dict:
    """Device time of the three f32-output variants at the ring's hop
    (rank 0's queries, rank 1's keys), each beside the bf16-output kernel on
    the same inputs, its plain version, its bound (its f32 outputs counted at
    4 bytes) and ``scaled_dot_product_attention`` with the hop's boolean
    mask (bf16 out and no lse; its backward a whole backward)."""
    import torch
    import torch.nn.functional as F

    from covalent_tpu_plugin_torch.ops import _kernels
    from covalent_tpu_plugin_torch.ops import attention as attn

    case = VARIANT_CASES[0]
    q, k, v, dout, qpos, kpos, band = _case_inputs(case, seed=2)
    f32 = torch.float32
    out, lse = _kernels.flash_fwd(q, k, v, qpos, kpos, *band, out_dtype=f32)
    delta = attn.flash_delta(out, dout)
    pairs = visible_pairs(q, k, qpos, kpos, band)
    d = q.shape[-1]
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    mask = attn._band_visible(qpos[:, None], kpos[None, :], None)
    fwd = (q, k, v, qpos, kpos, *band)
    bwd = (q, k, v, dout, lse, delta, qpos, kpos, *band)
    dq32 = torch.empty(q.shape, dtype=f32, device=q.device)
    dk32 = torch.empty(k.shape, dtype=f32, device=q.device)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
    calls = {
        "flash_fwd": (
            lambda: _kernels.flash_fwd(*fwd, out_dtype=f32), lambda: _kernels.flash_fwd(*fwd),
            lambda: attn.flash_fwd_plain(*fwd, f32),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
            4 * d * pairs, size(q, k, v, out, lse)),
        "flash_bwd_dkdv": (
            lambda: _kernels.flash_bwd_dkdv(*bwd, grad_dtype=f32),
            lambda: _kernels.flash_bwd_dkdv(*bwd),
            lambda: attn.flash_bwd_dkdv_plain(*bwd, f32),
            lambda: torch.autograd.grad(lib_out, (kl, vl), dout, retain_graph=True),
            8 * d * pairs, size(q, k, v, dout, lse, delta, dk32, dk32)),
        "flash_bwd_dq": (
            lambda: _kernels.flash_bwd_dq(*bwd, grad_dtype=f32), lambda: _kernels.flash_bwd_dq(*bwd),
            lambda: attn.flash_bwd_dq_plain(*bwd, f32),
            lambda: torch.autograd.grad(lib_out, (ql,), dout, retain_graph=True),
            6 * d * pairs, size(q, k, v, dout, lse, delta, dq32)),
    }
    results = {}
    for name, (variant, low, plain, library, flops, nbytes) in calls.items():
        results[name] = dict(
            kernel_ms=device_ms(variant, 20, match=name),
            bf16_out_ms=device_ms(low, 20, match=name),
            plain_ms=time_ms(plain, 3),
            library_ms=device_ms(library, 20),
            flops=flops, bytes=nbytes, visible_pairs=pairs,
        )
        results[name]["bound_ms"], results[name]["bound_by"] = bound(flops, nbytes,
                                                                     case["dtype"])
    results["library_note"] = ("scaled_dot_product_attention with the hop's boolean mask: "
                               "bf16 output and no lse; its backward rows each time a whole "
                               "backward (dq, dk and dv)")
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
            "tol": {"logits": 1e-4, "grads": 1e-5}, "moe": moe_check()}


def moe_check() -> dict:
    """A small f32 LM with Switch MoE blocks (4 experts, capacity 0.5: tokens
    dropped) on the card against the same weights on the CPU: the
    aux-aware loss, the aux and every gradient.  The routing's argmax, the
    slots' cumsum and the dispatch's scatter run on the card; f32 sums in
    another order over at most 128 tokens."""
    import torch

    from covalent_tpu_plugin_torch.models import TransformerConfig, TransformerLM
    from covalent_tpu_plugin_torch.models.moe import collect_moe_aux, lm_loss_with_moe_aux

    cfg = TransformerConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4, d_ff=256,
                            max_seq=64, dtype=torch.float32, attention="reference",
                            moe_experts=4, moe_capacity_factor=0.5)
    tokens = torch.randint(0, 512, (2, 65), generator=torch.Generator().manual_seed(3))
    cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = TransformerLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    runs = {}
    for name, model in (("card", card), ("cpu", cpu)):
        loss = lm_loss_with_moe_aux(model, {"tokens": tokens})
        loss.backward()
        runs[name] = (float(loss.detach()), float(collect_moe_aux(model).detach()),
                      {n: p.grad.cpu() for n, p in model.named_parameters()})
    loss_err = abs(runs["card"][0] - runs["cpu"][0])
    aux_err = abs(runs["card"][1] - runs["cpu"][1])
    grad_err = max((runs["card"][2][n] - g).abs().max().item() for n, g in runs["cpu"][2].items())
    if not (loss_err <= 1e-5 and aux_err <= 1e-5 and grad_err <= 1e-5):
        raise AssertionError(f"MoE on the card: loss err {loss_err}, aux err {aux_err}, "
                             f"grad err {grad_err}")
    return {"loss": runs["card"][0], "aux": runs["card"][1], "loss_abs_err": loss_err,
            "aux_abs_err": aux_err, "grads_max_abs_err": grad_err, "tol": 1e-5,
            # 128 tokens for 4 experts of 16 slots: at least 64 dropped
            "tokens": 128, "slots": 64}


# --- the main path: the training electron through the executor ---------------


#: The train phase's arms: (name, road, vocab_chunk, config overrides).  The
#: standard and the fused loss each in a fresh interpreter (launch mode), then
#: in one fresh pool server by RPC the standard loss, the reference's
#: ``lm_step`` remat arm (``remat_policy="dots"``) and the Switch MoE of 8
#: experts (capacity 1.25, the aux-aware loss).
TRAIN_ARMS = (
    ("standard", "launch", None, {}),
    ("fused", "launch", 8192, {}),
    ("standard_rpc", "rpc", None, {}),
    ("remat_dots", "rpc", None, dict(remat=True, remat_policy="dots")),
    ("moe8", "rpc", None, dict(moe_experts=8)),
)
#: Flash launches a step by kernel, 12 (one a layer) unless named here: a
#: rematerialised block runs its flash forward again in the backward.
TRAIN_LAUNCHES = {"remat_dots": {"flash_fwd": 24}}


def train_launches_per_step(arm: str, kernel: str) -> int:
    return TRAIN_LAUNCHES.get(arm, {}).get(kernel, 12)


def train_phase() -> list[dict]:
    """The training electron once an arm of :data:`TRAIN_ARMS`, each arm's
    result named by ``arm``."""
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
            for node, (name, road, vocab_chunk, overrides) in enumerate(TRAIN_ARMS):
                executor = launch if road == "launch" else rpc
                wall = time.perf_counter()
                out = await executor.run(
                    train_lm, [],
                    dict(steps=STEPS, batch_size=BATCH, seq_len=SEQ, vocab_chunk=vocab_chunk,
                         seed=0, **overrides),
                    {"dispatch_id": "chip_smoke", "node_id": node},
                )
                out["wall_s"] = time.perf_counter() - wall
                out["arm"], out["overrides"] = name, overrides
                out["vocab_chunk"] = vocab_chunk
                out["dispatch_mode"] = executor.last_dispatch_mode
                out["timings"] = dict(executor.last_timings)
                client = executor._agents.get("localhost")
                out["frames_active"] = None if client is None else client.frames_active
                arms.append(out)
        finally:
            await rpc.close()
        return arms

    arms = asyncio.run(run_arms())
    roads = [arm["dispatch_mode"] for arm in arms]
    if roads != [road for _, road, _, _ in TRAIN_ARMS]:
        raise AssertionError(f"train: roads {roads}")
    if any(arm["frames_active"] is not True for arm in arms if arm["dispatch_mode"] == "rpc"):
        raise AssertionError(f"train: an RPC arm's channel is not on frames "
                             f"({[arm['frames_active'] for arm in arms]})")
    return arms


#: The MoE loss's load-balance weight (``models.moe.lm_loss_with_moe_aux``).
MOE_AUX_WEIGHT = 0.01


def lm_losses(arm: dict) -> list:
    """An arm's language-model losses: its losses, less the weighted
    load-balance term for an MoE arm.  Over 5 steps at lr 3e-4 that term
    grows as the router sharpens (the reference's model does the same on
    the same weights: ``tools/moe_aux_cpu.py``), so an MoE arm's total may
    rise while its LM loss falls."""
    aux = arm.get("moe_aux") or [0.0] * len(arm["losses"])
    return [loss - MOE_AUX_WEIGHT * a for loss, a in zip(arm["losses"], aux)]


def check_train(arms: list[dict]) -> None:
    import math

    for arm in arms:
        losses = lm_losses(arm)
        if len(losses) != STEPS or not all(math.isfinite(x) for x in arm["losses"] + losses):
            raise AssertionError(f"{arm['arm']}: losses not finite: {arm['losses']}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{arm['arm']}: LM loss did not fall: {losses}")
        for name, count in arm["launches"].items():
            want = train_launches_per_step(arm["arm"], name) * STEPS
            if count != want:
                raise AssertionError(f"{arm['arm']}: {name} launched {count} times, "
                                     f"expected {want}")
    by_arm = {arm["arm"]: arm for arm in arms}
    # Same weights and batches: the two losses differ only by the fused
    # loss's bf16 cast of the lm_head weight (the reference's rule).
    first = [by_arm[name]["losses"][0] for name in ("standard", "fused")]
    if abs(first[0] - first[1]) > TRAIN_LOSS_TOL:
        raise AssertionError(f"standard and fused first losses differ: {first}")
    # The RPC arm is the first arm's electron in another process, and the
    # remat arm the same steps with each block recomputed: every step's loss
    # within the same tolerance (equal bits when the kernels and the GEMMs
    # are deterministic, reported by the train line).
    for name in ("standard_rpc", "remat_dots"):
        gaps = [abs(a - b) for a, b in zip(by_arm[name]["losses"],
                                           by_arm["standard"]["losses"])]
        if max(gaps) > TRAIN_LOSS_TOL:
            raise AssertionError(f"{name} arm's losses {by_arm[name]['losses']} differ from "
                                 f"{by_arm['standard']['losses']}")


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


# --- batch invariance: a row's bits at batch 1 and as row 5 of a batch of 8 --

#: The diagnosis's batch, the row the batch-1 prompt takes in it, prompt length.
BI_BATCH, BI_ROW, BI_PROMPT = 8, 5, 128
#: Tolerance of a batch-invariant kernel against its plain version at the
#: serving shapes, relative to the largest plain value (at least 1): f32 sums
#: of up to 3072 products in another order, then (bf16 outputs) one rounding
#: that may land on the neighbouring bf16 value, 2^-7 of the value.
BI_TOL = {"bfloat16": 2.0**-7, "float32": 1e-4}
#: The dense products of a layer, by the name the diagnosis gives them.
BI_DENSE = {"q_proj": ("attention", "q_proj"), "k_proj": ("attention", "k_proj"),
            "v_proj": ("attention", "v_proj"), "out_proj": ("attention", "out_proj"),
            "mlp_wi": ("mlp", "wi"), "mlp_wo": ("mlp", "wo")}


def _set_route(model, on: bool) -> None:
    for module in model.modules():
        if hasattr(module, "batch_invariant"):
            module.batch_invariant = on


def _rows_check(fn, calls: list) -> dict:
    """``fn`` on each captured batch input (one a layer), each row of its
    output against ``fn`` on that row alone (batch 1): the headline is row
    ``BI_ROW`` of the first call (None where it has fewer rows);
    ``rows_differing`` counts every (call, row) pair whose bits differ,
    with the largest difference over all."""
    import torch

    differing, largest, headline = 0, 0.0, None
    for i, inputs in enumerate(calls):
        whole = fn(*inputs)
        for row in range(whole.shape[0]):
            alone = fn(*(t[row:row + 1] for t in inputs))
            same = bool(torch.equal(whole[row:row + 1], alone))
            differing += not same
            largest = max(largest, (whole[row:row + 1].float() - alone.float()).abs().max().item())
            if i == 0 and row == BI_ROW:
                headline = same
    torch.cuda.synchronize()
    return {"bit_equal": headline, "rows_differing": differing,
            "rows": len(calls) * calls[0][0].shape[0], "max_abs_diff": largest}


def _capture(model, tokens, cache) -> dict:
    """The inputs every layer's ops (and the final norm and lm_head) see in
    one ``model(tokens, cache=cache)`` call, taken with hooks and wrappers:
    name -> one argument tuple per call."""
    import torch

    from covalent_tpu_plugin_torch.models import transformer
    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    seen: dict = {}

    def hook(name):
        def pre(_module, args):
            seen.setdefault(name, []).append((args[0].detach().clone(),))
        return pre

    modules = {"lm_head_f32": model.lm_head}
    for layer in model.layers:
        for name, (block, attr) in BI_DENSE.items():
            modules.setdefault(name, []).append(getattr(getattr(layer, block), attr))
    hooks = [m.register_forward_pre_hook(hook(name))
             for name, ms in modules.items() for m in (ms if isinstance(ms, list) else [ms])]
    wrapped = {}
    depth = [0]

    def record(owner, attr, name):
        """Record the calls of ``owner.attr`` the model makes; not those one
        recorded function makes of another (the plain fused norm's norm)."""
        fn = getattr(owner, attr)
        wrapped[(owner, attr)] = fn

        def wrapper(*args):
            if not depth[0]:
                seen.setdefault(name, []).append(tuple(
                    a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args))
            depth[0] += 1
            try:
                return fn(*args)
            finally:
                depth[0] -= 1
        setattr(owner, attr, wrapper)

    for suffix in ("", "_plain"):
        record(bi, "attention_scores" + suffix, "attention_scores")
        record(bi, "attention_mix" + suffix, "attention_mix")
        # the 25 norms of the 125M LM's step: layer 0's ln_attn alone, each
        # residual add with the norm after it (ln_mlp, the next ln_attn,
        # ln_final)
        record(bi, "rms_norm" + suffix, "rmsnorm")
        record(bi, "add_rms_norm" + suffix, "add_rmsnorm")
    record(transformer, "_apply_rotary", "rotary")
    try:
        with torch.no_grad():
            logits = model(tokens, cache=cache)
    finally:
        for h in hooks:
            h.remove()
        for (owner, attr), fn in wrapped.items():
            setattr(owner, attr, fn)
    return {"inputs": seen, "logits": logits, "modules": modules}


def _max_err(got, want) -> dict:
    """A kernel's output against its plain version's, and the tolerance:
    one rounding of the output type (f32: 1e-4, sums in another order) times
    the largest plain value, at least 1."""
    scale = max(1.0, want.float().abs().max().item())
    tol = BI_TOL[str(want.dtype).removeprefix("torch.")] * scale
    err = (got.float() - want.float()).abs().max().item()
    return {"max_abs_err": err, "tol": tol, "ok": err <= tol}


def _rows_summary(results: list, calls: int) -> dict:
    """``_rows_check`` results of every captured call, then (past
    ``calls``) of the first call's input cut to 2-7 rows."""
    return {"bit_equal": results[0]["bit_equal"],
            "rows_differing": sum(r["rows_differing"] for r in results),
            "rows_differing_in_2_to_7_row_batches": sum(
                r["rows_differing"] for r in results[calls:]),
            "rows": sum(r["rows"] for r in results),
            "max_abs_diff": max(r["max_abs_diff"] for r in results)}


def _op_checks(model, captured: dict, query_pos, plain: bool) -> tuple[dict, dict]:
    """Each op alone on the captured batch inputs of every layer: each row
    of the batch against the row computed alone, and the first layer's
    input cut to 2-7 rows (the engine's admission waves take any number of
    prompts).  ``plain``: the library route.  RMSNorm is held in f32, before
    its cast, so a sum taken in another order shows even where the bf16
    rounding would hide it; the fused norm's sum ``s`` too.  Also each
    kernel against its plain version on the same inputs, and on the
    batch-invariant route every fused norm's ``s`` against torch's add and
    its ``y`` against the norm alone on ``s``, bit for bit."""
    import torch

    from covalent_tpu_plugin_torch.models import transformer
    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    seen, modules = captured["inputs"], captured["modules"]
    cfg = model.config
    linear = bi.linear_plain if plain else bi.linear
    out, errs = {}, {}
    for name in list(BI_DENSE) + ["lm_head_f32"]:
        mods = modules[name] if isinstance(modules[name], list) else [modules[name]]
        pairs = list(zip(mods, seen[name]))
        results = [_rows_check(lambda x, m=m: linear(x, m.weight, m.dtype), [args])
                   for m, args in pairs]
        first_m, (first_x,) = pairs[0]
        results += [_rows_check(lambda x: linear(x, first_m.weight, first_m.dtype),
                                [(first_x[:n],)]) for n in range(2, BI_BATCH)]
        out[name] = _rows_summary(results, len(pairs))
        m, (x,) = pairs[0]
        errs[name] = _max_err(bi.linear(x, m.weight, m.dtype), bi.linear_plain(x, m.weight, m.dtype))
    norm = bi.rms_norm_plain if plain else bi.rms_norm
    add_norm = bi.add_rms_norm_plain if plain else bi.add_rms_norm
    alone, fused = seen["rmsnorm"], seen["add_rmsnorm"]
    if (len(alone), len(fused)) != (1, 2 * cfg.n_layers):
        raise AssertionError(f"batch_invariance: {len(alone)} norms alone and {len(fused)} "
                             f"fused in a step, expected 1 and {2 * cfg.n_layers}")
    results = [_rows_check(lambda x, sc=sc: norm(x, sc, torch.float32), [(x,)])
               for x, sc, _ in alone]
    x0, sc0, dt0 = alone[0]
    results += [_rows_check(lambda x: norm(x, sc0, torch.float32), [(x0[:n],)])
                for n in range(2, BI_BATCH)]
    out["rmsnorm_f32"] = _rows_summary(results, len(alone))
    errs["rmsnorm"] = _max_err(bi.rms_norm(x0, sc0, dt0), bi.rms_norm_plain(x0, sc0, dt0))
    for part, i in (("add_rmsnorm_sum", 0), ("add_rmsnorm_f32", 1)):
        results = [_rows_check(lambda x, d, sc=sc: add_norm(x, d, sc, torch.float32)[i],
                               [(x, d)]) for x, d, sc, _ in fused]
        x0, d0, sc0, dt0 = fused[0]
        results += [_rows_check(lambda x, d: add_norm(x, d, sc0, torch.float32)[i],
                                [(x0[:n], d0[:n])]) for n in range(2, BI_BATCH)]
        out[part] = _rows_summary(results, len(fused))
    errs["add_rmsnorm"] = max(
        (_max_err(bi.add_rms_norm(x, d, sc, dt)[1], bi.add_rms_norm_plain(x, d, sc, dt)[1])
         for x, d, sc, dt in fused), key=lambda e: e["max_abs_err"] - e["tol"])
    if not plain:
        sums = norms_of_s = 0
        for x, d, sc, dt in fused:
            s, y = bi.add_rms_norm(x, d, sc, dt)
            sums += torch.equal(s, x + d)
            norms_of_s += torch.equal(y, bi.rms_norm(s, sc, dt))
        out["add_rmsnorm_s_is_torch_add"] = {"bit_equal": sums == len(fused),
                                             "calls_equal": sums, "calls": len(fused)}
        out["add_rmsnorm_y_is_norm_of_s"] = {"bit_equal": norms_of_s == len(fused),
                                             "calls_equal": norms_of_s, "calls": len(fused)}
    out["rotary"] = _rows_check(transformer._apply_rotary, seen["rotary"])
    scores_fn = bi.attention_scores_plain if plain else bi.attention_scores
    mix_fn = bi.attention_mix_plain if plain else bi.attention_mix
    out["attention_scores"] = _rows_check(scores_fn, seen["attention_scores"])
    # the softmax's input as the layer makes it: scaled scores, causal mask
    cols = torch.arange(seen["attention_scores"][0][1].shape[1], device=query_pos.device)
    visible = cols[None, :] <= query_pos[:, None]  # (Q, S)
    masked = [(torch.where(visible, bi.attention_scores_plain(q, k) * cfg.head_dim ** -0.5,
                           -1e30),) for q, k in seen["attention_scores"]]
    out["softmax"] = _rows_check(lambda s: torch.softmax(s, dim=-1), masked)
    out["attention_mix"] = _rows_check(mix_fn, seen["attention_mix"])
    q, k = seen["attention_scores"][0]
    errs["attention_scores"] = _max_err(bi.attention_scores(q, k), bi.attention_scores_plain(q, k))
    errs["attention_mix"] = _max_err(bi.attention_mix(*seen["attention_mix"][0]),
                                     bi.attention_mix_plain(*seen["attention_mix"][0]))
    return out, errs


def batch_invariance_phase() -> dict:
    """The serving ops' rows at batch 1 and at batch 8, on the library route
    (``F.linear``, ``einsum``, torch's RMSNorm: the diagnosis) and on the
    batch-invariant route (the repair).  The 125M LM with bf16 weights from
    seed 0; 8 prompts of 128 tokens, the prefill and one decode step.  Each
    op alone on the inputs every layer (the final norm, the lm_head) saw in
    the batch-8 run, each row against that row alone; the headline is row 5
    of layer 0.  Then the whole model's logits of row 5 against the prompt
    run alone.  Fails unless the batch-invariant route is bit-equal
    everywhere and every kernel within its tolerance of its plain version."""
    import numpy as np
    import torch

    from covalent_tpu_plugin_torch.models import decode
    from covalent_tpu_plugin_torch.models.transformer import TransformerLM, lm_125m_config

    model = decode.inference_params(TransformerLM(
        lm_125m_config(max_seq=512), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0)))
    rng = np.random.default_rng(5)
    prompts = torch.as_tensor(rng.integers(0, model.config.vocab_size, (BI_BATCH, BI_PROMPT)),
                              dtype=torch.long, device="cuda")
    positions = {"prefill": torch.arange(BI_PROMPT, device="cuda"),
                 "decode": torch.tensor([BI_PROMPT], device="cuda")}
    report: dict = {}
    failures = []
    for route in ("library", "batch_invariant"):
        _set_route(model, route == "batch_invariant")
        runs = {}
        for rows in (prompts, prompts[BI_ROW:BI_ROW + 1]):
            cache = decode.init_cache(model, rows.shape[0])
            pre = _capture(model, rows, cache)
            runs[rows.shape[0]] = (pre, _capture(model, pre["logits"][:, -1:].argmax(-1), cache))
        per_stage = {}
        for stage, i in (("prefill", 0), ("decode", 1)):
            batch, alone = runs[BI_BATCH][i], runs[1][i]
            ops, errs = _op_checks(model, batch, positions[stage], plain=route == "library")
            whole = batch["logits"][BI_ROW:BI_ROW + 1]
            ops["model_logits"] = {
                "bit_equal": bool(torch.equal(whole, alone["logits"])),
                "max_abs_diff": (whole.float() - alone["logits"].float()).abs().max().item()}
            per_stage[stage] = ops
            if route == "batch_invariant":
                report.setdefault("kernel_vs_plain", {})[stage] = errs
                failures += [f"{stage}.{op}: {r.get('rows_differing')} rows differ"
                             for op, r in ops.items()
                             if not r["bit_equal"] or r.get("rows_differing")]
                failures += [f"{stage}.{op} off its plain version by {e['max_abs_err']}"
                             for op, e in errs.items() if not e["ok"]]
        report[route] = per_stage
    _set_route(model, False)
    report["varying_on_library_route"] = sorted(
        f"{stage}.{op}" for stage, ops in report["library"].items()
        for op, r in ops.items() if not r["bit_equal"] or r.get("rows_differing"))
    if failures:
        raise AssertionError(f"batch_invariance: {failures}; {json.dumps(report)[:3000]}")
    return report


#: Rows of the serving products: a batch-1 decode step, the 8-slot engine's
#: step, one 128-token prefill (the disaggregated set's prefill tier) and an
#: admission wave of 8 prompts of 128 tokens.  The decode attention's
#: (rows, queries) at each: its rows are batch rows, its M the queries.
BI_ROWS = {"m1": 1, "m8": 8, "m128": 128, "m1024": 1024}
BI_ATTENTION = {"m1": (1, 1), "m8": (8, 1), "m128": (1, 128), "m1024": (8, 128)}


def device_ms_labelled(fns: dict, iters: int) -> dict:
    """Device time of one call of each of ``fns`` (label -> (fn, match)),
    all in one profiler window: each label's ``iters`` calls run inside a
    ``record_function`` range that ends with a synchronize, and the device
    events that start inside it are that label's (those whose name holds
    ``match``, every one where it is None).  One window instead of one a
    label: the profiler's own start-up is paid once.  Labels the window
    recorded no device time for are profiled again, up to three windows in
    all (as ``device_ms``); one still without it fails."""
    import torch

    for fn, _ in fns.values():
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    times, todo = {}, dict(fns)
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for label, (fn, _) in todo.items():
                with torch.profiler.record_function(label):
                    for _ in range(iters):
                        fn()
                    torch.cuda.synchronize()
        # a label's range on the device timeline where the tracer mirrored
        # it, else its range on the host (which ends after the synchronize)
        ranges = {}
        for on_device in (False, True):
            ranges.update({e.name: e.time_range for e in prof.events() if e.name in todo and
                           (e.device_type == torch.autograd.DeviceType.CUDA) == on_device})
        totals = dict.fromkeys(todo, 0.0)
        for evt in device_events(prof):
            start = evt.time_range.start
            for label, r in ranges.items():
                match = todo[label][1]
                if r.start <= start <= r.end and (match is None or match in evt.name):
                    totals[label] += evt.time_range.elapsed_us()
        times.update({label: us / iters / 1e3 for label, us in totals.items() if us > 0.0})
        todo = {label: fn for label, fn in todo.items() if label not in times}
        if not todo:
            return times
    raise AssertionError(f"the profiler recorded no device time for {sorted(todo)} "
                         "in three windows")


def cuda_core_product(a, w, out):
    """``bi_gemm``'s CUDA-core kernel (csrc/bi_gemm.cu) on these operands
    as they are, bf16 included: the kernel every serving product took
    before the tensor-core routes, timed beside them as their earlier
    time.  Not a route of the port for bf16 pairs."""
    import ctypes

    import torch

    from covalent_tpu_plugin_torch.ops import _kernels

    sizes, a_strides, w_strides, c_strides = _kernels._bi_operands(a, w, out)
    codes = _kernels._BI_DTYPES
    _kernels.BI_GEMM.launch(
        _kernels._ptr(a), _kernels._ptr(w), _kernels._ptr(out), codes[a.dtype],
        codes[w.dtype], codes[out.dtype], (ctypes.c_int64 * 6)(*sizes),
        (ctypes.c_int64 * 15)(*a_strides, *w_strides, *c_strides),
        torch.cuda.current_stream(a.device).cuda_stream)
    return out


def serving_kernels_timing() -> dict:
    """Device time of every product kind the serving model runs, and of the
    norm, at M 1, 8, 128 and 1024, beside the plain version (the same
    casts), one PyTorch call computing the same function (cuBLAS or torch's
    RMSNorm, a yardstick only: the serving route never calls it) and the
    least time the card could take.  ``bi_gemm_tc``: q/k/v/o, the MLP's wi
    and wo, the lm_head on the bf16 features the model feeds it (f32
    logits; yardsticks ``F.linear`` in bf16, which rounds the logits to
    bf16, and in f32, which computes the f32 logits from f32 operands) and
    the decode attention's scores; ``bi_gemm_mix``: its mix; ``bi_gemm``:
    the f32-operand route, at the lm_head with f32 features (no serving
    model takes it).  Each row also has the route's error against its plain
    version and the tiles it took; each tensor-core row the CUDA-core
    kernel's time on the same operands (``earlier_ms``) and its error."""
    import torch
    import torch.nn.functional as F

    from covalent_tpu_plugin_torch.ops import _kernels
    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    gen = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    d, ff, vocab, heads, hd, cache = 768, 3072, 32768, 12, 64, 512
    weights = {"qkvo": randn(d, d, scale=0.02), "mlp_wi": randn(ff, d, scale=0.02),
               "mlp_wo": randn(d, ff, scale=0.02)}
    w_head, scale = randn(vocab, d, scale=0.02), randn(d)
    w_head32 = w_head.float()
    # name: (kernel route, plain version, library yardsticks, flops, bytes,
    # peak type, the product's operands for its plan)
    cases = {}
    for tag, m in BI_ROWS.items():
        x, x_ff, dx = randn(m, d), randn(m, ff, scale=0.25), randn(m, d, scale=0.5)
        x32 = x.float()
        for name, w in weights.items():
            xin = x_ff if name == "mlp_wo" else x
            out = torch.empty(m, w.shape[0], dtype=torch.bfloat16, device="cuda")
            cases[f"bi_gemm_tc.{name}.{tag}"] = (
                lambda x=xin, w=w: bi.linear(x, w, torch.bfloat16),
                lambda x=xin, w=w: bi.linear_plain(x, w, torch.bfloat16),
                {"library": lambda x=xin, w=w: F.linear(x, w)},
                2 * m * w.shape[0] * w.shape[1], size(xin, w, out), "bfloat16", (xin, w, out))
        logits = torch.empty(m, vocab, device="cuda")
        cases[f"bi_gemm_tc.lm_head.{tag}"] = (
            lambda x=x: bi.linear(x, w_head, torch.float32),
            lambda x=x: bi.linear_plain(x, w_head, torch.float32),
            {"library": lambda x=x: F.linear(x, w_head),
             "library_f32": lambda x=x32: F.linear(x, w_head32)},
            2 * m * vocab * d, size(x, w_head, logits), "bfloat16", (x, w_head, logits))
        cases[f"bi_gemm.lm_head_f32_features.{tag}"] = (
            lambda x=x32: bi.linear(x, w_head, torch.float32),
            lambda x=x32: bi.linear_plain(x, w_head, torch.float32),
            {"library": lambda x=x32: F.linear(x, w_head32)},
            2 * m * vocab * d, size(x32, w_head, logits), "float32", (x32, w_head, logits))
        cases[f"bi_rmsnorm.{tag}"] = (
            lambda x=x: bi.rms_norm(x, scale, torch.bfloat16),
            lambda x=x: bi.rms_norm_plain(x, scale, torch.bfloat16),
            {"library": lambda x=x: F.rms_norm(x, (d,), scale, 1e-6)},
            4 * m * d, size(x, scale, x), "float32", None)
        # the residual add and the norm after it: x and delta in, s and y out
        cases[f"bi_rmsnorm.add.{tag}"] = (
            lambda x=x, dx=dx: bi.add_rms_norm(x, dx, scale, torch.bfloat16),
            lambda x=x, dx=dx: bi.add_rms_norm_plain(x, dx, scale, torch.bfloat16),
            {"library": lambda x=x, dx=dx: F.rms_norm(x + dx, (d,), scale, 1e-6)},
            5 * m * d, size(x, dx, scale, x, x), "float32", None)
        b, nq = BI_ATTENTION[tag]
        q, k, v = randn(b, nq, heads, 1, hd), randn(b, cache, heads, hd), randn(b, cache, heads, hd)
        probs = torch.softmax(randn(b, heads, 1, nq, cache, dtype=torch.float32) * 4,
                              -1).to(torch.bfloat16)
        scores = torch.empty(b, heads, 1, nq, cache, device="cuda")
        mixed = torch.empty(b, nq, heads, 1, hd, device="cuda")
        q32, k32, v32, p32 = q.float(), k.float(), v.float(), probs.float()
        keys = k.permute(0, 2, 1, 3)[:, :, None].expand(b, heads, 1, cache, hd)
        values = v.permute(0, 2, 3, 1)[:, :, None].expand(b, heads, 1, hd, cache)
        cases[f"bi_gemm_tc.attention_scores.{tag}"] = (
            lambda q=q, k=k: bi.attention_scores(q, k),
            lambda q=q, k=k: bi.attention_scores_plain(q, k),
            {"library": lambda q=q32, k=k32: torch.einsum("bqhgd,bshd->bhgqs", q, k)},
            2 * b * nq * heads * cache * hd, size(q, k, scores), "bfloat16",
            (q.permute(0, 2, 3, 1, 4), keys, scores))
        cases[f"bi_gemm_mix.attention_mix.{tag}"] = (
            lambda p=probs, v=v: bi.attention_mix(p, v),
            lambda p=probs, v=v: bi.attention_mix_plain(p, v),
            {"library": lambda p=p32, v=v32: torch.einsum("bhgqs,bshd->bqhgd", p, v)},
            2 * b * nq * heads * cache * hd, size(probs, v, mixed), "bfloat16",
            (probs, values, mixed.permute(0, 2, 3, 1, 4)))
    fns = {}
    for name, (kernel, plain, libraries, *_rest) in cases.items():
        fns[f"{name}:kernel"] = (kernel, name.split(".")[0])
        fns[f"{name}:plain"] = (plain, None)
        for lib, fn in libraries.items():
            fns[f"{name}:{lib}"] = (fn, None)
        if name.startswith(("bi_gemm_tc.", "bi_gemm_mix.")):
            fns[f"{name}:earlier"] = (lambda ops=_rest[-1]: cuda_core_product(*ops),
                                      "bi_gemm_kernel")
    times = device_ms_labelled(fns, 20)
    results = {}
    for name, (kernel, plain, libraries, flops, nbytes, peak, operands) in cases.items():
        bound_ms, bound_by = bound(flops, nbytes, peak)
        row = {"ms": times[f"{name}:kernel"], "plain_ms": times[f"{name}:plain"],
               "library_ms": times.get(f"{name}:library"),
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes}
        got, want = kernel(), plain()
        if isinstance(got, tuple):  # the fused norm: (s, y)
            row["s_bit_equal_plain"] = torch.equal(got[0], want[0])
            got, want = got[1], want[1]
        row.update(_max_err(got, want))
        if "library_f32" in libraries:
            row["library_f32_ms"] = times[f"{name}:library_f32"]
            row["library_note"] = ("library: F.linear in bf16 (bf16 logits); library_f32: "
                                   "F.linear of f32 features and weight (f32 logits)")
        if operands is not None:
            plan = _kernels.bi_gemm_plan(*operands)
            row.update(route=plan.route, tiles=plan.tiles)
        if f"{name}:earlier" in times:
            a, w, out = operands
            want = torch.einsum("...mk,...nk->...mn", a.float(), w.float()).to(out.dtype)
            row.update(earlier_ms=times[f"{name}:earlier"], earlier_max_abs_err=_max_err(
                cuda_core_product(a, w, out), want)["max_abs_err"])
        results[name] = row
    failures = [f"{name}: off its plain version by {r['max_abs_err']} (tol {r['tol']})"
                for name, r in results.items() if not r["ok"]]
    failures += [f"{name}: s differs from torch's add" for name, r in results.items()
                 if r.get("s_bit_equal_plain") is False]
    wrong_route = [name for name, r in results.items() if "route" in r and
                   _kernels.BI_GEMM_ROUTES[r["route"]].name != name.split(".")[0]]
    if failures or wrong_route:
        raise AssertionError(f"serving_kernels: {failures}; rows on another route: {wrong_route}")
    return results


#: The batch-invariant kernels the bf16 serving path runs: the tensor-core
#: products, the mix and the norm; the f32 CUDA-core product never.
SERVING_ROUTES_ON_PATH = ("bi_gemm_tc", "bi_gemm_mix", "bi_rmsnorm")


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
    launches = out["serving_launches"]
    if not all(launches[name] for name in SERVING_ROUTES_ON_PATH) or launches["bi_gemm"]:
        problems.append(f"the bf16 serving path must launch {SERVING_ROUTES_ON_PATH} and not "
                        f"the f32 CUDA-core product: {launches}")
    agreement = out["batch1_agreement"]
    if agreement["equal"] != agreement["rows"]:
        problems.append(f"{agreement['rows'] - agreement['equal']} engine rows differ from "
                        f"batch-1 generate: {agreement['divergences']}")
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


#: What the serving pools preload: no torch optimizer is built there, so
#: ``torch._dynamo`` stays out of their start.
SERVE_PRELOAD = "cloudpickle,torch,covalent_tpu_plugin_torch"


def wire_bytes() -> dict:
    """This process's agent-channel bytes so far, by direction and encoding."""
    from covalent_tpu_plugin_torch.obs.metrics import AGENT_WIRE_BYTES_TOTAL

    return {f"{labels['direction']}_{labels['encoding']}": child.value
            for labels, child in AGENT_WIRE_BYTES_TOTAL._series()}


def wire_delta(before: dict, tokens: int) -> dict:
    """Bytes moved since ``before``, and per streamed token."""
    after = wire_bytes()
    delta = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in set(after) | set(before)}
    down = sum(v for k, v in delta.items() if k.startswith("down"))
    up = sum(v for k, v in delta.items() if k.startswith("up"))
    return {"bytes": delta, "down_bytes_per_token": down / tokens,
            "up_bytes_per_token": up / tokens}


def serve_factory(config, device: str):
    """The serve cell's engine factory (8 slots, sync 32, bf16 weights from
    seed 0 built where it runs), counting flash launches."""
    from covalent_tpu_plugin_torch.models import serve

    return counting_factory(serve.lm_engine_factory(
        config=config, seed=0, device=device, max_batch=SESSION["slots"],
        sync_steps=SESSION["sync_steps"], max_new_tokens=SESSION["long"]))


_MARGIN_MODEL: dict = {}


def divergences(config, device: str, prompts: list, want: list, got: list) -> list:
    """Where each stream of ``got`` first differs from ``want``, with the
    top-2 logit margin there of the serve cell's weights (built here, once,
    as the workers build them)."""
    import numpy as np
    import torch

    from covalent_tpu_plugin_torch.models import decode, serve
    from covalent_tpu_plugin_torch.models.transformer import TransformerLM, use_batch_invariant

    if "model" not in _MARGIN_MODEL:
        # the serving route, as the workers run it
        _MARGIN_MODEL["model"] = use_batch_invariant(decode.inference_params(TransformerLM(
            config, device=device, generator=torch.Generator(device=device).manual_seed(0))))
    model = _MARGIN_MODEL["model"]
    found = []
    for i, (p, w, g) in enumerate(zip(prompts, want, got)):
        if g != w:
            j = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b), len(g))
            with torch.no_grad():
                margin = serve._top2_margin(model, np.concatenate([p, np.asarray(w[:j])]))
            found.append({"request": i, "step": j, "top2_margin": margin})
    return found


def _flash(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k.startswith("launches.")}


async def _settled_stats(sup, served: int) -> dict:
    """A supervisor's first ``serve.stats`` after ``served`` completions."""
    while sup.stats.get("served", 0) < served:
        await asyncio.sleep(0.05)
    return dict(sup.stats)


async def _serve_session(executor, serve_streams: list, config, device: str,
                         reconnect: bool = True) -> dict:
    import numpy as np
    import torch

    from covalent_tpu_plugin_torch.serving import open_session

    prompts, caps = session_prompts(config.vocab_size)
    factory = serve_factory(config, device)

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
    before = wire_bytes()
    start, requests = await traffic()
    results = await asyncio.gather(*(r.result(timeout=600) for r in requests))
    wall = time.perf_counter() - start
    wire = wire_delta(before, sum(caps))
    frames_active = handle.supervisor._client.frames_active
    ttft = [r.ttft_s for r in requests]
    latency = [r.latency_s for r in requests]
    # the worker's first serve.stats after the last completion: its flash
    # launches and peak memory cover the timed run
    timed_stats = await _settled_stats(handle.supervisor, len(prompts) + 1)
    if not reconnect:
        await handle.close()
        if any(len(s) != c for s, c in zip(results, caps)) or any(_flash(timed_stats).values()):
            raise AssertionError(f"session on JSON lines: incomplete streams or flash "
                                 f"launches {_flash(timed_stats)}")
        return {"frames_active": frames_active, "wire": wire, "results": results,
                "tokens_per_s": sum(caps) / wall, "open_s": open_s}

    # the reconnect check: the same traffic again; kill the pool server once
    # every stream has its first tokens; record every token record by
    # generation to check the splice
    sup = handle.supervisor
    records: dict = {}
    inner_sink = sup._sink

    def recording_sink(sid_g, data):
        if data.get("type") == "serve.token":
            records.setdefault((data["rid"], sid_g), []).append(
                (data["idx"], list(data["tokens"])))
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
        for (rid, sid_g), chunks in records.items():
            if rid != r.rid:
                continue
            idx = 0
            for got_idx, tokens in chunks:
                if got_idx != idx:
                    problems.append(f"{rid} on {sid_g}: chunk at idx {got_idx}, expected {idx}")
                idx += len(tokens)
            pieces[sid_g] = [t for _, tokens in chunks for t in tokens]
        # exactly once: what the caller got is all the first generation sent
        # before it died, then the replay's wire from there on
        first, *rest = [pieces[g] for g in sorted(pieces)]
        spliced = first + (rest[-1][len(first):] if rest else [])
        if out != spliced:
            problems.append(f"{r.rid}: delivered stream is not the splice of its generations")
    if handle.reconnects != 1:
        problems.append(f"{handle.reconnects} reconnects, expected 1")
    # replayed tokens that differ below a stream's high-water mark: with
    # batch-invariant rows a replay decodes the same tokens
    replay_mismatches = handle.replay_mismatches
    if replay_mismatches:
        problems.append(f"{replay_mismatches} replayed tokens differ on the reconnect road")
    launches = {run: {k: v for k, v in st.items() if k.startswith("launches.")}
                for run, st in (("timed_run", timed_stats), ("after_reconnect", stats))}
    if any(n for counts in launches.values() for n in counts.values()):
        problems.append(f"the session launched flash kernels: {launches}")

    # the streams against the in-process serve phase's engine rows, and
    # finite logits of the same weights (built here as the worker builds them)
    differ = divergences(config, device, prompts, serve_streams, results)
    with torch.no_grad():
        logits = _MARGIN_MODEL["model"](
            torch.as_tensor(np.stack(prompts), dtype=torch.long, device=device))
    if not bool(torch.isfinite(logits).all()):
        problems.append("non-finite logits")
    if problems:
        raise AssertionError("session: " + "; ".join(problems))
    tokens = sum(caps)
    return {
        "frames_active": frames_active, "wire": wire, "results": results,
        "open_s": open_s, "payload_bytes": handle.payload_bytes,
        "first_request": {"ttft_s": warm.ttft_s, "latency_s": warm.latency_s,
                          "tokens": len(warm.tokens)},
        "requests": len(prompts), "caps": caps, "slots": handle.slots,
        "sync_steps": SESSION["sync_steps"], "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_s": {"p50": statistics.median(ttft), "p95": float(np.percentile(ttft, 95))},
        "ttft_sorted_s": sorted(ttft), "first_wave": timed_stats.get("first_wave"),
        "completion_s": {"p50": statistics.median(latency),
                         "p95": float(np.percentile(latency, 95))},
        "streams_equal_serve_phase": len(prompts) - len(differ),
        "divergences": differ,
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
    reconnect check; the channel runs on binary frames.  Then the same
    requests on a session whose executor keeps JSON lines
    (``agent_frames=False``): the wire bytes per streamed token of each
    encoding, and the streams equal between the two.  Fails on an
    incomplete stream, a gap, a duplicate, non-finite logits, a flash
    launch or a channel on the wrong encoding; reports divergences from the
    serve phase's streams with their margins."""
    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.models.transformer import lm_125m_config

    common = dict(transport="local", cache_dir=str(WORK / "cache"), python_path=sys.executable,
                  use_agent="pool", task_env={"PYTHONPATH": str(ROOT)})
    config = lm_125m_config(max_seq=512)

    async def run():
        executor = GPUExecutor(**common, remote_cache=str(WORK / "remote"))
        try:
            framed = await _serve_session(executor, serve_streams, config, "cuda")
        finally:
            await executor.close()
        executor = GPUExecutor(**common, remote_cache=str(WORK / "remote_lines"),
                               agent_frames=False, pool_preload=SERVE_PRELOAD)
        try:
            lines = await _serve_session(executor, serve_streams, config, "cuda",
                                         reconnect=False)
        finally:
            await executor.close()
        return framed, lines

    framed, lines = asyncio.run(run())
    if not framed["frames_active"] or lines["frames_active"]:
        raise AssertionError(f"session: frames_active {framed['frames_active']} on the frames "
                             f"arm, {lines['frames_active']} on the JSON-lines arm")
    results = framed.pop("results")
    framed["json_lines_arm"] = {
        "frames_active": lines["frames_active"], "wire": lines["wire"],
        "tokens_per_s": lines["tokens_per_s"], "open_s": lines["open_s"],
        "streams_equal_frames_arm": sum(a == b for a, b in zip(lines["results"], results)),
    }
    framed["wire_bytes_per_token"] = {
        "frames": framed["wire"]["down_bytes_per_token"],
        "json_lines": lines["wire"]["down_bytes_per_token"]}
    framed["_results"] = results
    return framed


# --- several resident workers on one card: a replica set, a disaggregated set --


def _percentiles(values: list) -> dict:
    import numpy as np

    return {"p50": statistics.median(values), "p95": float(np.percentile(values, 95))}


async def _timed_burst(front, prompts: list, caps: list) -> tuple:
    """The serve cell's 16 requests at once through ``front``: (results,
    wall seconds, TTFTs, completions)."""
    start = time.perf_counter()
    requests = await asyncio.gather(*(front.request(p, params={"max_new_tokens": c})
                                      for p, c in zip(prompts, caps)))
    results = await asyncio.gather(*(r.result(timeout=600) for r in requests))
    wall = time.perf_counter() - start
    return results, wall, [r.ttft_s for r in requests], [r.latency_s for r in requests]


async def mid_stream(requests: list, caps: list, supervisors) -> object:
    """The supervisor holding the first request seen with some, not all,
    of its tokens."""
    while True:
        for r, c in zip(requests, caps):
            if 0 < len(r.tokens) < c:
                holder = next((sup for sup in supervisors if r.rid in sup._requests), None)
                if holder is not None:
                    return holder
        await asyncio.sleep(0.01)


async def _warm(front, config, n: int) -> None:
    """``n`` requests at once, whose prompts share no prefix with the timed
    ones: the first requests a cold worker serves pay its lazy set-up."""
    import numpy as np

    rng = np.random.default_rng(1)
    warm = await asyncio.gather(*(
        front.request(rng.integers(0, config.vocab_size, SESSION["prompt_len"]),
                      params={"max_new_tokens": SESSION["short"]}) for _ in range(n)))
    await asyncio.gather(*(r.result(timeout=600) for r in warm))


def _refuse_reopen(supervisor) -> None:
    """Every re-open of ``supervisor`` fails, as for a worker that is gone
    for good: the replica dies past its retry budget."""
    from covalent_tpu_plugin_torch.agent import AgentError

    async def refuse():
        raise AgentError("re-open refused: the worker is gone")

    supervisor._open_generation = refuse
    supervisor.retries = 0


def _serve_executors(names: list) -> list:
    from covalent_tpu_plugin_torch import GPUExecutor

    return [GPUExecutor(transport="local", cache_dir=str(WORK / "cache"),
                        remote_cache=str(WORK / f"remote_{name}"), python_path=sys.executable,
                        use_agent="pool", pool_preload=SERVE_PRELOAD,
                        task_env={"PYTHONPATH": str(ROOT)}) for name in names]


async def _replicas(executors: list, config, serve_streams: list, device: str) -> dict:
    import numpy as np

    from covalent_tpu_plugin_torch.serving import open_replica_set

    prompts, caps = session_prompts(config.vocab_size)
    # the two pool servers start at once (each imports torch and the port)
    start = time.perf_counter()
    await asyncio.gather(*(ex.lease_gang() for ex in executors))
    pools_s = time.perf_counter() - start
    start = time.perf_counter()
    rset = await open_replica_set(executors, serve_factory(config, device),
                                  stats_interval_s=1.0, open_timeout_s=300)
    open_s = time.perf_counter() - start
    await _warm(rset, config, 2)
    results, wall, ttft, latency = await _timed_burst(rset, prompts, caps)
    placed = dict(rset.placed)
    stats = {rid: await _settled_stats(sup, sup.served)
             for rid, sup in rset.supervisors.items()}
    frames = {rid: sup._client.frames_active for rid, sup in rset.supervisors.items()}

    # drain-on-death: the second burst, killing the pool server of the
    # first replica seen mid-stream, with no retry left and its re-open
    # refused
    requests = await asyncio.gather(*(rset.request(p, params={"max_new_tokens": c})
                                      for p, c in zip(prompts, caps)))
    victim = await mid_stream(requests, caps, rset.supervisors.values())
    victim_id = victim.replica_of[1]
    survivor_id = "r1" if victim_id == "r0" else "r0"
    # what only the victim holds (not a hedge's other arm) is re-routed
    on_victim = [r.rid for r in requests if set(r.arms) == {victim.sid}]
    _refuse_reopen(victim)
    victim._client._process._proc.kill()
    again = await asyncio.gather(*(r.result(timeout=600) for r in requests),
                                 return_exceptions=True)
    status = rset.status()
    await rset.close()

    problems = []
    if any(len(g) != c for g, c in zip(results, caps)):
        problems.append("a stream of the timed burst is incomplete")
    if set(placed) != {"r0", "r1"}:
        problems.append(f"placements {placed}: a replica took nothing")
    if not all(frames.values()):
        problems.append(f"a replica's channel is not on frames: {frames}")
    for r, c, out in zip(requests, caps, again):
        if isinstance(out, BaseException) or len(out) != c:
            problems.append(f"{r.rid} did not complete across the kill: {out!r}"[:300])
    if victim.state != "failed" or status["state"] != "open":
        problems.append(f"victim {victim.state}, set {status['state']}")
    if status["rerouted"] != len(on_victim):
        problems.append(f"{status['rerouted']} re-routed, {len(on_victim)} were on the victim")
    if any(status["replay_mismatches"].values()):
        problems.append(f"replayed tokens differ: {status['replay_mismatches']}")
    launches = {rid: _flash(st) for rid, st in stats.items()}
    if any(n for counts in launches.values() for n in counts.values()):
        problems.append(f"a replica launched flash kernels: {launches}")
    if problems:
        raise AssertionError("replicas: " + "; ".join(problems))
    differ = divergences(config, device, prompts, serve_streams, results)
    return {
        "replicas": 2, "slots_per_replica": SESSION["slots"], "pools_start_s": pools_s,
        "open_s": open_s, "requests": len(prompts), "caps": caps,
        "tokens_per_s": sum(caps) / wall, "wall_s": wall, "ttft_s": _percentiles(ttft),
        "completion_s": _percentiles(latency), "placed": placed,
        "router_decision_p50_ms": status["router_decision_p50_ms"],
        "hedge": status["hedge"], "frames_active": frames,
        "worker_peak_mem_bytes": {rid: (st.get("device_mem") or {}).get("peak_bytes_in_use")
                                  for rid, st in stats.items()},
        "flash_launches": launches,
        "streams_equal_serve_phase": len(prompts) - len(differ), "divergences": differ,
        "drain": {"on_victim": len(on_victim), "rerouted": status["rerouted"],
                  "completed": sum(not isinstance(o, BaseException) for o in again),
                  "replay_mismatches": status["replay_mismatches"],
                  "streams_equal_timed_burst": sum(a == b for a, b in zip(again, results)),
                  "victim": victim_id,
                  "survivor_served": status["replicas"][survivor_id]["served"]},
        "_results": results, "_victim": victim.executor,
    }


async def _disagg(executors: list, config, replica_streams: list, device: str) -> dict:
    from covalent_tpu_plugin_torch.serving import open_disaggregated_set

    prompts, caps = session_prompts(config.vocab_size)
    # the first executor's pool server (the drain check's victim's) died:
    # it starts again here, alone, and hosts the prefill replica
    start = time.perf_counter()
    await executors[0].lease_gang()
    pool_alone_s = time.perf_counter() - start
    start = time.perf_counter()
    dset = await open_disaggregated_set(executors, serve_factory(config, device),
                                        stats_interval_s=1.0, open_timeout_s=300)
    open_s = time.perf_counter() - start
    await _warm(dset, config, 1)
    warm_transfers = dset.kv_transfers
    results, wall, ttft, latency = await _timed_burst(dset, prompts, caps)
    transfers = list(dset.kv_transfer_s)[warm_transfers:]
    bundle_bytes = list(dset.kv_bundle_bytes)[warm_transfers:]
    frames = {rid: sup._client.frames_active for rid, sup in dset.supervisors.items()}
    await dset.close()
    status = dset.status()  # the workers' last stats arrived with the close
    decode = status["replicas"]["r1"]

    problems = []
    if status["roles"] != {"r0": "prefill", "r1": "decode"}:
        problems.append(f"roles {status['roles']}")
    if any(len(g) != c for g, c in zip(results, caps)):
        problems.append("a stream is incomplete")
    if len(transfers) != len(prompts) or status["requests_by_path"].get("fallback"):
        problems.append(f"{len(transfers)} KV transfers, roads {status['requests_by_path']}")
    if decode.get("kv_admits") != len(prompts) + 1 or decode.get("kv_fallbacks"):
        problems.append(f"decode worker: {decode.get('kv_admits')} KV admissions, "
                        f"{decode.get('kv_fallbacks')} fallbacks")
    if not all(frames.values()):
        problems.append(f"a channel is not on frames: {frames}")
    if problems:
        raise AssertionError("disagg: " + "; ".join(problems))
    differ = divergences(config, device, prompts, replica_streams, results)
    return {
        "prefill_replicas": 1, "decode_replicas": 1,
        "min_prompt_tokens": status["min_prompt_tokens"], "pool_start_alone_s": pool_alone_s,
        "open_s": open_s, "requests": len(prompts), "kv_transfers": len(transfers),
        "degrades": status["requests_by_path"].get("fallback", 0)
        + (decode.get("kv_fallbacks") or 0),
        "requests_by_path": status["requests_by_path"],
        "bytes_per_bundle": {"min": min(bundle_bytes), "max": max(bundle_bytes)},
        "transfer_s": _percentiles(transfers), "ttft_s": _percentiles(ttft),
        "completion_s": _percentiles(latency), "tokens_per_s": sum(caps) / wall,
        "wall_s": wall, "frames_active": frames,
        "decode_worker": {k: decode.get(k) for k in ("kv_admits", "kv_fallbacks", "served")},
        "streams_equal_replicas_phase": len(prompts) - len(differ), "divergences": differ,
    }


def replica_phases(serve_streams: list) -> tuple[dict, dict]:
    """The serve cell through several resident workers on the card: a
    2-replica set (then drain-on-death), and a disaggregated set of one
    prefill and one decode replica, on two pool ``GPUExecutor``\\ s."""
    from covalent_tpu_plugin_torch.models.transformer import lm_125m_config

    config = lm_125m_config(max_seq=512)

    async def run():
        executors = _serve_executors(["replica_a", "replica_b"])
        try:
            start = time.perf_counter()
            replicas = await _replicas(executors, config, serve_streams, "cuda")
            replicas["seconds"] = time.perf_counter() - start
            victim = replicas.pop("_victim")
            start = time.perf_counter()
            disagg = await _disagg([victim] + [ex for ex in executors if ex is not victim],
                                   config, replicas.pop("_results"), "cuda")
            disagg["seconds"] = time.perf_counter() - start
        finally:
            for ex in executors:
                await ex.close()
        return replicas, disagg

    return asyncio.run(run())


# --- dispatcher crash recovery and warm handoff on the serve cell --------------

#: The orphan grace the recovery phase's pool server gets, seconds.
RECOVERY_TTL_S = 300


def _crash_dispatcher(executor) -> None:
    """Tear an executor down as SIGKILL of its process would: supervision
    cancelled, each pool channel's pipes dropped cold, no close; the pool
    server sees a bare stdin EOF and goes into orphan mode."""
    for sup in list(executor._serve_handles.values()):
        if sup._supervisor is not None:
            sup._supervisor.cancel()
    for client in list(executor._agents.values()):
        client._process._writer.close()
        client._reader.cancel()
    executor._serve_handles.clear()
    executor._agents.clear()
    executor._transports.clear()


async def _moved_burst(sup, prompts: list, caps: list, move, name: str) -> dict:
    """The 16 requests through supervisor ``sup``; once a stream is mid-way,
    ``move()`` (None: no move, the baseline), timed until the session runs
    on its next generation.  Returns the streams, the wall, TTFT and
    completion of each request, and the move's seconds."""
    from covalent_tpu_plugin_torch.serving.supervisor import ServeRequest

    requests = [ServeRequest(f"{name}-{i}", [int(t) for t in p], {"max_new_tokens": c}, 0.0)
                for i, (p, c) in enumerate(zip(prompts, caps))]
    start = time.perf_counter()
    for r in requests:
        await sup.submit(r)
    move_s = None
    if move is not None:
        while not any(0 < len(r.tokens) < c for r, c in zip(requests, caps)):
            await asyncio.sleep(0.01)
        t0, handoffs = time.perf_counter(), sup.handoffs
        moving = asyncio.ensure_future(move())
        while sup.handoffs == handoffs and not moving.done():
            await asyncio.sleep(0.005)
        move_s = time.perf_counter() - t0
        await moving  # the old generation's close, after the switch
    results = await asyncio.gather(*(r.result(timeout=600) for r in requests))
    return {"results": results, "wall_s": time.perf_counter() - start, "move_s": move_s,
            "ttft_s": _percentiles([r.ttft_s for r in requests]),
            "completion_s": _percentiles([r.latency_s for r in requests])}


async def _recovery(serve_streams: list, config, device: str) -> dict:
    import shutil

    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.fleet import journal as journal_mod
    from covalent_tpu_plugin_torch.serving import open_session

    prompts, caps = session_prompts(config.vocab_size)
    journal_dir = WORK / "journal"
    remote = WORK / "remote_recovery"
    for path in (journal_dir, remote):
        shutil.rmtree(path, ignore_errors=True)
    env = {"PYTHONPATH": str(ROOT), "COVALENT_TPU_ORPHAN_TTL_S": str(RECOVERY_TTL_S)}

    def executor():
        return GPUExecutor(transport="local", cache_dir=str(WORK / "cache"),
                           remote_cache=str(remote), python_path=sys.executable,
                           use_agent="pool", pool_preload=SERVE_PRELOAD, task_env=env)

    # -- incarnation 1: a journaling dispatcher serves the burst, and dies
    journal_mod.configure(str(journal_dir))
    ex_a = executor()
    start = time.perf_counter()
    handle = await open_session(ex_a, serve_factory(config, device), stats_interval_s=1.0,
                                open_timeout_s=300)
    open_s = time.perf_counter() - start
    await _warm(handle, config, 1)
    first = [await handle.request(p, params={"max_new_tokens": c})
             for p, c in zip(prompts, caps)]
    index = {r.rid: i for i, r in enumerate(first)}
    while not any(0 < len(r.tokens) < c for r, c in zip(first, caps)):
        await asyncio.sleep(0.01)
    sid = handle.sid
    server_pid = ex_a._agents["localhost"]._banner["pid"]
    crashed_at = time.perf_counter()
    _crash_dispatcher(ex_a)
    delivered = {r.rid: list(r.tokens) for r in first}
    rendezvous = remote / "pool_orphan.json"
    while not rendezvous.exists():
        if time.perf_counter() - crashed_at > 60:
            raise AssertionError("recovery: the pool server never orphaned")
        await asyncio.sleep(0.01)

    # -- incarnation 2: replay the journal, adopt the orphan, resume
    journal_mod.reset()
    journal = journal_mod.configure(str(journal_dir))
    ex_b = executor()
    try:
        start = time.perf_counter()
        report = await ex_b.recover(timeout_s=120)
        recover_s = time.perf_counter() - start
        banner = dict(ex_b._agents["localhost"]._banner)
        resumed = {rid: await req.result(timeout=600)
                   for (_, rid), req in report.requests.items()}
        resumed_wall_s = time.perf_counter() - crashed_at
        sup = report.supervisors[sid]
        # then the same traffic with no move (the baseline), a planned
        # handoff mid-stream, and SIGTERM to the pool server mid-stream
        baseline = await _moved_burst(sup, prompts, caps, None, "base")
        planned = await _moved_burst(sup, prompts, caps, sup.handoff, "handoff")

        async def sigterm():
            os.kill(server_pid, signal.SIGTERM)
            while sup.handoffs < 2:
                await asyncio.sleep(0.005)
            while sup._in_handoff:
                await asyncio.sleep(0.005)

        preempt = await _moved_burst(sup, prompts, caps, sigterm, "preempt")
        roads = dict(sup.replay_mismatches_by_road)
        handoffs, generation, reconnects = sup.handoffs, sup.generation, sup.reconnects
        await sup.close()
    finally:
        await ex_b.close()
        journal_mod.reset()

    problems = []
    if banner.get("reattach") is not True or banner.get("pid") != server_pid:
        problems.append(f"the new dispatcher did not adopt the orphan: banner {banner}")
    if report["adopted_sessions"] != [sid] or report["orphaned_sessions"]:
        problems.append(f"adopted {report['adopted_sessions']}, orphaned "
                        f"{report['orphaned_sessions']}")
    states = [e["state"] for e in report["resumed_streams"]]
    crash_streams = [None] * len(prompts)
    for entry in report["resumed_streams"]:
        i = index[entry["rid"]]
        whole = delivered[entry["rid"]][:entry["from"]] + resumed[entry["rid"]]
        if entry["from"] != len(delivered[entry["rid"]]):
            problems.append(f"{entry['rid']}: resumed from {entry['from']}, "
                            f"{len(delivered[entry['rid']])} were delivered")
        crash_streams[i] = whole
    unjournaled = [r.rid for r in first if r.rid not in resumed and not r.done]
    if unjournaled:
        problems.append(f"in-flight streams not resumed: {unjournaled}")
    for i, r in enumerate(first):
        if crash_streams[i] is None and r.done:
            crash_streams[i] = list(r.tokens)  # finished before the crash
    bursts = {"crash": crash_streams, "baseline": baseline["results"],
              "handoff": planned["results"], "preempt": preempt["results"]}
    for name, streams in bursts.items():
        differ = [i for i, (got, want) in enumerate(zip(streams, serve_streams)) if got != want]
        if differ:
            problems.append(f"{name}: streams {differ} differ from the serve phase's")
    if handoffs != 2 or reconnects:
        problems.append(f"{handoffs} handoffs and {reconnects} reconnects, expected 2 and 0")
    if any(roads.values()):
        problems.append(f"replayed tokens differ: {roads}")
    if problems:
        raise AssertionError("recovery: " + "; ".join(problems))
    return {
        "open_s": open_s, "journal_epoch": journal.epoch, "recover_s": recover_s,
        "recovery_report_s": report["duration_s"],
        "streams_adopted": len(report["resumed_streams"]),
        "resume_states": {s: states.count(s) for s in sorted(set(states))},
        "tokens_reemitted": sum(e["sent"] for e in report["resumed_streams"]),
        "finished_before_crash": sum(r.done for r in first),
        "crash_burst_completion_s": resumed_wall_s,
        "baseline": {k: v for k, v in baseline.items() if k != "results"},
        "handoff": {k: v for k, v in planned.items() if k != "results"},
        "preempt": {k: v for k, v in preempt.items() if k != "results"},
        "added_completion_p50_s": {
            "handoff": planned["completion_s"]["p50"] - baseline["completion_s"]["p50"],
            "preempt": preempt["completion_s"]["p50"] - baseline["completion_s"]["p50"]},
        "handoffs": handoffs, "generations": generation, "reconnects": reconnects,
        "replay_mismatches": roads,
        "streams_equal_serve_phase": {name: len(prompts) for name in bursts},
    }


def recovery_phase(serve_streams: list) -> dict:
    """The serve cell through a dispatcher crash and two moves (docstring,
    phase 17)."""
    from covalent_tpu_plugin_torch.models.transformer import lm_125m_config

    start = time.perf_counter()
    out = asyncio.run(_recovery(serve_streams, lm_125m_config(max_seq=512), "cuda"))
    out["seconds"] = time.perf_counter() - start
    return out


#: kernel-name fragments of cuBLAS/CUTLASS matrix products
MATMUL_TAGS = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitK")


# --- slice 1b: the source paper's workloads as lattices (BASELINE configs 2-4) -

#: Config 2 (``bench.py:1134-1179``): n, products per chain, timed chains.
MATMUL_N, MATMUL_CHAIN, MATMUL_REPS = 4096, 16, 50
#: Config 3 (``bench.py:2413-2470``): electrons per fan-out, trials, busy seconds.
FANOUT, FANOUT_TRIALS, BUSY_S = 8, 3, 0.3
#: Trials of the launch arm's MNIST-step fan-out, cut from 3 to keep the run
#: under 1000 s with the ``agent`` phase and the gang's pipeline, MoE and
#: fused-loss arms: each is 8 fresh interpreters that import torch at once
#: (28.96-38.1 s a trial, and the whole run 1014 s with 3, on an NVIDIA H100
#: 80GB HBM3, 700 W).
LAUNCH_MNIST_TRIALS = 1
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


def _invoke_frames() -> dict:
    """How this process's RPC invokes have left so far: one to a frame
    (``invoke_frames``), several to a ``multi_invoke`` frame, or as JSON
    lines."""
    from covalent_tpu_plugin_torch.obs.metrics import (
        AGENT_BATCHED_INVOKES_TOTAL,
        AGENT_FRAMES_TOTAL,
    )

    counts = {f"{labels['verb']}_{labels['encoding']}": child.value
              for labels, child in AGENT_FRAMES_TOTAL._series()}
    return {"invoke_frames": counts.get("invoke_binary", 0.0),
            "multi_invoke_frames": counts.get("multi_invoke_binary", 0.0),
            "invokes_in_multi_invoke": AGENT_BATCHED_INVOKES_TOTAL.value,
            "invoke_lines": counts.get("invoke_jsonl", 0.0)}


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
    wire_frames = _invoke_frames()

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
            trials = (LAUNCH_MNIST_TRIALS if (arm, kind) == ("launch", "mnist_step")
                      else FANOUT_TRIALS)
            for _ in range(trials):
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
                          **({"cut": f"{trials} trials of {FANOUT_TRIALS}"}
                             if trials < FANOUT_TRIALS else {}),
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
        client = executor._agents.get("localhost")
        frames_active = None if client is None else client.frames_active
        if arm != "launch" and not frames_active:
            raise AssertionError(f"lattice {arm}: the pool's channel is not on frames")
        after = _invoke_frames()
        lines.append({"frames_active": frames_active,
                      **{k: after[k] - wire_frames[k] for k in after}})
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


#: The gang phase's electrons: (function, mesh plan, train_lm's options, the
#: train phase's arm whose losses the LM arm's are held against).  The LM
#: arms take 3 steps of the train phase's 5 (cut to keep the run under 1000
#: s with the pipeline, fused-loss and MoE arms), their losses compared over
#: those steps.
GANG_STEPS = 3
GANG_ARMS = {
    "lm_fsdp2": ("lm", dict(fsdp=2), {}, "standard"),
    "lm_tensor2": ("lm", dict(tensor=2), {}, "standard"),
    "cnn_data2": ("cnn", dict(data=2), {}, None),
    "lm_ring2": ("lm", dict(seq=2), dict(attention="ring"), "standard"),
    "lm_ulysses2": ("lm", dict(seq=2), dict(attention="ulysses"), "standard"),
    # GPipe over 2 stages of 6 layers, 4 microbatches of 2 rows
    "lm_pipe2": ("lm", dict(pipe=2), dict(n_micro=4), "standard"),
    # each rank streams its half of the vocabulary; 2 microbatches of 4 rows
    "lm_tensor2_fused": ("lm", dict(tensor=2), dict(vocab_chunk=8192, accumulate_steps=2),
                         "fused"),
    # the Switch MoE of 8 experts, 4 a rank
    "lm_moe_tensor2": ("lm", dict(tensor=2), dict(moe_experts=8), "moe8"),
}
#: Each rank's flash shape under fsdp2 and tensor2 (the parity check at it):
#: (batch, heads, kv heads, seq q, seq k, head dim).
GANG_SHAPES = {"lm_fsdp2": (4, 12, 12, 1024, 1024, 64), "lm_tensor2": (8, 6, 6, 1024, 1024, 64)}
#: Each LM arm's launches of every flash kernel a step on each rank, by query
#: shape and type: the ring runs 2 hops a layer with f32 outputs; Ulysses
#: the bf16 kernels on half the heads over the whole sequence.
GANG_LAUNCHES = {
    "lm_fsdp2": {"4x12x1024x64 bfloat16": 12},
    "lm_tensor2": {"8x6x1024x64 bfloat16": 12},
    "lm_ring2": {"8x12x512x64 bfloat16->float32": 24},
    "lm_ulysses2": {"8x6x1024x64 bfloat16": 12},
    # 6 layers a stage, once for each of the 4 microbatches
    "lm_pipe2": {"2x12x1024x64 bfloat16": 24},
    # half the heads, once for each of the 2 microbatches
    "lm_tensor2_fused": {"4x6x1024x64 bfloat16": 24},
    "lm_moe_tensor2": {"8x6x1024x64 bfloat16": 12},
}
GANG_NOTE = ("the two ranks share one card: these times measure the gang's overhead "
             "(gloo through host memory, two processes on one device), not scaling")


def gang_phase(train_losses: dict) -> tuple[list[dict], dict, dict]:
    """BASELINE configs 5 and 4 as two-process gangs on the card: the
    collective probe, parity at each rank's shape, then the gang electrons
    of :data:`GANG_ARMS`, each LM arm's losses against ``train_losses[its
    reference arm]``.  Returns the phase's lines, the gang's flash launches
    and each LM arm's (summed over its ranks)."""
    import math

    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.models.train import train_lm, train_mnist
    from covalent_tpu_plugin_torch.parallel import MeshPlan
    from covalent_tpu_plugin_torch.parallel.probe import probe_collectives

    lines = []
    probe = probe_collectives(world=2, device="cuda", backend="gloo", timeout_s=240)
    missing = sorted(name for name, entry in probe["collectives"].items() if not entry["ok"])
    lines.append({"probe": probe, "missing": missing,
                  "roads": {"ring_permute": "all_to_all_single with uneven splits "
                                            "(gloo has no send/recv on tensors on the card)",
                            "full_tensor": "not used on the card (its functional all-gather "
                                           "kills the rank on gloo); the gang reduces norms "
                                           "and losses with all_reduce"}})
    needed = ("all_reduce", "all_reduce_avg", "all_reduce_max", "all_gather_into_tensor",
              "reduce_scatter_tensor", "all_to_all_single", "device_mesh", "fsdp2_step")
    if any(not probe["collectives"][name]["ok"] for name in needed):
        raise AssertionError(f"gang: gloo lacks a collective the gang needs on the card: "
                             f"{ {n: probe['collectives'][n] for n in needed} }")
    parity = {}
    for i, (arm, shape) in enumerate(GANG_SHAPES.items()):
        parity[arm] = parity_case(dict(name=arm, shape=shape, dtype="bfloat16", causal=True),
                                  seed=300 + i)
    lines.append({"parity": {arm: {"shape": GANG_SHAPES[arm], "errors": errs}
                             for arm, errs in parity.items()}, "tol_reason": TOL_REASON})

    work = WORK / "gang"
    executor = GPUExecutor(
        transport="local", cache_dir=str(work / "cache"), remote_cache=str(work / "remote"),
        remote_workdir=str(work / "work"), python_path=sys.executable, poll_freq=0.5,
        task_timeout=600, workers=["w0", "w1"], coordinator_port=0,
        task_env={"PYTHONPATH": str(ROOT)})
    launches: dict = {}
    arm_launches: dict = {}

    async def run_arms():
        outs = {}
        try:
            for node, (arm, (kind, plan, overrides, _)) in enumerate(GANG_ARMS.items()):
                if kind == "lm":
                    fn, kwargs = train_lm, dict(steps=GANG_STEPS, batch_size=BATCH,
                                                seq_len=SEQ, seed=0, **overrides)
                else:
                    fn, kwargs = train_mnist, dict(model="cnn", batch_size=256,
                                                   n_batches=64, epochs=1, seed=0)
                wall = time.perf_counter()
                out = await executor.run(fn, [], dict(kwargs, mesh_plan=MeshPlan(**plan)),
                                         {"dispatch_id": "chip_smoke_gang", "node_id": node})
                out["wall_s"] = time.perf_counter() - wall
                out["timings"] = dict(executor.last_timings)
                out["dispatch_mode"] = executor.last_dispatch_mode
                outs[arm] = out
        finally:
            await executor.close()
        return outs

    outs = asyncio.run(run_arms())
    for arm, out in outs.items():
        kind, plan, overrides, reference = GANG_ARMS[arm]
        if out["world_size"] != 2 or len(out["ranks"]) != 2:
            raise AssertionError(f"gang {arm}: world {out['world_size']}, ranks {out['ranks']}")
        if any(not str(r["device"]).startswith("NVIDIA") for r in out["ranks"]):
            raise AssertionError(f"gang {arm}: a rank ran off the card: {out['ranks']}")
        line = {"arm": arm, "mesh": out["mesh"], "backend": out["backend"], **overrides,
                "dispatch_mode": out["dispatch_mode"],
                "devices": [r["device"] for r in out["ranks"]],
                "electron_wall_s": out["wall_s"], "rendezvous_s": out["timings"].get("rendezvous"),
                "timings": out["timings"], "note": GANG_NOTE,
                "peak_mem_bytes": [r["peak_mem_bytes"] for r in out["ranks"]]}
        if kind == "lm":
            losses, want_losses = out["losses"], train_losses[reference][:GANG_STEPS]
            if len(losses) != GANG_STEPS or not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"gang {arm}: losses {losses}")
            gap = max(abs(a - b) for a, b in zip(losses, want_losses))
            if gap > TRAIN_LOSS_TOL:
                raise AssertionError(f"gang {arm}: losses {losses} are {gap} from the train "
                                     f"phase's {reference} arm's {want_losses}")
            want = {shape: n * GANG_STEPS for shape, n in GANG_LAUNCHES[arm].items()}
            for r in out["ranks"]:
                for name, n in r["launches"].items():
                    if n != sum(want.values()):
                        raise AssertionError(f"gang {arm}: rank {r['rank']} launched {name} "
                                             f"{n} times, expected {sum(want.values())}")
                    if r["launch_shapes"][name] != want:
                        raise AssertionError(f"gang {arm}: rank {r['rank']} {name} took "
                                             f"{r['launch_shapes'][name]}, expected {want}")
                    launches[name] = launches.get(name, 0) + n
                    arm_launches.setdefault(arm, {})
                    arm_launches[arm][name] = arm_launches[arm].get(name, 0) + n
            steady = [statistics.median(r["step_s"][1:]) for r in out["ranks"]]
            line.update({
                "losses": losses, "train_arm": reference, "train_losses": want_losses,
                "max_loss_gap_train": gap, "loss_tol": TRAIN_LOSS_TOL,
                "cut": f"{GANG_STEPS} steps of the train phase's {STEPS}",
                "step_s": [r["step_s"] for r in out["ranks"]],
                "steady_step_ms": [t * 1e3 for t in steady],
                "tokens_per_s": out["tokens_per_step"] / max(steady),
                "flash_launches": [r["launches"] for r in out["ranks"]],
                "flash_shapes": [r["launch_shapes"] for r in out["ranks"]],
                "flash_launches_per_step": GANG_LAUNCHES[arm],
            })
        else:
            if not out["loss_last"] < out["loss_first"]:
                raise AssertionError(f"gang {arm}: loss {out['loss_first']} -> "
                                     f"{out['loss_last']} did not fall")
            if any(n for r in out["ranks"] for n in r["launches"].values()):
                raise AssertionError(f"gang {arm}: the CNN launched a flash kernel")
            line.update({"loss_first": out["loss_first"], "loss_last": out["loss_last"],
                         "losses": out["losses"], "steps_per_s": out["steps_per_s"],
                         "batch_size": out["batch_size"], "n_batches": out["n_batches"],
                         "epochs": out["epochs"]})
        lines.append(line)
    by_arm = {line["arm"]: line for line in lines if "arm" in line}
    if "lm_pipe2" in by_arm and "lm_fsdp2" in by_arm:
        by_arm["lm_pipe2"]["lm_fsdp2_steady_step_ms"] = by_arm["lm_fsdp2"]["steady_step_ms"]
    return lines, launches, arm_launches


#: The ssh phase: the marker only the SSH server's environment carries, the
#: login it authorizes, the warm probes per road and the LM arms' steps.
SSH_MARKER = "COVALENT_SSH_SMOKE_MARKER"
SSH_USER = "smoke"
SSH_PROBES = 5
SSH_STEPS = 5
#: The server, in an interpreter of its own (never the dispatcher's event
#: loop, which a synchronous wait would starve): the port's minissh on
#: 127.0.0.1, an ed25519 host key, one authorized client key; it prints its
#: port and serves until its stdin closes.
SSH_SERVER = r"""
import asyncio, os, sys
sys.path.insert(0, sys.argv[2])
from cryptography.hazmat.primitives import serialization
from covalent_tpu_plugin_torch.transport import minissh
root, user = sys.argv[1], sys.argv[3]
host = serialization.load_ssh_private_key(open(root + "/host_ed25519", "rb").read(), None)
client = serialization.load_ssh_public_key(open(root + "/id_ed25519.pub", "rb").read())
async def main():
    server = await minissh.serve("127.0.0.1", 0, host_key=host,
                                 authorized_keys={user: [client]})
    print(server.port, flush=True)
    await asyncio.get_running_loop().run_in_executor(None, sys.stdin.read)
    server.close()
    await server.wait_closed()
asyncio.run(main())
sys.stdout.flush()
os._exit(0)  # the finished commands' pipes are not collected after the loop closed
"""


def ssh_where_electron() -> dict:
    """BASELINE config 1's electron: the worker's host name, with the
    marker of the server it ran under and its pid."""
    import os
    import socket

    return {"host": socket.gethostname(), "marker": os.environ.get(SSH_MARKER),
            "pid": os.getpid()}


def ssh_train_electron(kwargs: dict) -> dict:
    """``train_lm`` with the marker of the server the electron ran under."""
    import os

    from covalent_tpu_plugin_torch.models.train import train_lm

    out = train_lm(**kwargs)
    out["marker"] = os.environ.get(SSH_MARKER)
    return out


class SSHServer:
    """The minissh server of the ssh phase, in a child interpreter, with
    its keys generated into ``root``."""

    def __init__(self, root: Path) -> None:
        from cryptography.hazmat.primitives import serialization
        from cryptography.hazmat.primitives.asymmetric import ed25519

        root.mkdir(parents=True, exist_ok=True)
        self.marker = f"ssh-smoke-{os.urandom(6).hex()}"
        private = (serialization.Encoding.PEM, serialization.PrivateFormat.OpenSSH,
                   serialization.NoEncryption())
        public = (serialization.Encoding.OpenSSH, serialization.PublicFormat.OpenSSH)
        host, client = ed25519.Ed25519PrivateKey.generate(), ed25519.Ed25519PrivateKey.generate()
        (root / "host_ed25519").write_bytes(host.private_bytes(*private))
        (root / "host_ed25519.pub").write_bytes(host.public_key().public_bytes(*public))
        (root / "id_ed25519").write_bytes(client.private_bytes(*private))
        (root / "id_ed25519.pub").write_bytes(client.public_key().public_bytes(*public))
        os.chmod(root / "id_ed25519", 0o600)
        self.key_file, self.host_pub = str(root / "id_ed25519"), str(root / "host_ed25519.pub")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", SSH_SERVER, str(root), str(ROOT), SSH_USER],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=str(root),
            env={**os.environ, SSH_MARKER: self.marker})
        line = self.proc.stdout.readline().strip()
        if not line.isdigit():
            self.close()
            raise AssertionError(f"ssh: the minissh server did not start ({line!r})")
        self.port = int(line)

    def address(self, host: str = "127.0.0.1") -> str:
        return f"{SSH_USER}@{host}:{self.port}"

    def close(self) -> None:
        try:
            self.proc.stdin.close()
            self.proc.wait(30)
        except (OSError, subprocess.TimeoutExpired):
            self.proc.kill()
            self.proc.wait()


def _ssh_stack() -> dict:
    """What this machine offers for SSH: the Python packages and binaries."""
    import importlib.util
    import shutil

    return {"python": {m: importlib.util.find_spec(m) is not None
                       for m in ("cryptography", "zstandard", "asyncssh")},
            "binaries": {b: shutil.which(b) for b in ("ssh", "sshd", "scp", "ssh-keygen")}}


def _wire_totals() -> dict:
    from covalent_tpu_plugin_torch.transport.codec import WIRE_BYTES_TOTAL

    return {f"{labels['direction']}.{labels['codec']}": child.value
            for labels, child in WIRE_BYTES_TOTAL._series()}


def _wire_delta(before: dict) -> dict:
    after = _wire_totals()
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v - before.get(k, 0.0)}


def _overheads(timings: list) -> dict:
    overheads = [t["overhead"] for t in timings]
    walls = [t["wall_overhead"] for t in timings]
    return {"overhead_p50_s": _percentile(overheads, 0.5),
            "overhead_p95_s": _percentile(overheads, 0.95),
            "wall_overhead_p50_s": _percentile(walls, 0.5),
            "wall_overhead_p95_s": _percentile(walls, 0.95), "per_probe": overheads,
            "budget_s": OVERHEAD_BUDGET_S,
            "within_budget": _percentile(walls, 0.95) <= OVERHEAD_BUDGET_S}


def ssh_phase(train_losses: list, local_overheads: dict) -> tuple[list[dict], dict]:
    """The paper's road over a real SSH channel (BASELINE config 1, the warm
    pool, the 125M LM's electron by RPC, a two-worker FSDP gang whose
    workers are two SSH addresses), every executor on the minissh backend
    with the server's host key pinned.  Returns the phase's lines and the
    flash launches of its LM arms."""
    import math
    import socket

    import covalent_tpu_plugin_torch.workflow as ct
    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.obs import events as obs_events
    from covalent_tpu_plugin_torch.parallel import MeshPlan

    stack = _ssh_stack()
    if not stack["python"]["cryptography"]:
        missing = "the `cryptography` package (minissh)"
        if not (stack["binaries"]["sshd"] and stack["binaries"]["ssh-keygen"]):
            missing += ", and sshd/ssh-keygen (openssh)"
        return [{"skipped": f"no SSH backend on this machine: missing {missing}",
                 "stack": stack}], {}

    work = WORK / "ssh"
    server = SSHServer(work / "keys")
    seen: list = []
    obs_events.add_listener(seen.append)
    lines: list = [{"stack": stack, "backend": "minissh", "server_port": server.port,
                    "strict_host_keys": True}]
    launches: dict = {}

    def executor(name: str, **kwargs) -> "GPUExecutor":
        return GPUExecutor(
            transport="minissh", hostname=server.address(), ssh_key_file=server.key_file,
            known_host_key_file=server.host_pub, strict_host_keys=True,
            cache_dir=str(work / name / "cache"), remote_cache=str(work / name / "remote"),
            remote_workdir=str(work / name / "work"), python_path=sys.executable,
            task_env={"PYTHONPATH": str(ROOT)}, task_timeout=600, poll_freq=0.5,
            max_connection_attempts=3, retry_wait_time=1.0, **kwargs)

    def check(arm: str, out: dict, ex, mode: str) -> None:
        if out.get("marker") != server.marker:
            raise AssertionError(f"ssh {arm}: the electron did not run under the SSH server "
                                 f"(marker {out.get('marker')!r})")
        if ex.last_dispatch_mode != mode:
            raise AssertionError(f"ssh {arm}: an electron took {ex.last_dispatch_mode!r}, "
                                 f"not {mode!r}")
        bad = [e for e in seen if e["type"] in ("task.dispatch_failed",) + WRONG_ROAD_EVENTS]
        if bad:
            raise AssertionError(f"ssh {arm}: {[e['type'] for e in bad]}: {bad[0]}")

    def handshakes() -> list:
        return [e["duration_s"] for e in seen
                if e["type"] == "span" and e.get("name") == "pool.connect"]

    def lm_check(arm: str, losses: list, per_rank: list, shape: str | None) -> float:
        if len(losses) != SSH_STEPS or not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"ssh {arm}: losses {losses}")
        gap = max(abs(a - b) for a, b in zip(losses, train_losses))
        if gap > TRAIN_LOSS_TOL:
            raise AssertionError(f"ssh {arm}: losses {losses} are {gap} from the train "
                                 f"phase's {train_losses}")
        for rank in per_rank:
            for name, n in rank["launches"].items():
                if n != 12 * SSH_STEPS:
                    raise AssertionError(f"ssh {arm}: {name} launched {n} times, "
                                         f"expected {12 * SSH_STEPS}")
                if shape and rank["launch_shapes"][name] != {f"{shape} bfloat16": n}:
                    raise AssertionError(f"ssh {arm}: {name} took {rank['launch_shapes'][name]}")
                launches[name] = launches.get(name, 0) + n
        return gap

    try:
        # 1. BASELINE config 1 on the reference's own road: staged files, a
        # nohup launch, status probes, the fetch, the cleanup.
        config1 = executor("config1", use_agent=False)
        where = ct.electron(ssh_where_electron, executor=config1)
        flow = ct.lattice(lambda: where())
        wire = _wire_totals()
        try:
            out, wall = _dispatch(ct, flow)
            check("config1", out, config1, "launch")
            if out["host"] != socket.gethostname():
                raise AssertionError(f"ssh config1: host {out['host']!r} is not the "
                                     f"dispatcher's {socket.gethostname()!r}")
            first = dict(config1.last_timings)
            first_wire = _wire_delta(wire)
            warm, walls = [], []
            for _ in range(SSH_PROBES):
                again, w = _dispatch(ct, flow)
                check("config1", again, config1, "launch")
                warm.append(dict(config1.last_timings))
                walls.append(w)
            key = config1._pool_key(server.address())
            codec = config1._codec_for(key, config1._transports[key])
            advertised = config1._wire_codecs.get(key)
        finally:
            _close(config1)
        lines.append({
            "arm": "config1", "dispatch_mode": "launch", "host": out["host"],
            "marker_ok": True, "electron_wall_s": wall, "timings": first,
            "overhead_s": first["overhead"], "wall_overhead_s": first["wall_overhead"],
            "budget_s": OVERHEAD_BUDGET_S,
            "within_budget": first["wall_overhead"] <= OVERHEAD_BUDGET_S,
            "handshake_s": handshakes(), "preflight_s": first.get("preflight"),
            "wire_bytes_first": first_wire, "codec": codec.name if codec else "raw",
            "advertised_codecs": advertised, "local_lattice": local_overheads.get("launch"),
            "warm": {**_overheads(warm), "electron_wall_p50_s": _percentile(walls, 0.5),
                     "breakdown": warm[-1]}})

        # 2. The warm pool over SSH: its start, five warm electrons on each
        # road, then the train cell's electron by RPC.
        pool = executor("pool", use_agent="pool")
        seen.clear()
        wire = _wire_totals()

        async def pool_arms():
            try:
                first = await pool.run(ssh_where_electron, [], {},
                                       {"dispatch_id": "ssh", "node_id": 0})
                check("pool_first", first, pool, "launch")
                start = dict(pool.last_timings)
                roads = {}
                for road, mode in (("pool_run", "launch"), ("rpc", "rpc")):
                    timings = []
                    for i in range(SSH_PROBES):
                        got = await pool.run(ssh_where_electron, [], {}, {
                            "dispatch_id": "ssh", "node_id": 1 + i, "dispatch_mode": mode})
                        check(road, got, pool, mode)
                        timings.append(dict(pool.last_timings))
                    roads[road] = {**_overheads(timings), "breakdown": timings[-1],
                                   "local_lattice": local_overheads.get(road)}
                (client,) = [c for c in pool._agents.values() if c is not None]
                frames = client.frames_active
                wall = time.perf_counter()
                trained = await pool.run(
                    ssh_train_electron,
                    [dict(steps=SSH_STEPS, batch_size=BATCH, seq_len=SEQ, seed=0)], {},
                    {"dispatch_id": "ssh", "node_id": 9, "dispatch_mode": "rpc"})
                trained["wall_s"] = time.perf_counter() - wall
                trained["timings"] = dict(pool.last_timings)
                check("train_rpc", trained, pool, "rpc")
                return first, start, roads, frames, trained
            finally:
                await pool.close()

        first, start, roads, frames, trained = asyncio.run(pool_arms())
        if frames is not True:
            raise AssertionError(f"ssh pool: the channel is not on frames ({frames})")
        gap = lm_check("train_rpc", trained["losses"], [trained], None)
        steady = statistics.median(trained["step_s"][1:])
        lines.append({"arm": "pool", "pool_start_s": start.get("connect"),
                      "first_breakdown": start, "frames_active": frames,
                      "handshake_s": handshakes(), "roads": roads,
                      "wire_bytes": _wire_delta(wire)})
        lines.append({"arm": "train_rpc", "dispatch_mode": "rpc", "marker_ok": True,
                      "losses": trained["losses"], "train_losses": train_losses,
                      "losses_bit_equal_train": trained["losses"] == train_losses,
                      "max_loss_gap_train": gap, "loss_tol": TRAIN_LOSS_TOL,
                      "step_s": trained["step_s"], "steady_step_ms": steady * 1e3,
                      "tokens_per_s": trained["tokens_per_step"] / steady,
                      "launches": trained["launches"],
                      "launches_per_step": {k: n / SSH_STEPS
                                            for k, n in trained["launches"].items()},
                      "peak_mem_bytes": trained["peak_mem_bytes"], "device": trained["device"],
                      "electron_wall_s": trained["wall_s"], "timings": trained["timings"]})

        # 3. A two-worker FSDP gang whose workers are two addresses of the one
        # server; the rendezvous goes to worker 0's host.
        workers = [server.address("127.0.0.1"), server.address("localhost")]
        gang = executor("gang", workers=workers, coordinator_port=0)
        seen.clear()

        async def gang_arm():
            try:
                wall = time.perf_counter()
                out = await gang.run(
                    ssh_train_electron,
                    [dict(steps=SSH_STEPS, batch_size=BATCH, seq_len=SEQ, seed=0,
                          mesh_plan=MeshPlan(fsdp=2))], {},
                    {"dispatch_id": "ssh_gang", "node_id": 0})
                out["wall_s"] = time.perf_counter() - wall
                out["timings"] = dict(gang.last_timings)
                out["channels"] = sorted(gang._transports)
                return out
            finally:
                await gang.close()

        out = asyncio.run(gang_arm())
        check("gang", out, gang, "launch")
        if out["world_size"] != 2 or len(out["channels"]) != 2:
            raise AssertionError(f"ssh gang: world {out['world_size']}, channels "
                                 f"{out['channels']}")
        shape = "x".join(map(str, (BATCH // 2, PATH_SHAPE[1], SEQ, PATH_SHAPE[5])))
        gap = lm_check("gang", out["losses"], out["ranks"], shape)
        steady = [statistics.median(r["step_s"][1:]) for r in out["ranks"]]
        lines.append({"arm": "gang_fsdp2", "workers": workers, "channels": out["channels"],
                      "mesh": out["mesh"], "backend": out["backend"],
                      "devices": [r["device"] for r in out["ranks"]], "marker_ok": True,
                      "losses": out["losses"], "max_loss_gap_train": gap,
                      "loss_tol": TRAIN_LOSS_TOL, "steady_step_ms": [t * 1e3 for t in steady],
                      "tokens_per_s": out["tokens_per_step"] / max(steady),
                      "flash_launches": [r["launches"] for r in out["ranks"]],
                      "flash_shapes": [r["launch_shapes"] for r in out["ranks"]],
                      "rendezvous_s": out["timings"].get("rendezvous"),
                      "electron_wall_s": out["wall_s"], "timings": out["timings"],
                      "note": GANG_NOTE})
    finally:
        obs_events.remove_listener(seen.append)
        server.close()
    return lines, launches


# --- the native agent, resident profiling, metrics and Pool targets ----------

#: The flash kernels by the names of their device functions (scalar or
#: tensor-core): what a trace of a training step must hold.
FLASH_KERNEL_TAGS = {"flash_fwd": "flash_fwd_", "flash_bwd_dq": "flash_bwd_dq_",
                     "flash_bwd_dkdv": "flash_bwd_dkdv_"}
#: Steps of the RPC electron traced on the pool server: its training outlasts
#: the 2 s capture that starts after its warm-up.
AGENT_PROFILE_STEPS = 60
AGENT_CAPTURE_S = 2.0


def agent_profile_electron(marker: str, steps: int) -> dict:
    """``train_lm`` twice in the resident runtime: 2 warm-up steps, then the
    marker file (the dispatcher's cue to start its capture), then ``steps``
    steps under the capture."""
    from covalent_tpu_plugin_torch.models.train import train_lm

    train_lm(steps=2, batch_size=BATCH, seq_len=SEQ, seed=0)
    with open(marker, "w"):
        pass
    return train_lm(steps=steps, batch_size=BATCH, seq_len=SEQ, seed=0)


def trace_kernels(path: str, tags: dict) -> dict:
    """Device kernel events in a packed ``torch.profiler`` trace, counted by
    tag (a substring of the kernel's name), with the events' total."""
    import tarfile

    counts = dict.fromkeys(tags, 0)
    total = 0
    with tarfile.open(path, "r:gz") as tar:
        members = [m for m in tar.getmembers() if m.name.endswith(".json")]
        if not members:
            raise AssertionError(f"profile artifact {path} holds no trace: "
                                 f"{[m.name for m in tar.getmembers()]}")
        for member in members:
            trace = json.load(tar.extractfile(member))
            for event in trace.get("traceEvents", []):
                if event.get("cat") != "kernel":
                    continue
                total += 1
                name = str(event.get("name") or "")
                for tag, sub in tags.items():
                    if sub in name:
                        counts[tag] += 1
    return {"kernel_events": total, "by_kernel": counts}


def _checked_artifact(info: dict | None, what: str) -> dict:
    """A capture's artifact, its sha256 checked here again."""
    from covalent_tpu_plugin_torch.cache import file_digest

    if not info:
        raise AssertionError(f"agent: {what}: no resident runtime was traced (None)")
    if file_digest(info["path"]) != info["digest"]:
        raise AssertionError(f"agent: {what}: the artifact does not match its digest")
    return info


def serve_families() -> dict:
    """The per-session serving families' process-wide values so far."""
    from covalent_tpu_plugin_torch.serving import metrics as m

    return {"requests": {labels["outcome"]: child.value
                         for labels, child in m.SERVE_REQUESTS_TOTAL._series()},
            "tokens": m.SERVE_TOKENS_TOTAL.value, "sessions": m.SERVE_SESSIONS.value,
            "ttft": list(m.SERVE_TTFT_SECONDS._default_child().counts),
            "request_s": list(m.SERVE_REQUEST_SECONDS._default_child().counts)}


def _bucket_p50(bounds: tuple, counts: list) -> float | None:
    """The upper bound of the bucket that holds the median of ``counts``."""
    total, running = sum(counts), 0
    for bound, n in zip(list(bounds) + [float("inf")], counts):
        running += n
        if total and running >= total / 2:
            return bound
    return None


def families_delta(before: dict, after: dict) -> dict:
    from covalent_tpu_plugin_torch.serving import metrics as m

    ttft = [a - b for a, b in zip(after["ttft"], before["ttft"])]
    request_s = [a - b for a, b in zip(after["request_s"], before["request_s"])]
    return {
        "requests": {k: v - before["requests"].get(k, 0.0)
                     for k, v in after["requests"].items()
                     if v - before["requests"].get(k, 0.0)},
        "tokens": after["tokens"] - before["tokens"],
        "ttft_count": sum(ttft), "ttft_p50_bucket_s": _bucket_p50(m.SERVE_TTFT_SECONDS.buckets,
                                                                  ttft),
        "request_count": sum(request_s),
        "request_p50_bucket_s": _bucket_p50(m.SERVE_REQUEST_SECONDS.buckets, request_s),
    }


def agent_phase(train_losses: list, pool_session: dict, device: str = "cuda") -> dict:
    """The native agent's roads, resident profiling, the per-session
    families and fleet Pool targets, on the card (see the module
    docstring); each step emits one ``agent`` line.  ``train_losses`` are
    the ``train`` phase's standard arm's, ``pool_session`` the ``session``
    phase's (its streams, tokens/s and TTFT p50).  Returns the flash
    launches of the electrons it ran, by kernel."""
    import numpy as np

    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.fleet.pools import Pool, PoolSpec
    from covalent_tpu_plugin_torch.models.train import train_lm
    from covalent_tpu_plugin_torch.models.transformer import lm_125m_config
    from covalent_tpu_plugin_torch.obs import events as obs_events
    from covalent_tpu_plugin_torch.serving import metrics as serve_metrics
    from covalent_tpu_plugin_torch.serving import open_session

    work = WORK / "agent"
    common = dict(transport="local", python_path=sys.executable, task_timeout=600,
                  remote_workdir=str(work / "work"), task_env={"PYTHONPATH": str(ROOT)})
    native = GPUExecutor(**common, cache_dir=str(work / "cache_native"),
                         remote_cache=str(work / "remote_native"), use_agent="native",
                         dispatch_mode="rpc")
    pooled = GPUExecutor(**common, cache_dir=str(work / "cache_pool"),
                         remote_cache=str(work / "remote_pool"), use_agent="pool",
                         dispatch_mode="rpc")
    pool_a = Pool(PoolSpec(name="agent-native", capacity=2), executor=native)
    pool_b = Pool(PoolSpec(name="agent-pool", capacity=2), executor=pooled)
    wrong_road: list = []
    #: at each ``serve.handoff_complete``: (requests replayed, those of them
    #: with tokens delivered before the replay), from ``at_handoff``
    handoffs: list = []
    at_handoff: list = [lambda: 0]

    def listener(event):
        if event.get("type") in WRONG_ROAD_EVENTS:
            wrong_road.append(event)
        elif event.get("type") == "serve.handoff_complete":
            handoffs.append((event["replayed"], at_handoff[0]()))

    config = lm_125m_config(max_seq=512)
    prompts, caps = session_prompts(config.vocab_size)
    want = pool_session["results"]
    smi = nvidia_smi() if device == "cuda" else "cpu"
    launches: dict = {}

    def line(step: str, **fields) -> None:
        if wrong_road:
            raise AssertionError(f"agent {step}: {[e.get('type') for e in wrong_road]}: "
                                 f"{wrong_road[0]}")
        emit({"phase": "agent", "step": step, "card": smi, **fields})

    async def traffic(handle) -> list:
        return list(await asyncio.gather(*(
            handle.request(p, params={"max_new_tokens": c}) for p, c in zip(prompts, caps))))

    def differing_tokens(results: list) -> int:
        return sum(sum(a != b for a, b in zip(r, w)) + abs(len(r) - len(w))
                   for r, w in zip(results, want))

    async def run() -> None:
        try:
            await steps()
        finally:
            await native.close()
            await pooled.close()

    async def steps() -> None:
        # 1-2. the RPC training electron through the native agent: the
        # agent compiles on first use, each invoke forks a --rpc-child
        wall = time.perf_counter()
        out = await native.run(train_lm, [], dict(steps=STEPS, batch_size=BATCH, seq_len=SEQ,
                                                  seed=0),
                               {"dispatch_id": "chip_smoke_agent", "node_id": 0})
        wall = time.perf_counter() - wall
        client = native._agents.get("localhost")
        if client is None or client.mode != "native" or native.last_dispatch_mode != "rpc":
            raise AssertionError(f"agent rpc: mode {getattr(client, 'mode', None)}, road "
                                 f"{native.last_dispatch_mode}")
        line("build", seconds=native.agent_build_s, source="covalent_tpu_plugin_torch/"
             "native/agent.cc", compiler="g++|c++|clang++ -O2 -std=c++17")
        gaps = [abs(a - b) for a, b in zip(out["losses"], train_losses)]
        if len(out["losses"]) != STEPS or max(gaps) > TRAIN_LOSS_TOL:
            raise AssertionError(f"agent rpc: losses {out['losses']} against {train_losses}")
        for name, count in out["launches"].items():
            if count != 12 * STEPS:
                raise AssertionError(f"agent rpc: {name} launched {count} times")
            launches[name] = launches.get(name, 0) + count
        timings = dict(native.last_timings)
        line("rpc_child", losses=out["losses"], losses_bit_equal_train=out["losses"] ==
             list(train_losses), max_loss_gap_train=max(gaps), loss_tol=TRAIN_LOSS_TOL,
             flash_launches=out["launches"], electron_wall_s=wall,
             execute_s=timings.get("execute"), rpc_child_start_s=timings.get("submit"),
             agent_connect_s=timings.get("connect"),
             steady_step_ms=statistics.median(out["step_s"][1:]) * 1e3,
             frames_active=client.frames_active, timings=timings)

        # 4b. a capture on the pool server while an RPC training electron runs
        marker = work / "profile_marker"
        marker.unlink(missing_ok=True)
        wall = time.perf_counter()
        electron = asyncio.ensure_future(pooled.run(
            agent_profile_electron, [str(marker), AGENT_PROFILE_STEPS], {},
            {"dispatch_id": "chip_smoke_agent", "node_id": 1}))
        while not marker.exists():
            if electron.done():
                electron.result()
                raise AssertionError("agent profile: the electron ended before its marker")
            await asyncio.sleep(0.05)
        t0 = time.perf_counter()
        info = _checked_artifact(await pooled.capture_profile(duration_s=AGENT_CAPTURE_S),
                                 "pool server capture")
        capture_s = time.perf_counter() - t0
        trained = await electron
        if pooled.last_dispatch_mode != "rpc" or pooled._agents["localhost"].mode != "pool":
            raise AssertionError("agent profile: the electron did not run in the pool server")
        kernels = await asyncio.to_thread(trace_kernels, info["path"], FLASH_KERNEL_TAGS)
        if not all(kernels["by_kernel"].values()):
            raise AssertionError(f"agent profile: the pool server's trace lacks a flash "
                                 f"kernel: {kernels}")
        for name, count in trained["launches"].items():
            launches[name] = launches.get(name, 0) + count
        line("capture_pool_rpc", worker=info["worker"], duration_s=AGENT_CAPTURE_S,
             capture_s=capture_s, artifact_bytes=info["bytes"], digest=info["digest"],
             trace=kernels, electron_wall_s=time.perf_counter() - wall,
             electron_steps=AGENT_PROFILE_STEPS, flash_launches=trained["launches"])

        # 3. a --serve-child session of the serve cell, opened on Pool A
        # (the native executor), against the pool-mode session's streams
        t0 = time.perf_counter()
        handle = await open_session(pool_a, serve_factory(config, device),
                                    stats_interval_s=1.0, open_timeout_s=300)
        open_s = time.perf_counter() - t0
        try:
            if handle.supervisor._client.mode != "native" or pool_a.in_use != 1:
                raise AssertionError(f"agent session: mode {handle.supervisor._client.mode}, "
                                     f"pool slots {pool_a.in_use}")
            warm_prompt = np.random.default_rng(1).integers(0, config.vocab_size,
                                                           SESSION["prompt_len"])
            warm = await handle.request(warm_prompt, params={"max_new_tokens": SESSION["short"]})
            await warm.result(timeout=600)
            before = serve_families()
            t0 = time.perf_counter()
            requests = await traffic(handle)
            results = await asyncio.gather(*(r.result(timeout=600) for r in requests))
            wall = time.perf_counter() - t0
            stats = await _settled_stats(handle.supervisor, len(prompts) + 1)
            families = families_delta(before, serve_families())
            gauges = {"queue_depth": serve_metrics.SERVE_QUEUE_DEPTH.labels(
                          session=handle.sid).value,
                      "tokens_per_s": serve_metrics.SERVE_TOKENS_PER_S.labels(
                          session=handle.sid).value,
                      "prefix_hits": serve_metrics.SERVE_PREFIX_HITS.labels(
                          session=handle.sid).value,
                      "prefill_positions": serve_metrics.SERVE_PREFILL_POSITIONS.labels(
                          session=handle.sid).value,
                      "sessions": serve_metrics.SERVE_SESSIONS.value}
            differ = differing_tokens(results)
            if differ or families["requests"].get("ok") != len(prompts) \
                    or families["tokens"] != sum(caps) or families["ttft_count"] != len(prompts):
                raise AssertionError(f"agent session: {differ} tokens differ from the pool-mode "
                                     f"session's; families {families}")
            if any(_flash(stats).values()):
                raise AssertionError(f"agent session: flash launches {_flash(stats)}")
            ttft = [r.ttft_s for r in requests]
            line("serve_child", pool=pool_a.name, pool_in_use=pool_a.in_use, open_s=open_s,
                 requests=len(prompts), tokens_per_s=sum(caps) / wall,
                 ttft_p50_s=statistics.median(ttft), families=families, gauges=gauges,
                 divergent_tokens=differ, streams_equal_pool_session=sum(
                     r == w for r, w in zip(results, want)),
                 pool_session={"tokens_per_s": pool_session["tokens_per_s"],
                               "ttft_p50_s": (pool_session.get("ttft_s") or {}).get("p50")},
                 frames_active=handle.supervisor._client.frames_active,
                 worker_peak_mem_bytes=(stats.get("device_mem") or {}).get(
                     "peak_bytes_in_use"))

            # 4a. a capture of the --serve-child while it decodes: bursts of
            # the 16 requests follow each other until the capture is back (a
            # burst is over in about 4 s; the profiler's start in a fresh
            # process can take most of that)
            capturing = True

            async def keep_decoding() -> list:
                bursts = []
                while capturing:
                    burst = await traffic(handle)
                    bursts.append(await asyncio.gather(*(r.result(timeout=600)
                                                         for r in burst)))
                return bursts

            busy = asyncio.ensure_future(keep_decoding())
            while not handle.in_flight:
                await asyncio.sleep(0.01)
            t0 = time.perf_counter()
            try:
                info = _checked_artifact(
                    await handle.capture_profile(duration_s=AGENT_CAPTURE_S), "session capture")
            finally:
                capturing = False
            capture_s = time.perf_counter() - t0
            bursts = await busy
            kernels = await asyncio.to_thread(trace_kernels, info["path"], SERVING_KERNEL_TAGS)
            on_path = {k: kernels["by_kernel"][k] for k in SERVING_ROUTES_ON_PATH}
            differ = sum(differing_tokens(results) for results in bursts)
            if not all(on_path.values()) or differ:
                raise AssertionError(f"agent session capture: serving kernels {kernels}, "
                                     f"{differ} tokens differ")
            line("capture_serve_child", sid=info["sid"], duration_s=AGENT_CAPTURE_S,
                 capture_s=capture_s, artifact_bytes=info["bytes"], digest=info["digest"],
                 trace=kernels, bursts_during_capture=len(bursts))

            # 5. the session handed off from Pool A to Pool B mid-stream: the
            # 16 twice over, moved as soon as the first tokens arrive, so the
            # replay (after the replacement opened) finds the slots busy
            requests = await traffic(handle) + await traffic(handle)
            while not any(r.tokens for r in requests):
                await asyncio.sleep(0.002)
            delivered = sum(len(r.tokens) for r in requests)
            at_handoff[0] = lambda: sum(bool(r.tokens) and r.t_done is None for r in requests)
            t0 = time.perf_counter()
            moved = await handle.handoff(target=pool_b)
            handoff_s = time.perf_counter() - t0
            results = await asyncio.gather(*(r.result(timeout=600) for r in requests))
            complete_s = time.perf_counter() - t0
            differ = differing_tokens(results[:len(want)]) + differing_tokens(
                results[len(want):])
            replayed, streaming = handoffs[-1] if handoffs else (0, 0)
            exactly_once = sum(r == w for r, w in zip(results, want + want))
            if not moved or handle.handoffs != 1 or differ or handle.replay_mismatches \
                    or replayed < SESSION["slots"] or not streaming \
                    or handle.executor is not pooled or (pool_a.in_use, pool_b.in_use) != (0, 1):
                raise AssertionError(
                    f"agent handoff: moved {moved}, handoffs {handle.handoffs}, {differ} tokens "
                    f"differ, replay mismatches {handle.replay_mismatches}, in flight at the "
                    f"handoff {replayed} ({streaming} streaming), slots "
                    f"{pool_a.in_use}/{pool_b.in_use}")
            line("pool_handoff", source=pool_a.name, target=pool_b.name,
                 runtime=handle.supervisor._client.mode, handoff_s=handoff_s,
                 completion_after_handoff_s=complete_s, tokens_before_handoff=delivered,
                 tokens_total=sum(len(r) for r in results), in_flight_at_handoff=replayed,
                 streaming_at_handoff=streaming, slots_per_runtime=SESSION["slots"],
                 streams=len(requests), streams_exactly_once=exactly_once,
                 replay_mismatches=handle.replay_mismatches,
                 slots={pool_a.name: pool_a.in_use, pool_b.name: pool_b.in_use})
        finally:
            await handle.close()
        if (pool_a.in_use, pool_b.in_use) != (0, 0):
            raise AssertionError(f"agent: slots held after close {pool_a.in_use}/{pool_b.in_use}")

    obs_events.add_listener(listener)
    try:
        asyncio.run(run())
    finally:
        obs_events.remove_listener(listener)
    return launches


#: The batch-invariant kernels by the names of their device functions: the
#: tensor-core tiles (skinny, wide), the mix, the f32 CUDA-core product, the norm.
SERVING_KERNEL_TAGS = {"bi_gemm_tc": "bi_gemm_tc_", "bi_gemm_mix": "bi_gemm_mix_kernel",
                       "bi_gemm": "bi_gemm_kernel", "bi_rmsnorm": "bi_rmsnorm_"}
#: The norm's two device functions: alone, and with the residual add.
NORM_KERNEL_TAGS = {"alone": "bi_rmsnorm_kernel", "fused": "bi_rmsnorm_add_kernel"}


def wrapper_host_us(model, calls: int = 200) -> dict:
    """Host time of one call of the serving wrappers on CUDA tensors at the
    decode step's shapes (8 rows), and of ``F.linear`` beside them: the
    host clock around ``calls`` back-to-back calls, before the synchronize
    (each call's kernel is far shorter, so the launch queue never fills)."""
    import torch
    import torch.nn.functional as F

    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    wi, head = model.layers[0].mlp.wi, model.lm_head
    x = torch.randn(8, 1, wi.weight.shape[1], device="cuda").to(torch.bfloat16)
    q = torch.randn(8, 1, 12, 1, 64, device="cuda").to(torch.bfloat16)
    cache = torch.randn(8, 512, 12, 64, device="cuda").to(torch.bfloat16)
    probs = torch.softmax(torch.randn(8, 12, 1, 1, 512, device="cuda"), -1).to(torch.bfloat16)
    fns = {"bi_linear_mlp_wi": lambda: bi.linear(x, wi.weight, wi.dtype),
           "bi_linear_lm_head": lambda: bi.linear(x, head.weight, head.dtype),
           "bi_attention_scores": lambda: bi.attention_scores(q, cache),
           "bi_attention_mix": lambda: bi.attention_mix(probs, cache),
           "bi_rms_norm": lambda: bi.rms_norm(x, x[0, 0], torch.bfloat16),
           "bi_add_rms_norm": lambda: bi.add_rms_norm(x, x, x[0, 0], torch.bfloat16),
           "torch_add": lambda: x + x,
           "F_linear_mlp_wi": lambda: F.linear(x, wi.weight)}
    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - start) / calls * 1e6
        torch.cuda.synchronize()
    return out


def serve_profile() -> dict:
    """One batch-8 decode step of the 125M LM (bf16 weights, 8 live rows at
    position 128) under torch.profiler, in this process: device time by
    kind and by batch-invariant kernel, and the kernels' launches in the
    step (the f32 CUDA-core product must launch none; the norm once alone
    and twice a layer with the residual add before it)."""
    import numpy as np
    import torch

    from covalent_tpu_plugin_torch.models import decode, serve
    from covalent_tpu_plugin_torch.models.transformer import TransformerLM, lm_125m_config
    from covalent_tpu_plugin_torch.ops import _kernels

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
        # One step under the profiler first, not recorded: a trace that starts
        # cold can lose the first kernels of its step (the step's first norm
        # was once missing from the events while its launch was counted).
        with torch.profiler.profile(
                activities=acts,
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1)) as prof:
            step()
            torch.cuda.synchronize()
            prof.step()
            _kernels.reset_launch_counts()
            wall = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - wall
        serving_launches = _kernels.serving_launch_counts()
        host_us = wrapper_host_us(model)
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
    by_route = dict.fromkeys(SERVING_KERNEL_TAGS, 0.0)
    by_name: dict[str, list] = {}
    for evt in kernels:
        ms = evt.time_range.elapsed_us() / 1e3
        for route, tag in SERVING_KERNEL_TAGS.items():
            if tag in evt.name:
                by_route[route] += ms
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
    if serving_launches["bi_gemm"] or not all(serving_launches[k] for k in SERVING_ROUTES_ON_PATH):
        raise AssertionError(f"serve_profile: the decode step's launches {serving_launches}")
    # every residual add rides the norm after it: one norm alone (layer 0's
    # ln_attn), the other 2 n_layers fused
    norm_launches = {form: sum(tag in evt.name for evt in kernels)
                     for form, tag in NORM_KERNEL_TAGS.items()}
    want = {"alone": 1, "fused": 2 * model.config.n_layers}
    if norm_launches != want or serving_launches["bi_rmsnorm"] != sum(want.values()):
        raise AssertionError(f"serve_profile: the step's norms {norm_launches} "
                             f"({serving_launches['bi_rmsnorm']} counted), expected {want}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "step_wall_ms": wall * 1e3, "unprofiled_step_wall_ms": unprofiled * 1e3,
        "device_ms": step_device_ms,
        "device_busy_share": step_device_ms / (wall * 1e3),
        "device_busy_share_unprofiled": step_device_ms / (unprofiled * 1e3),
        "lm_head_cast_ms": lm_head_cast_ms, "lm_head_gemm_ms": lm_head_gemm_ms,
        "device_ms_by_kind": kinds, "device_ms_by_serving_kernel": by_route,
        "device_ms_other_kernels": step_device_ms - sum(by_route.values()),
        "kernel_launches": len(kernels), "serving_kernel_launches": serving_launches,
        "rmsnorm_launches": norm_launches,
        "host_us_per_call": host_us,
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
    # the f32-output variants at the ring's hops
    for i, case in enumerate(VARIANT_CASES):
        parity[case["name"]] = variant_parity_case(case, seed=200 + i)
        torch.cuda.synchronize()
        emit({"phase": "parity", "case": case["name"], "shape": case["shape"],
              "dtype": case["dtype"], "out_dtype": "float32", "causal": case["causal"],
              "positions": case["positions"], "errors": parity[case["name"]],
              "tol_reason": TOL_REASON + "; the f32 variant rounded to bf16 must equal the "
                                         "bf16-output kernel bit for bit"})

    timing = timing_phase(PARITY_CASES[0])
    emit({"phase": "timing", "shape": PATH_SHAPE, "dtype": "bfloat16", "card": smi,
          "kernels": timing})
    emit({"phase": "timing", "shape": D128_CASE["shape"], "dtype": D128_CASE["dtype"],
          "card": smi, "kernels": timing_phase(D128_CASE)})
    variants = variant_timing()
    emit({"phase": "timing", "shape": HOP_SHAPE, "dtype": "bfloat16", "out_dtype": "float32",
          "positions": VARIANT_CASES[0]["positions"], "card": smi, "kernels": variants})

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
    by_arm = {arm["arm"]: arm for arm in arms}
    steady_ms = {arm["arm"]: statistics.median(arm["step_s"][1:]) * 1e3 for arm in arms}
    for arm in arms:
        steady = steady_ms[arm["arm"]] / 1e3
        # the model's operations count dense layers; an MoE step's are not counted
        flops = None if arm["overrides"].get("moe_experts") else model_flops
        line = {"phase": "train", "arm": arm["arm"], "dispatch_mode": arm["dispatch_mode"],
                "vocab_chunk": arm["vocab_chunk"], "overrides": arm["overrides"],
                "losses": arm["losses"],
                "losses_bit_equal_first_arm": arm["losses"] == arms[0]["losses"],
                "max_loss_gap_first_arm": max(abs(a - b) for a, b in
                                              zip(arm["losses"], arms[0]["losses"])),
                "timings": arm["timings"],
                "step_s": arm["step_s"], "steady_step_ms": steady * 1e3,
                "tokens_per_s": arm["tokens_per_step"] / steady,
                "model_flops_per_step": flops,
                "model_flops_utilization": flops and flops / steady / PEAK_FLOPS["bfloat16"],
                "launches": arm["launches"],
                "launches_per_step": {k: n / STEPS for k, n in arm["launches"].items()},
                "launch_shapes": arm["launch_shapes"],
                "n_params": arm["n_params"], "peak_mem_bytes": arm["peak_mem_bytes"],
                "electron_wall_s": arm["wall_s"], "frames_active": arm["frames_active"],
                "device": arm["device"], "card": smi}
        if "moe_aux" in arm:
            line.update({"moe_aux": arm["moe_aux"], "lm_losses": lm_losses(arm),
                         "aux_weight": MOE_AUX_WEIGHT})
        if arm["arm"] == "remat_dots":
            # beside the standard loss in the same pool server: memory and time
            base = by_arm["standard_rpc"]
            line.update({
                "losses_bit_equal_standard_rpc": arm["losses"] == base["losses"],
                "standard_rpc_peak_mem_bytes": base["peak_mem_bytes"],
                "standard_rpc_steady_step_ms": steady_ms["standard_rpc"],
                "peak_mem_saved_bytes": base["peak_mem_bytes"] - arm["peak_mem_bytes"],
                "step_time_ratio": steady_ms["remat_dots"] / steady_ms["standard_rpc"],
                "launch_note": "each block's flash forward runs again in the backward "
                               "(recomputed, not a 2-D product): 24 a step"})
        emit(line)

    emit({"phase": "profile", "card": smi, **profile_phase()})

    # The small f32 LM of serve_check runs its serving products on the f32
    # CUDA-core route: that route's path.
    _kernels.reset_launch_counts()
    emit({"phase": "serve_check", **serve_check()})
    f32_path_launches = _kernels.serving_launch_counts()
    # The serving ops' rows at batch 1 and in a batch of 8, on the library
    # route (the diagnosis) and on the batch-invariant kernels (the repair),
    # then the kernels' times at the serve cell's shapes.
    start = time.perf_counter()
    invariance = batch_invariance_phase()
    emit({"phase": "batch_invariance", "card": smi, "seconds": time.perf_counter() - start,
          **invariance})
    serving_timing = serving_kernels_timing()
    emit({"phase": "serving_kernels", "card": smi, "shapes": serving_timing})
    # The serving path.  Its attention over the KV cache runs no flash
    # kernel, and every product and norm takes the batch-invariant kernels:
    # the electron resets the launch counts in its own process and reports
    # them; the flash counts must stay 0, the serving ones not.
    _kernels.reset_launch_counts()
    served = serve_phase()
    if any(_kernels.launch_counts().values()):
        raise AssertionError(f"serve: flash kernels launched {_kernels.launch_counts()}")
    serving_launches = {name: n + served["serving_launches"][name]
                        for name, n in _kernels.serving_launch_counts().items()}
    serve_streams = served.pop("_streams")
    emit({"phase": "serve", "card": smi, **served})
    emit({"phase": "serve_profile", "card": smi, **serve_profile()})
    # The resident session: the serve cell's traffic through open_session,
    # on frames and on JSON lines.
    start = time.perf_counter()
    session = session_phase(serve_streams)
    pool_session = {"results": session.pop("_results"), "tokens_per_s": session["tokens_per_s"],
                    "ttft_s": session["ttft_s"]}
    emit({"phase": "session", "card": smi, "seconds": time.perf_counter() - start, **session})
    # Several resident workers on the card: a replica set, then a
    # disaggregated set, each with the serve cell's traffic.
    replicas, disagg = replica_phases(serve_streams)
    emit({"phase": "replicas", "card": smi, **replicas})
    emit({"phase": "disagg", "card": smi, **disagg})
    # A journaling dispatcher crashes mid-burst and a second one adopts its
    # orphaned pool server; then a planned handoff and a SIGTERM notice.
    emit({"phase": "recovery", "card": smi, **recovery_phase(serve_streams)})

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

    # BASELINE configs 5 and 4 as two-process gangs on the card: every rank
    # reports its own launches; the phase fails if a rank of an LM arm ran a
    # flash kernel a number of times other than 12 a step.
    start = time.perf_counter()
    gang_lines, gang_launches, gang_arm_launches = gang_phase(
        {name: by_arm[name]["losses"] for name in ("standard", "fused", "moe8")})
    for line in gang_lines:
        emit({"phase": "gang", "card": smi, **line})
    emit({"phase": "gang", "card": smi, "seconds": time.perf_counter() - start,
          "flash_launches": gang_launches})

    # The paper's road over a real SSH channel on loopback: config 1, the
    # warm pool, the LM by RPC and the FSDP gang over two SSH addresses.
    local_overheads = {line["arm"]: {k: line["overhead"][k] for k in (
        "dispatch_overhead_s", "wall_overhead_p50_s", "wall_overhead_p95_s")}
        for line in lattice_lines if "overhead" in line}
    _kernels.reset_launch_counts()
    start = time.perf_counter()
    ssh_lines, ssh_launches = ssh_phase(arms[0]["losses"], local_overheads)
    # the electrons ran in the workers, which report their counts; ours
    # (0 after the reset unless the dispatcher launched one) are added
    ssh_launches = {name: n + ssh_launches.get(name, 0)
                    for name, n in _kernels.launch_counts().items()}
    for line in ssh_lines:
        emit({"phase": "ssh", "card": smi, **line})
    emit({"phase": "ssh", "card": smi, "seconds": time.perf_counter() - start,
          "flash_launches": ssh_launches})

    # The native agent's roads, resident profiling, the per-session
    # families and Pool targets: the electrons report their own launches
    # (the RPC training electron ran in a --rpc-child), ours are added.
    _kernels.reset_launch_counts()
    start = time.perf_counter()
    agent_launches = agent_phase(arms[0]["losses"], pool_session)
    agent_launches = {name: n + agent_launches.get(name, 0)
                      for name, n in _kernels.launch_counts().items()}
    emit({"phase": "agent", "card": smi, "seconds": time.perf_counter() - start,
          "flash_launches": agent_launches})

    kernels = []
    for kernel in _kernels.KERNELS:
        res = timing[kernel.name]
        path_errs = [v["max_abs_err"] for k, v in parity["path"].items()
                     if k.startswith(kernel.name + ".")]
        kernels.append({
            "name": kernel.name, "route": "cuda",
            "source": f"covalent_tpu_plugin_torch/csrc/{kernel.source}",
            "replaces": kernel.replaces, "launches": launches[kernel.name],
            "gang_launches": gang_launches.get(kernel.name, 0),
            "ring_launches": gang_arm_launches["lm_ring2"][kernel.name],
            "ulysses_launches": gang_arm_launches["lm_ulysses2"][kernel.name],
            "ssh_launches": ssh_launches.get(kernel.name, 0),
            "agent_launches": agent_launches.get(kernel.name, 0),
            "max_abs_err": max(path_errs), "ms": res["kernel_ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["library_ms"], "ms_cold_l2": res["kernel_cold_ms"],
            # the kernel each (dtype/head dim) takes; the path is bfloat16/64
            "routes": {f"{dt}/{d}": kernel.route(getattr(torch, dt), d)
                       for dt in ("bfloat16", "float16", "float32") for d in _kernels.HEAD_DIMS},
            # the variant with f32 outputs, on the lm_ring2 arm's path
            "f32_variant": {
                "launches": gang_arm_launches["lm_ring2"][kernel.name],
                "shape": "8x12x512x64 bfloat16->float32",
                "max_abs_err": max(v["max_abs_err"] for case in VARIANT_CASES
                                   for k, v in parity[case["name"]].items()
                                   if k.startswith(kernel.name + ".")),
                "ms": variants[kernel.name]["kernel_ms"],
                "bf16_out_ms": variants[kernel.name]["bf16_out_ms"],
                "plain_ms": variants[kernel.name]["plain_ms"],
                "bound_ms": variants[kernel.name]["bound_ms"],
                "bound_by": variants[kernel.name]["bound_by"],
                "library_ms": variants[kernel.name]["library_ms"],
                "library_note": variants["library_note"],
            },
        })
        if launches[kernel.name] < 1:
            raise AssertionError(f"{kernel.name} was not launched on the main path")
        if gang_launches.get(kernel.name, 0) < 1:
            raise AssertionError(f"{kernel.name} was not launched on the gang's path")
        if gang_arm_launches["lm_ring2"][kernel.name] < 1:
            raise AssertionError(f"{kernel.name}'s f32 variant was not launched on the ring")
        if ssh_launches.get(kernel.name, 0) < 1 and "skipped" not in ssh_lines[0]:
            raise AssertionError(f"{kernel.name} was not launched on the ssh phase's path")
        if agent_launches.get(kernel.name, 0) < 1:
            raise AssertionError(f"{kernel.name} was not launched on the agent phase's path")
    # The serving kernels port no Pallas kernel: the main path is the serve
    # phase, where the bf16 LM runs the tensor-core products, the mix and
    # the norm; the f32 CUDA-core product's path is serve_check's f32 LM
    # (0 launches on the serve phase's).  Each row is the decode step's
    # shape (8 rows), the lm_head for the products and the fused add and
    # norm (24 of a step's 25) for the norm; "shapes" has every other.
    errs = invariance["kernel_vs_plain"]
    tc_ops = list(BI_DENSE) + ["lm_head_f32", "attention_scores"]
    for kernel, key, err in (
            (_kernels.BI_GEMM_TC, "bi_gemm_tc.lm_head.m8",
             max(errs[stage][op]["max_abs_err"] for stage in errs for op in tc_ops)),
            (_kernels.BI_GEMM_MIX, "bi_gemm_mix.attention_mix.m8",
             max(errs[stage]["attention_mix"]["max_abs_err"] for stage in errs)),
            (_kernels.BI_GEMM, "bi_gemm.lm_head_f32_features.m8",
             max(r["max_abs_err"] for k, r in serving_timing.items()
                 if k.startswith("bi_gemm.lm_head_f32_features."))),
            (_kernels.BI_RMSNORM, "bi_rmsnorm.add.m8",
             max(errs[stage][op]["max_abs_err"] for stage in errs
                 for op in ("rmsnorm", "add_rmsnorm")))):
        res = serving_timing[key]
        on_serve = kernel.name in SERVING_ROUTES_ON_PATH
        launches = serving_launches[kernel.name] if on_serve else f32_path_launches[kernel.name]
        kernels.append({
            "name": kernel.name, "route": "cuda",
            "source": f"covalent_tpu_plugin_torch/csrc/{kernel.source}",
            "replaces": kernel.replaces, "launches": launches,
            "path": "serve" if on_serve else "serve_check (f32 LM)",
            "serve_launches": serving_launches[kernel.name],
            "max_abs_err": err, "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["library_ms"], "shape": key,
            "shapes": {k: v for k, v in serving_timing.items()
                       if k.startswith(kernel.name + ".")},
        })
        if launches < 1:
            raise AssertionError(f"{kernel.name} was not launched on its path")
    if serving_launches["bi_gemm"]:
        raise AssertionError(f"the bf16 serve path launched the f32 CUDA-core product "
                             f"{serving_launches['bi_gemm']} times")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
