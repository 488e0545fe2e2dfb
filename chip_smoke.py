#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``covalent_tpu_plugin_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON object per line on stdout.  They run in this order: 1, 2;
3 beside the ``stall`` arm of 20 (the build needs the host's cores, the arm
a card no other process holds); 4-6, 8-11, 13, the ``w8_kernel`` arm of
24 and the ``kernel_parity`` and ``decode_profile`` arms of 25; then 7.
All of these run alone on the card, so every kernel's times and the main
path's step times are measured on a quiet card.  Then three lanes run at
once: lane a in this process (12, 14-17, then the rest of 24 and of 25;
their lines say ``"lane": "a"``), lane b in a child process
(``python3 chip_smoke.py --lane b``: 18, the ``preempt`` arm of 20, 19) and
lane c in another (the prewarm, straggler and cas arms of 23, 21, the
serving arms of 23, 22).  A child lane waits for what it needs from lane a
(the ``train`` losses, the ``session`` streams) as files under
``build/chip_smoke/lanes``; its lines are printed when every lane is done,
so their ``elapsed_s`` are not in order, and a time measured in a lane was
measured beside the other two lanes' load.  26 comes last.

1. ``device``: the card, with its name and power limit as ``nvidia-smi`` gives them.
2. ``startup``: what a fresh interpreter pays before an electron's first op
   on the card: the interpreter alone, ``import torch``, ``import
   covalent_tpu_plugin_torch``, ``import torch._dynamo`` (a torch
   optimizer's first construction imports it), ``torch.cuda.init()`` and
   the first op (the context's creation); one run of the 3 it takes in
   full (the line says ``cut``).
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
    probes (3 on the launch arm: its line says ``cut``; ``last_timings``),
    against BASELINE's budget of 2 s; config 3,
    three fan-outs of 8 electrons (trivial, 0.3 s of sleep, one MNIST MLP
    Adam step on the card each), 2 trials each of the 3 (the launch arm runs
    no MNIST-step fan-out: the lines say ``cut``); config 4, the MNIST MLP and
    CNN (``models.train.train_mnist``: 64 batches of 256, 2 epochs of 20,
    loss first and last, steps/s; the launch arm the MLP only).  Every
    electron must take its arm's road, and the warm arms' values must equal
    the launch arm's (the pool_run arm's for what the launch arm cut).  Then, with the pool server
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
    its own.  The LM arms take 2 of the 5 steps (their lines say ``cut``).
    The two ranks share one card, so the times measure the gang's
    overhead, not scaling.
20. ``elastic``: fault tolerance on the main path.  Arm ``preempt``: a
    user's checkpoint-cooperative electron (``elastic_train_electron``: the
    125M LM at full width, B=8, S=1024, bf16 with f32 master weights, AdamW
    3e-4, seed 0, 12 steps, each held to 2 s of wall time) through
    ``GPUExecutor(use_agent=False, heartbeat_interval=1.0,
    checkpoint_interval_s=2.0, checkpoint_keep_n=2, max_task_retries=2)``
    (the default stall threshold, three beats: a save or restore the
    worker announces holds the stall clock) and a ``ChaosPlan`` whose one
    preemption (SIGTERM, the channel lost 20 s later) is armed by the
    dispatcher's record (``worker.checkpoint_saved``) of a checkpoint of
    step >= 4.
    It must take 2 attempts with one ``worker_preempted`` retry, resume
    from the digest-checked checkpoint the dispatcher planned, recompute
    fewer steps than an interval holds, log no ``worker.checkpoint_error``,
    launch every flash kernel in both attempts, and give every step's loss
    within 1e-4 of the same electron run uninterrupted beside it (the twin,
    unpaced; the line says whether the bits are equal).  Printed: the saves (step,
    bytes, seconds, trigger), the restore's seconds, the steps executed
    and recomputed, both runs' losses, the launches of each attempt, the
    longest gap between two beats of each attempt beside the stall
    threshold, and the holds.  Arm
    ``stall``: an electron that allocates 1 GiB on the card, beats, and
    SIGSTOPs its own process group on attempt 1 (a marker file decides),
    under ``heartbeat_interval=1.0, stall_threshold=4, max_task_retries=1``:
    a ``worker_stalled`` retry, the escalation with 0 survivors, and no
    process of attempt 1 left among ``nvidia-smi``'s compute processes when
    attempt 2 starts (counted in rows: inside a container ``nvidia-smi``
    may report another PID namespace's pids).  No arm may fall back to a local run.
21. ``ssh``: the paper's road over a real, encrypted SSH channel on
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
    server (``lm_fsdp2`` as in the ``gang`` phase, 2 of the 5 steps, its
    rendezvous on worker 0's host).  Arm ``cache``, on the same warm pool with ``cache_results``
    from there on: the ``train`` cell's electron by RPC at 2 steps (a
    miss), the same call (a hit), seed 1 (a miss), seed 0 on the launch
    road (a miss: the RPC road's entry is not its) and again (a hit), then
    a cheap electron on the launch road, by RPC twice and on the launch
    road again (miss, miss, hit, hit): each call's wall, its
    ``executor.cache_lookup`` span and its flash launches (read from the
    pool server before and after an RPC call, from the worker on the
    launch road), every kernel on each miss and none on a hit, which dials
    nothing; a hit's losses bit-equal to its miss's.  Any missing marker,
    ``task.dispatch_failed`` or electron on another road fails the run.
    Without an SSH backend on the machine the phase prints one line naming
    what is missing and runs no arm.
22. ``agent``: the native C++ agent, resident profiling, the per-session
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
23. ``lifecycle``: the executor's lifecycle over minissh (a second
    server on loopback, two logins for a third worker address).
    ``prewarm``: a lattice whose downstream node runs over minissh (a pool
    server preloading cloudpickle) and waits on a 2.5 s upstream node on the
    dispatcher, with ``prewarm`` on and off: the downstream node's
    ``connect``, the ``executor.prewarm`` span and
    ``covalent_tpu_prewarm_seconds``.  ``teardown``: ``teardown_gang()``
    while an electron runs (refused) and after (done), ``is_warm`` after,
    and the next electron's fresh dial.  ``straggler``: a gang of three
    over three SSH addresses whose ranks gather on a barrier, the last
    then leaving 3 s after the others, under
    ``COVALENT_TPU_STRAGGLER_BUDGET_S=1`` and
    ``COVALENT_TPU_STRAGGLER_REDIAL=1``: the flagged worker and its
    differential, its channel dropped and dialed afresh by the next
    electron (run with the detection off); then ``health_canary`` on a live
    pool server and on one killed.  ``cas``: three electrons whose pickles each carry one block
    of the 125M LM under ``cas_max_bytes`` of the harness and 1.2 blocks:
    ``CAS_EVICTED``, the harness and the running pickle kept after every
    electron, the TTL's ``-mmin`` in the pre-flight.  ``ssh_session``:
    the ``session`` phase's 16 requests through ``open_session`` on a
    minissh executor: open seconds, tokens/s, TTFT and completion p50/p95,
    wire bytes per token, the serving kernels' launches in the worker and
    0 tokens different from the ``session`` phase's streams;
    ``ssh_replicas``: the same through a replica set of two SSH addresses
    (tokens/s, placement, 0 tokens different).
24. ``adapters``: slice 3a (int8 weight-only serving and LoRA), at the
    125M LM's full width.  ``w8_kernel``: the int8-weight product
    (``csrc/bi_gemm_w8.cu``) at M 1, 8, 128 and 1024 on q/k/v/o, wi, wo and
    the lm_head (bf16 features, f32 out): the elements that differ from
    ``bi_gemm_tc`` on the widened weight followed by the reference's scale
    step (0), device ms beside the plain version, ``F.linear`` on a weight
    widened beforehand (a yardstick) and the bound, and the rows that
    differ at batch 8 from each row alone (0).  ``lora_train``: two
    fine-tune electrons by RPC, run on the ``train`` phase's warm pool
    after its arms (``models.lora.train_lora``: rank 16 on the
    default targets, B=8, S=1024, 3 steps; the float base, then QLoRA on
    the int8 base): losses finite and falling, 12 launches of each flash
    kernel a step, step ms, the base bit-unchanged, every adapter leaf
    moved, the worker's digest of the adapter equal to the one of the
    bundle the executor's registry ships (its bytes in the CAS, unpacked
    and digested again).  ``modes_bank``:
    one session on a pool server whose engine hosts the decode modes
    ``fp``, ``int8``, ``kv_quant`` and ``full_quant`` and a bank of two
    adapters (``lora_train``'s and a seeded one); the serve cell's 16
    requests mixing ``quality`` and ``adapter``, a third adapter put in the
    executor's registry and attached mid-burst (requests after it use it),
    then detached: per mode tokens/s, TTFT p50, the weight bytes a decode
    step reads and the int8 launches a decode step (0 on ``fp`` and
    ``kv_quant``, 73 on ``int8`` and ``full_quant``); each quantized
    twin's logit cosine against fp (above 0.999 for ``int8`` and
    ``kv_quant``); the tokens that differ between each bank lane and a
    single-adapter engine's stream, and between each base lane and the
    ``session`` phase's (0); the attach's seconds and its
    ``serve_attached`` record.
25. ``serve_moe``: slice 4, part 3(a), the ``train`` phase's ``moe8`` LM
    decoded: the 125M LM with 8 Switch experts at capacity factor 1.25,
    bf16 weights from seed 0, in this process.  ``generate`` at batch 8
    (prompt 128, 128 new tokens; a warm call, then the median of 3): decode
    tokens/s and ms a new token, the MoE routed over the call.  ``engine``:
    the ``serve`` phase's 16 requests through a ``ContinuousEngine`` of 8
    slots, sync 32, each row routed over its own tokens (``per_row``):
    tokens/s, TTFT and completion p50/p95, and the serving kernels'
    launches on this run (the path; the f32 CUDA-core product now has
    launches on a bf16 serving path: the router).  ``batch_invariance``:
    each request served alone by an engine of the same ``max_batch``, the
    tokens that differ from its stream in the batch (0).  Run in the quiet
    prefix, their lines printed with the phase's: ``kernel_parity``:
    layer 0's MoE block on the batch-invariant route
    against its plain twin at a decode step of 8 rows and a wave of 8 x
    128, and the router's and the expert products' device times beside
    the plain twin, one library call and the bound.  ``decode_profile``:
    one decode step of 8 rows under ``torch.profiler``: kernels a step,
    device and host ms, the busy share, launches by serving kernel, and
    no library GEMM by kernel name.  ``session``: the same traffic through
    ``open_session`` on a pool server that builds the model from the seed:
    the tokens that differ from ``engine``'s (0).  ``memory``: this
    process's peak and the worker's.
26. ``kernels``: every kernel with its launches on its path (the flash
    kernels: training, with the gang's launches beside as
    ``gang_launches``, the ``lm_ring2`` arm's f32-output launches as
    ``ring_launches`` with the variant's times under ``f32_variant``, the
    ``lm_ulysses2`` arm's as ``ulysses_launches``, the ``ssh`` phase's
    as ``ssh_launches``, the ``agent`` phase's as ``agent_launches`` and
    the ``elastic`` phase's (both attempts of ``preempt``) as
    ``elastic_launches``, the ``cache`` arm's misses as
    ``cache_miss_launches``, the ``adapters`` phase's fine-tunes as
    ``lora_launches``; the
    batch-invariant ones: the ``serve`` phase, and
    the f32 CUDA-core product ``serve_check``'s f32 LM, with its 0 launches
    on the ``serve`` phase beside, and the serve cell over SSH's as
    ``ssh_session_launches`` and the MoE engine's as ``serve_moe_launches``,
    with the router's and the expert products' times under ``shapes``; the
    int8-weight product: the ``adapters`` phase's session),
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
#: The script's start on the system's monotonic clock: a lane (``--lane``)
#: reads the main process's, so every ``elapsed_s`` counts from one start.
_START = float(os.environ.get("CHIP_SMOKE_START") or time.monotonic())
#: The child lane this process runs (``--lane``), named on its phase lines.
_LANE = None

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
        obj = {**obj, **({"lane": _LANE} if _LANE else {}),
               "elapsed_s": time.monotonic() - _START}
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


#: Profiled steps tried before an incomplete trace fails the phase.
PROFILE_STEP_TRIES = 3


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
#: Fresh interpreters the startup split is measured in: 1 of the 3 it takes
#: in full, a cut made for the ``elastic`` phase (the line says ``cut``).
STARTUP_RUNS, STARTUP_RUNS_FULL = 1, 3
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
            "runs": runs,
            **({"cut": f"{STARTUP_RUNS} run of {STARTUP_RUNS_FULL}"}
               if STARTUP_RUNS < STARTUP_RUNS_FULL else {})}


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


def train_phase() -> tuple[list[dict], list[dict]]:
    """The training electron once an arm of :data:`TRAIN_ARMS`, each arm's
    result named by ``arm``; then, on the same warm pool, the ``adapters``
    phase's two LoRA fine-tune electrons (:func:`lora_train_arm`), whose
    results it returns beside the arms'."""
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
            await run_lora(rpc)
        finally:
            await rpc.close()
        return arms

    lora, run_lora = lora_train_arm()
    arms = asyncio.run(run_arms())
    roads = [arm["dispatch_mode"] for arm in arms]
    if roads != [road for _, road, _, _ in TRAIN_ARMS]:
        raise AssertionError(f"train: roads {roads}")
    if any(arm["frames_active"] is not True for arm in arms if arm["dispatch_mode"] == "rpc"):
        raise AssertionError(f"train: an RPC arm's channel is not on frames "
                             f"({[arm['frames_active'] for arm in arms]})")
    return arms, lora


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
    from covalent_tpu_plugin_torch.ops import _kernels

    model = TransformerLM(lm_125m_config(), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(0))
    step = train.make_train_step(model, train.adamw(model))
    batch = data.synthetic_lm_batch(BATCH, SEQ + 1, 32768, seed=0)
    step(batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # The bf16, head dim 64 step must run each tensor-core kernel once per
    # layer and no scalar kernel.  No tag is a substring of another kernel's
    # name.  A trace that lost device events the wrappers counted (see
    # ``profile_step``) is taken again from a new step.
    sweeps = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")
    for _ in range(PROFILE_STEP_TRIES):
        _kernels.reset_launch_counts()
        with torch.profiler.profile(activities=acts) as prof:
            wall = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - wall
        # Device-side events only, summed by name: CPU-side operator rows
        # carry their kernels' time too, and user annotations mirrored onto
        # the device timeline span other kernels, so either would count time
        # twice.
        by_name: dict[str, tuple[float, int]] = {}
        for evt in device_events(prof):
            us, n = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (us + evt.time_range.elapsed_us(), n + 1)
        rows = sorted(((us, key, n) for key, (us, n) in by_name.items()), reverse=True)
        launched = {tag: sum(n for _, key, n in rows if tag in key)
                    for sweep in sweeps for tag in (f"{sweep}_tc_kernel", f"{sweep}_kernel")}
        counted = _kernels.launch_counts()
        if rows and all(launched[f"{s}_tc_kernel"] + launched[f"{s}_kernel"] == counted[s]
                        for s in sweeps):
            break
    else:
        raise AssertionError(f"the profiler's trace of a training step stayed incomplete in "
                             f"{PROFILE_STEP_TRIES} steps: {len(rows)} kernel names, flash "
                             f"kernels {launched} traced against {counted} launched")
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
    """``bi_gemm``'s CUDA-core kernel (csrc/bi_gemm.cu, its skinny or wide
    tiles by ``plan_fma``) on these operands as they are, bf16 included:
    the route every serving product took before the tensor-core routes,
    timed beside them as their ``earlier_ms`` (the current CUDA-core
    kernel's time; the first one's stay in PERF.md).  Not a route of the
    port for bf16 pairs."""
    from covalent_tpu_plugin_torch.ops import _kernels

    sizes, a_strides, w_strides, c_strides = _kernels._bi_operands(a, w, out)
    _kernels.launch_fma(a, w, out, sizes, a_strides + w_strides + c_strides,
                        _kernels.plan_fma(sizes))
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
    the f32-operand route, at the lm_head with f32 features (an f32 model's)
    and at the MoE's router (f32 features, the bf16 router weight: 8
    columns, M 1, 8 and 128, the decode steps and one prompt's admission
    wave).  Each row also has the route's error against its plain version
    and the tiles it took; each tensor-core row the CUDA-core kernel's time
    on the same operands (``earlier_ms``) and its error."""
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
    router = randn(MOE_ROUTER_EXPERTS, d, scale=0.02)
    router32 = router.float()
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
        if m <= 128:
            routed = torch.empty(m, MOE_ROUTER_EXPERTS, device="cuda")
            cases[f"bi_gemm.moe_router.{tag}"] = (
                lambda x=x32: bi.linear(x, router, torch.float32),
                lambda x=x32: bi.linear_plain(x, router, torch.float32),
                {"library": lambda x=x32: F.linear(x, router32)},
                2 * m * MOE_ROUTER_EXPERTS * d, size(x32, router, routed), "float32",
                (x32, router, routed))
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
                                      SERVING_KERNEL_TAGS["bi_gemm"])
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


#: The MoE router's columns (the moe8 LM's experts).
MOE_ROUTER_EXPERTS = 8


def rows_alone(fn, wave, batches=(8, 128, 1024)) -> dict:
    """Rows of ``fn(wave[:b])`` that differ from the same row computed alone
    (``fn(wave[r:r + 1])``), for each batch ``b``: the serving contract,
    across the switch between a kernel's skinny and wide tiles."""
    import torch

    out = {}
    for b in batches:
        batch = fn(wave[:b])
        out[f"batch{b}"] = sum(not torch.equal(fn(wave[r:r + 1])[0], batch[r]) for r in range(b))
    return out


def f32_rows_alone() -> dict:
    """The f32 CUDA-core route (csrc/bi_gemm.cu) at the lm_head on f32
    features (skinny tiles at M 1 and 8, wide at 128 and 1024) and at the
    MoE's router (skinny at every M): the rows of a batch of 8, 128 and
    1024 that differ from the row alone (must be 0)."""
    import torch

    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    gen = torch.Generator(device="cuda").manual_seed(13)
    wave = torch.randn(1024, 768, generator=gen, device="cuda")
    out = {}
    for name, n in (("lm_head_f32_features", 32768), ("router", MOE_ROUTER_EXPERTS)):
        w = (torch.randn(n, 768, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        out[name] = rows_alone(lambda x, w=w: bi.linear(x, w, torch.float32), wave)
    if any(v for rows in out.values() for v in rows.values()):
        raise AssertionError(f"serving_kernels: f32 rows differ from the row alone: {out}")
    return out


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
    ``serve.stats`` record) carry the worker's launch counts (the flash
    kernels' as ``launches.*``, the serving kernels' as
    ``serving_launches.*``),
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
            engine.stats.update({f"serving_launches.{k}": n
                                 for k, n in _kernels.serving_launch_counts().items()})
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
        executor = GPUExecutor(**common, remote_cache=str(WORK / "remote"),
                               pool_preload=SERVE_PRELOAD)
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
#: The trials each arm runs of the trivial and sleep fan-outs (and of the
#: warm arms' MNIST-step one): 2 of the 3, a cut made for the
#: ``lifecycle`` phase (the lines say ``cut``).
FANOUT_TRIALS_RUN = 2
#: Trials of the launch arm's MNIST-step fan-out, cut from 3 to 1 for the
#: ``agent`` phase and the gang's pipeline, MoE and fused-loss arms, then to
#: 0 (with its single electron) for the ``lifecycle`` phase: each trial is 8
#: fresh interpreters that import torch at once (28.96-38.1 s a trial on an
#: NVIDIA H100 80GB HBM3, 700 W).  The warm arms still run it, the rpc arm
#: held against the pool_run arm's values.
LAUNCH_MNIST_TRIALS = 0
#: Config 4's models on the launch arm (a fresh interpreter each): the MLP;
#: the CNN runs on the warm arms only, a cut made for the ``lifecycle`` phase.
LAUNCH_MNIST_MODELS = ("mlp",)
#: Config 4 (``bench.py:1181-1253``): timed epochs over the 64 batches, 2 of
#: the 20 it takes in full: cuts made for the ``elastic`` phase (to 5) and
#: the ``lifecycle`` phase (to 2; the lines say ``cut``).
MNIST_EPOCHS, MNIST_EPOCHS_FULL = 2, 20
OVERHEAD_PROBES = 5
#: The launch arm's probes (each a fresh interpreter): 3 of the 5, a cut
#: made for the ``elastic`` phase (its overhead line says ``cut``).
LAUNCH_OVERHEAD_PROBES = 3
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
        probes = LAUNCH_OVERHEAD_PROBES if arm == "launch" else OVERHEAD_PROBES
        for i in range(probes):
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
                    "within_budget": _percentile(wall_overheads, 0.95) <= OVERHEAD_BUDGET_S,
                    **({"cut": f"{probes} probes of {OVERHEAD_PROBES}"}
                       if probes < OVERHEAD_PROBES else {})}

        # Config 3: fan-outs of 8 independent electrons against 8 times one.
        kinds = {"trivial": (trivial_electron, (), lambda i, v: v == i * i),
                 "busy": (busy_electron, (BUSY_S,), lambda i, v: v == i),
                 "mnist_step": (mnist_step_electron, (), lambda i, v: math.isfinite(v) and v > 0)}
        for kind, (fn, extra, ok) in kinds.items():
            if (arm, kind) == ("launch", "mnist_step") and not LAUNCH_MNIST_TRIALS:
                lines.append({"config": 3, "kind": kind, "electrons": 0,
                              "cut": f"0 trials of {FANOUT_TRIALS} on the launch arm"})
                continue
            electron = on_arm(fn)
            single = ct.lattice(lambda: electron(0, *extra))
            fan = ct.lattice(lambda n: [electron(i, *extra) for i in range(n)])
            _, single_wall = dispatch(single)
            walls, values_seen = [], []
            trials = (LAUNCH_MNIST_TRIALS if (arm, kind) == ("launch", "mnist_step")
                      else FANOUT_TRIALS_RUN)
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
        models = LAUNCH_MNIST_MODELS if arm == "launch" else ("mlp", "cnn")
        if arm == "launch":
            lines.append({"config": 4, "models": list(models),
                          "cut": "the CNN on the warm arms only"})
        for model in models:
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
                          **({"cut": f"{MNIST_EPOCHS} epochs of {MNIST_EPOCHS_FULL}"}
                             if MNIST_EPOCHS < MNIST_EPOCHS_FULL else {}),
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
        # Every value of a warm arm equals the launch arm's (pool_run's, for
        # what the launch arm cut).
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
                raise AssertionError(f"lattice {arm}: {key} {got} != an earlier arm's {want}")
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
        # the launch arm's values, and a warm arm's for what the launch arm
        # cut: a later arm is held against the earliest arm that ran each
        reference = {**values, **(reference or {})}
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
GANG_STEPS = 2
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
# ---------------------------------------------------------------------------
# The elastic phase: a checkpoint-cooperative training electron preempted
# once and resumed from its checkpoint, and a stalled electron escalated.
# ---------------------------------------------------------------------------

ELASTIC_STEPS = 12
#: Each step of the preempted run is held to this much wall time: the 125M
#: LM steps in about 75 ms, a 1.6 GB save takes 4-7 s, and the point is a
#: run whose checkpoints land between its steps (a real run's interval
#: spans many steps), with a checkpoint of step >= 4 recorded well before
#: the 12th step.  The twin runs unpaced: the losses cannot depend on it.
ELASTIC_PACE_S = 2.0
ELASTIC_INTERVAL_S = 2.0
#: The preemption is armed by a recorded checkpoint of at least this step.
ELASTIC_MIN_STEP = 4
#: Seconds between the SIGTERM notice and the channel's loss: room for the
#: electron's final save of the whole train state.
ELASTIC_GRACE_S = 20.0
ELASTIC_LOSS_TOL = 1e-4
STALL_INTERVAL_S = 1.0
STALL_THRESHOLD_S = 4.0
#: The stalled electron's allocation on the card, MiB.
STALL_ALLOC_MIB = 1024


def elastic_train_electron(steps: int, pace_s: float, batch: int, seq: int, seed: int = 0,
                           device: str = "cuda", config: dict | None = None,
                           progress: str | None = None) -> dict:
    """A user's checkpoint-cooperative training electron: the 125M LM (or
    ``config``'s overrides), AdamW, ``steps`` steps of the synthetic stream.

    It restores from ``utils.checkpoint.resume_state()`` when the retry
    shipped a bundle (the weights from the generator first, then the
    checkpoint over them), and registers a snapshot hook that returns host
    copies taken at a step boundary: under the lock every step holds, and
    on the main thread (the SIGTERM handler) only when the lock is free at
    once, else the last copy.  It lets a step finish before the
    preemption notice: a SIGTERM that lands inside a step runs the
    harness's handler (a final snapshot, then death) right after it, so
    that snapshot is of the step just taken.  Its progress (step and
    launches) goes to the heartbeat's metrics file, and each step it takes
    is appended to ``progress`` (every attempt's).
    """
    import signal as signal_mod
    import threading

    import torch

    from covalent_tpu_plugin_torch.models import train as tr
    from covalent_tpu_plugin_torch.models.data import synthetic_lm_batches
    from covalent_tpu_plugin_torch.models.transformer import TransformerLM, lm_125m_config
    from covalent_tpu_plugin_torch.ops import _kernels
    from covalent_tpu_plugin_torch.utils import checkpoint as ckpt

    dev = torch.device(device)
    cfg = lm_125m_config(**(config or {}))
    model = TransformerLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    optimizer = tr.adamw(model)
    step_fn = tr.make_train_step(model, optimizer)
    batches = list(synthetic_lm_batches(steps=steps, batch_size=batch, seq_len=seq + 1,
                                        vocab_size=cfg.vocab_size, seed=seed))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda *a: None)
    base = _kernels.launch_counts()

    def launched() -> dict:
        return {name: n - base.get(name, 0) for name, n in _kernels.launch_counts().items()}

    losses: dict = {}
    earlier: dict = {}  # the launches of the attempts before, up to the checkpoint
    start, restore_s, resumed_step = 0, None, None
    t0 = time.perf_counter()
    resumed = ckpt.resume_state()
    if resumed is not None:
        resumed_step, tree = resumed
        model.load_state_dict(tree["model"])
        optimizer.load_state_dict(tree["optimizer"])
        losses.update(tree["losses"])
        earlier = tree["launches"]
        start = resumed_step + 1
        sync(dev)
        restore_s = time.perf_counter() - t0

    lock = threading.Lock()
    done = {"step": start - 1}
    latest: dict = {"snap": None}

    def snapshot():
        if threading.current_thread() is threading.main_thread():
            if not lock.acquire(blocking=False):
                return latest["snap"]  # a step is in flight under the handler
        else:
            lock.acquire()
        try:
            if done["step"] < 0:
                return None
            if latest["snap"] is None or latest["snap"][1] != done["step"]:
                sync(dev)
                mine = launched()
                tree = {"model": ckpt.host_tree(model.state_dict()),
                        "optimizer": ckpt.host_tree(optimizer.state_dict()),
                        "losses": dict(losses),
                        "launches": {k: earlier.get(k, 0) + mine[k] for k in mine}}
                latest["snap"] = (tree, done["step"])
            return latest["snap"]
        finally:
            lock.release()

    notice = signal_mod.getsignal(signal_mod.SIGTERM)  # the harness's, with checkpoints on
    in_step, pending = [False], []

    def after_the_step(signum, frame):
        if in_step[0]:
            pending.append(signum)
        else:
            notice(signum, frame)

    if callable(notice):
        signal_mod.signal(signal_mod.SIGTERM, after_the_step)
    metrics = os.environ.get("COVALENT_TPU_WORKER_METRICS_PATH")
    ckpt.register_snapshot(snapshot)
    try:
        for i in range(start, steps):
            began = time.perf_counter()
            with lock:
                in_step[0] = True
                losses[i] = float(step_fn(batches[i])["loss"])
                done["step"] = i
                in_step[0] = False
            if pending:
                notice(signal_mod.SIGTERM, None)
            if progress:
                with open(progress, "a") as f:
                    f.write(f"{i}\n")
            if metrics:
                with open(f"{metrics}.tmp", "w") as f:
                    json.dump({"step": i, "launches": launched()}, f)
                os.replace(f"{metrics}.tmp", metrics)
            rest = pace_s - (time.perf_counter() - began)
            if rest > 0:
                time.sleep(rest)
    finally:
        ckpt.unregister_snapshot()
        if callable(notice):
            signal_mod.signal(signal_mod.SIGTERM, notice)
    return {"losses": [losses[i] for i in range(steps)], "start": start,
            "resumed_step": resumed_step, "restore_s": restore_s, "pid": os.getpid(),
            "launches": launched(), "earlier_launches": earlier,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}


def _compute_apps() -> list:
    """``[pid, used MiB]`` of each process that holds the card, as
    ``nvidia-smi`` sees it (its pids may be another namespace's)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60).stdout
    return [[int(x) if x.strip().isdigit() else x.strip() for x in row.split(",")]
            for row in out.splitlines() if row.strip()]


def stall_electron(marker: str, alloc_mib: int, device: str = "cuda") -> dict:
    """Attempt 1 (no marker yet): allocate on the card, record the card's
    processes then (its own row among them) in the marker, beat a few
    times, then SIGSTOP its own process group.  Attempt 2: the card's
    processes at its start, before it touches the card itself."""
    import signal as signal_mod

    import torch

    apps_at_start = _compute_apps() if device == "cuda" else []
    block = torch.empty(alloc_mib << 20, dtype=torch.uint8, device=device)
    block.fill_(1)
    if device == "cuda":
        torch.cuda.synchronize()
    if not os.path.exists(marker):
        with open(marker, "w") as f:
            json.dump({"pid": os.getpid(),
                       "apps": _compute_apps() if device == "cuda" else []}, f)
        time.sleep(3 * STALL_INTERVAL_S)
        os.killpg(os.getpgid(0), signal_mod.SIGSTOP)
    with open(marker) as f:
        first = json.load(f)
    return {"pid": os.getpid(), "first": first, "apps_at_start": apps_at_start}


def _elastic_executor(name: str, **kwargs):
    from covalent_tpu_plugin_torch import GPUExecutor

    work = WORK / "elastic" / name
    return GPUExecutor(transport="local", use_agent=False, cache_dir=str(work / "cache"),
                       remote_cache=str(work / "remote"), remote_workdir=str(work / "work"),
                       python_path=sys.executable, poll_freq=0.5, task_timeout=600,
                       task_env={"PYTHONPATH": str(ROOT)}, **kwargs)


class _Events:
    """The dispatcher's events of one arm, by type."""

    def __init__(self):
        self.events: list = []

    def __enter__(self):
        from covalent_tpu_plugin_torch.obs import events as obs_events

        obs_events.add_listener(self.events.append)
        return self

    def __exit__(self, *exc):
        from covalent_tpu_plugin_torch.obs import events as obs_events

        obs_events.remove_listener(self.events.append)

    def of(self, kind: str) -> list:
        return [e for e in self.events if e.get("type") == kind]


def _no_fallback(events: _Events, arm: str) -> None:
    bad = events.of("task.dispatch_failed") + [
        e for e in events.of("task.state") if e.get("state") == "fallback_local"]
    if bad:
        raise AssertionError(f"elastic {arm}: a dispatch fell back: {bad}")


class _PreemptAfterCheckpoint:
    """Arms a plan's one preemption once the dispatcher records a
    checkpoint of ``lineage`` at ``min_step`` or later: the plan starts
    with ``preempt_after`` 0 (no preemption), and the
    ``worker.checkpoint_saved`` event raises it to 1, so the SIGTERM lands
    on the channel's next op.  A count of ops alone would race the first
    save."""

    def __init__(self, plan, lineage: str, min_step: int):
        self.plan, self.lineage, self.min_step = plan, lineage, min_step
        self.step = None

    def __call__(self, event: dict) -> None:
        step = event.get("step")
        if (self.step is None and event.get("type") == "worker.checkpoint_saved"
                and event.get("lineage") == self.lineage and isinstance(step, int)
                and step >= self.min_step):
            self.step = step
            self.plan.preempt_after = 1

    def __enter__(self):
        from covalent_tpu_plugin_torch.obs import events as obs_events

        obs_events.add_listener(self)
        return self

    def __exit__(self, *exc):
        from covalent_tpu_plugin_torch.obs import events as obs_events

        obs_events.remove_listener(self)


def _beat_gaps(beats: list) -> dict:
    """The longest gap between two consecutive beats of each attempt, on
    the worker's clock (``worker_ts``)."""
    times: dict = {}
    for beat in beats:
        if isinstance(beat.get("attempt"), int) and isinstance(beat.get("worker_ts"), float):
            times.setdefault(beat["attempt"], []).append(beat["worker_ts"])
    return {f"attempt{attempt + 1}": max((b - a for a, b in zip(ts, ts[1:])), default=None)
            for attempt, ts in sorted(times.items())}


def elastic_preempt(device: str = "cuda", steps: int = ELASTIC_STEPS,
                    pace_s: float = ELASTIC_PACE_S, batch: int = BATCH, seq: int = SEQ,
                    config: dict | None = None) -> dict:
    """The ``preempt`` arm: the electron through a chaos plan that preempts
    it once, armed by a recorded checkpoint of step >= ELASTIC_MIN_STEP,
    with two retries, and beside it, on the card at the same time, the same
    electron uninterrupted and unpaced (the twin: it runs while the paced
    run sleeps between its steps).  Beats every second under the default
    stall threshold (three beats): each 1.6 GB save and the restore are
    announced, and hold the stall clock."""
    from covalent_tpu_plugin_torch.transport import ChaosPlan

    plan = ChaosPlan(preempt_grace=ELASTIC_GRACE_S, max_faults=1)
    executor = _elastic_executor("preempt", heartbeat_interval=1.0,
                                 checkpoint_interval_s=ELASTIC_INTERVAL_S, checkpoint_keep_n=2,
                                 max_task_retries=2, retry_base_delay=0.1, retry_max_delay=0.5,
                                 chaos=plan)
    progress = WORK / "elastic" / "progress.txt"
    progress.parent.mkdir(parents=True, exist_ok=True)
    progress.unlink(missing_ok=True)
    kwargs = dict(steps=steps, pace_s=pace_s, batch=batch, seq=seq, device=device, config=config,
                  progress=str(progress))

    twin_executor = _elastic_executor("twin")

    async def run():
        wall = time.perf_counter()
        out = await executor.run(elastic_train_electron, [], kwargs,
                                 {"dispatch_id": "elastic", "node_id": 0})
        return out, time.perf_counter() - wall, executor.last_attempts

    async def both():
        try:
            return await asyncio.gather(run(), twin_executor.run(
                elastic_train_electron, [], {**kwargs, "pace_s": 0.0, "progress": None},
                {"dispatch_id": "elastic_twin", "node_id": 0}))
        finally:
            await executor.close()
            await twin_executor.close()

    with _Events() as events, _PreemptAfterCheckpoint(plan, "elastic_0",
                                                       ELASTIC_MIN_STEP) as arm:
        (out, wall, attempts), twin_out = asyncio.run(both())
    _no_fallback(events, "preempt")
    retries = [e.get("reason") for e in events.of("task.retry")]
    saves = [{k: e.get(k) for k in ("step", "bytes", "save_s", "trigger", "attempt")}
             for e in events.of("worker.checkpoint_saved")]
    errors = events.of("worker.checkpoint_error")
    resumed = events.of("task.resumed")
    all_beats = events.of("worker.heartbeat")  # the twin neither beats nor saves
    beats = [e for e in all_beats if e.get("attempt") == 0]
    first_beat = (beats[-1].get("metrics") or {}) if beats else {}
    gaps = [abs(a - b) for a, b in zip(out["losses"], twin_out["losses"])]
    executed = [int(x) for x in progress.read_text().split()]
    line = {
        "arm": "preempt", "attempts": attempts, "retry_reasons": retries,
        "faults_injected": plan.faults_injected, "armed_by_step": arm.step,
        "saves": saves, "checkpoint_errors": errors,
        "resumed_step": out["resumed_step"], "restore_s": out["restore_s"],
        "resumed_digest": resumed[0].get("digest") if resumed else None,
        "steps_executed": executed, "steps_recomputed": len(executed) - len(set(executed)),
        "steps_per_interval": ELASTIC_INTERVAL_S / pace_s,
        "losses": out["losses"], "twin_losses": twin_out["losses"],
        "max_loss_gap_twin": max(gaps),
        "losses_bit_equal_twin": out["losses"] == twin_out["losses"],
        "launches": {"attempt1_to_checkpoint": out["earlier_launches"],
                     "attempt1_last_beat": first_beat.get("launches"),
                     "attempt2": out["launches"], "twin": twin_out["launches"]},
        "stall_after_s": executor._stall_after(), "longest_beat_gap_s": _beat_gaps(all_beats),
        "holds": {kind: len(events.of(kind))
                  for kind in ("worker.checkpoint_started", "worker.restore_started")},
        "wall_s": wall, "pace_s": pace_s, "interval_s": ELASTIC_INTERVAL_S,
        "grace_s": ELASTIC_GRACE_S, "device": out["device"],
    }
    if attempts != 2 or retries != ["worker_preempted"] or plan.faults_injected != 1:
        raise AssertionError(f"elastic preempt: attempts {attempts}, retries {retries}, "
                             f"faults {plan.faults_injected}")
    if errors:
        raise AssertionError(f"elastic preempt: checkpoint errors {errors}")
    if not line["holds"]["worker.checkpoint_started"] or line["holds"][
            "worker.restore_started"] != 1:
        raise AssertionError(f"elastic preempt: saves and the restore must be announced "
                             f"({line['holds']})")
    if not resumed or out["resumed_step"] is None or out["resumed_step"] < ELASTIC_MIN_STEP:
        raise AssertionError(f"elastic preempt: resumed from {out['resumed_step']} "
                             f"({resumed})")
    if resumed[0].get("step") != out["resumed_step"]:
        raise AssertionError(f"elastic preempt: the electron restored step "
                             f"{out['resumed_step']}, the dispatcher planned {resumed[0]}")
    if line["steps_recomputed"] >= line["steps_per_interval"]:
        raise AssertionError(f"elastic preempt: {line['steps_recomputed']} steps recomputed, "
                             f"an interval holds {line['steps_per_interval']}")
    if max(gaps) > ELASTIC_LOSS_TOL:
        raise AssertionError(f"elastic preempt: losses {out['losses']} differ from the twin's "
                             f"{twin_out['losses']} by {max(gaps)}")
    for name in FLASH_KERNEL_TAGS:
        if device == "cuda" and not (out["earlier_launches"].get(name, 0) > 0
                                     and out["launches"].get(name, 0) > 0):
            raise AssertionError(f"elastic preempt: {name} not launched in both attempts "
                                 f"({line['launches']})")
    return line


def _settled_apps(before: list | None, timeout_s: float = 60.0) -> list:
    """The card's processes once those of the arms before have left it (no
    more rows than ``before``, bounded by ``timeout_s``): a harness frees
    its context a moment after its result is read."""
    deadline = time.monotonic() + timeout_s
    apps = _compute_apps()
    while before is not None and len(apps) > len(before) and time.monotonic() < deadline:
        time.sleep(0.5)
        apps = _compute_apps()
    return apps


def elastic_stall(device: str = "cuda", alloc_mib: int = STALL_ALLOC_MIB,
                  before: list | None = None) -> dict:
    """The ``stall`` arm: an electron that stops itself on attempt 1 is
    found stalled, escalated (0 survivors) and retried; attempt 2 lists the
    card's compute processes at its start, where attempt 1's must be gone.
    ``before``: the card's processes before the phase (the baseline the
    earlier arms' processes must leave first)."""
    marker = WORK / "elastic" / "stall_marker"
    marker.parent.mkdir(parents=True, exist_ok=True)
    marker.unlink(missing_ok=True)
    baseline = _settled_apps(before) if device == "cuda" else []
    executor = _elastic_executor("stall", heartbeat_interval=STALL_INTERVAL_S,
                                 stall_threshold=STALL_THRESHOLD_S, max_task_retries=1,
                                 retry_base_delay=0.1, retry_max_delay=0.5)

    async def run():
        try:
            wall = time.perf_counter()
            out = await executor.run(stall_electron, [str(marker), alloc_mib, device], {},
                                     {"dispatch_id": "elastic_stall", "node_id": 0})
            return out, time.perf_counter() - wall, executor.last_attempts
        finally:
            await executor.close()

    with _Events() as events:
        out, wall, attempts = asyncio.run(run())
    _no_fallback(events, "stall")
    retries = [e.get("reason") for e in events.of("task.retry")]
    escalated = events.of("task.escalated")
    failed = [e for e in events.of("task.failed") if e.get("status") == "STALLED"]
    stall_s = None
    if failed and failed[0].get("last_heartbeats"):
        stall_s = max(v.get("age_s", 0.0) for v in failed[0]["last_heartbeats"].values())
    # Inside a container nvidia-smi may report another PID namespace's pids
    # (every row pid 1): count rows.  Attempt 1 added its rows to the
    # baseline's; none may be left when attempt 2 starts.
    first_rows = len(out["first"]["apps"]) - len(baseline)
    left = len(out["apps_at_start"]) - len(baseline)
    line = {"arm": "stall", "attempts": attempts, "retry_reasons": retries,
            "silence_at_detection_s": stall_s, "stall_threshold_s": STALL_THRESHOLD_S,
            "escalation": [{k: e.get(k) for k in ("reason", "survivors", "seconds", "stopped")}
                           for e in escalated],
            "attempt1_pid": out["first"]["pid"], "attempt2_pid": out["pid"],
            "compute_apps": {"before": baseline, "attempt1": out["first"]["apps"],
                             "attempt2_start": out["apps_at_start"]},
            "attempt1_rows": first_rows, "attempt1_rows_left_at_attempt2": left,
            "alloc_mib": alloc_mib, "wall_s": wall}
    if attempts != 2 or retries != ["worker_stalled"]:
        raise AssertionError(f"elastic stall: attempts {attempts}, retries {retries}")
    if len(escalated) != 1 or escalated[0].get("survivors") != 0:
        raise AssertionError(f"elastic stall: escalation {escalated}")
    if device == "cuda" and (first_rows < 1 or left > 0):
        raise AssertionError(f"elastic stall: attempt 1 added {first_rows} process(es) to the "
                             f"card's {baseline}, and {left} still hold it when attempt 2 "
                             f"starts: {out['apps_at_start']}")
    return line


SSH_MARKER = "COVALENT_SSH_SMOKE_MARKER"
SSH_USER = "smoke"
#: A second login the server authorizes (the same key): a third worker
#: address of the one server, for the ``lifecycle`` phase's gang of three.
SSH_USER_2 = "smoke2"
SSH_PROBES = 5
SSH_STEPS = 5
#: The gang over two SSH addresses: 2 of the 5 steps, as the ``gang``
#: phase's LM arms (a cut made for the ``lifecycle`` phase; its line says
#: ``cut``).
SSH_GANG_STEPS = 2
#: The server, in an interpreter of its own (never the dispatcher's event
#: loop, which a synchronous wait would starve): the port's minissh on
#: 127.0.0.1, an ed25519 host key, one authorized client key for each login
#: of the comma-separated list; it prints its port and serves until its
#: stdin closes.
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
                                 authorized_keys={u: [client] for u in user.split(",")})
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


#: The ``cache`` arm's training electrons: the train cell at 2 steps.
CACHE_STEPS = 2


def cache_probe_electron(i: int) -> dict:
    """A cheap electron whose two roads' cache keys are compared: its
    argument and the process it ran in."""
    import os

    return {"i": i, "pid": os.getpid()}


def launch_counts_electron(nonce: str) -> dict:
    """The resident worker's flash launches so far (RPC electrons share its
    process, so the counts only grow); ``nonce`` makes every call a cache
    miss."""
    from covalent_tpu_plugin_torch.ops import _kernels

    return dict(_kernels.launch_counts())


async def _cache_arm(pool, check) -> tuple[dict, dict]:
    """Result memoization on the warm minissh pool (``cache_results``): the
    train cell's electron by RPC (2 steps, seed 0) misses and runs, the
    same call hits, seed 1 misses; on the launch road seed 0 misses (the
    RPC road's entry is not its) and then hits.  The RPC road does not
    take a launch road's entry either (a cheap electron: launch, RPC, RPC,
    launch).  A call's flash launches are read from the pool server before
    and after it (RPC), or from its worker (launch): every kernel on each
    miss, none on a hit.  Returns the line and the misses' launches."""
    from covalent_tpu_plugin_torch.cache import ResultCache
    from covalent_tpu_plugin_torch.obs import events as obs_events
    from covalent_tpu_plugin_torch.ops import _kernels

    # From here on the pool memoises: the probes above measured the road
    # without the cache.
    pool.cache_results = True
    pool._result_cache = ResultCache(os.path.join(pool.cache_dir, "results"))
    pool._result_cache.clear()
    seen: list = []
    obs_events.add_listener(seen.append)

    async def server_counts() -> dict:
        return await pool.run(launch_counts_electron, [os.urandom(8).hex()], {},
                              {"dispatch_id": "ssh_cache", "node_id": 99,
                               "dispatch_mode": "rpc"})

    async def call(fn, args, mode, node) -> dict:
        before = await server_counts() if mode == "rpc" else None
        mark, local = len(seen), dict(_kernels.launch_counts())
        wall = time.perf_counter()
        out = await pool.run(fn, args, {}, {"dispatch_id": "ssh_cache", "node_id": node,
                                            "dispatch_mode": mode})
        wall = time.perf_counter() - wall
        timings = dict(pool.last_timings)
        new = seen[mark:]
        spans = lambda name: [e["duration_s"] for e in new  # noqa: E731
                              if e.get("type") == "span" and e.get("name") == name]
        cached = any(e.get("type") == "task.result_cached" for e in new)
        row = {"road": mode, "cached": cached, "wall_s": wall,
               "cache_lookup_s": spans("executor.cache_lookup"),
               "connect_spans": len(spans("executor.connect")), "timings": timings}
        if fn is ssh_train_electron:
            after = await server_counts() if mode == "rpc" else None
            here = {k: n - local.get(k, 0) for k, n in _kernels.launch_counts().items()}
            # a miss on the RPC road ran in the pool server; one on the
            # launch road in a fork that reports its own counts; a hit ran
            # nowhere but here
            row["launches"] = {k: here[k] + (after[k] - before[k] if mode == "rpc" else
                                             (0 if cached else out["launches"][k]))
                               for k in here}
            row["losses"], row["seed"] = out["losses"], args[0]["seed"]
            if not cached:
                check("cache", out, pool, mode)
        else:
            row["value"] = out
        return row

    try:
        lm = lambda seed: [dict(steps=CACHE_STEPS, batch_size=BATCH, seq_len=SEQ,  # noqa: E731
                                seed=seed)]
        calls = [await call(ssh_train_electron, lm(0), "rpc", 20),
                 await call(ssh_train_electron, lm(0), "rpc", 21),
                 await call(ssh_train_electron, lm(1), "rpc", 22),
                 await call(ssh_train_electron, lm(0), "launch", 23),
                 await call(ssh_train_electron, lm(0), "launch", 24)]
        reverse = [await call(cache_probe_electron, [7], mode, 30 + i)
                   for i, mode in enumerate(("launch", "rpc", "rpc", "launch"))]
    finally:
        obs_events.remove_listener(seen.append)
    problems = []
    if [c["cached"] for c in calls] != [False, True, False, False, True]:
        problems.append(f"hits {[c['cached'] for c in calls]}, expected miss, hit, miss, "
                        "miss, hit")
    if [c["cached"] for c in reverse] != [False, False, True, True]:
        problems.append(f"the roads' keys: hits {[c['cached'] for c in reverse]} for launch, "
                        "rpc, rpc, launch; expected miss, miss, hit, hit")
    for c in calls:
        if c["cached"] and (any(c["launches"].values()) or c["connect_spans"]):
            problems.append(f"a hit launched {c['launches']} or dialed ({c['connect_spans']})")
        if FLASH_KERNEL_TAGS and not c["cached"] and min(c["launches"].values()) < 1:
            problems.append(f"a miss on the {c['road']} road launched {c['launches']}")
        if not c["cache_lookup_s"]:
            problems.append("a call without its executor.cache_lookup span")
    if calls[1]["losses"] != calls[0]["losses"] or calls[4]["losses"] != calls[3]["losses"]:
        problems.append("a hit's losses differ from its miss's")
    gap = max(abs(a - b) for a, b in zip(calls[3]["losses"], calls[0]["losses"]))
    if gap > TRAIN_LOSS_TOL or calls[2]["losses"] == calls[0]["losses"]:
        problems.append(f"losses: launch road {calls[3]['losses']}, rpc {calls[0]['losses']}, "
                        f"seed 1 {calls[2]['losses']}")
    if problems:
        raise AssertionError("ssh cache: " + "; ".join(problems))
    misses = [c for c in calls if not c["cached"]]
    hits = [c for c in calls if c["cached"]]
    launches = {k: sum(c["launches"][k] for c in misses) for k in misses[0]["launches"]}
    line = {
        "arm": "cache", "steps": CACHE_STEPS, "calls": calls, "reverse": reverse,
        "hit_wall_s": [c["wall_s"] for c in hits], "miss_wall_s": [c["wall_s"] for c in misses],
        "hit_cache_lookup_s": [c["cache_lookup_s"] for c in hits],
        "miss_launches": [c["launches"] for c in misses],
        "hit_launches": [c["launches"] for c in hits],
        "hit_losses_bit_equal_miss": True, "launch_vs_rpc_max_loss_gap": gap,
        "launch_vs_rpc_losses_bit_equal": calls[3]["losses"] == calls[0]["losses"],
        "result_cache_entries": len(pool._result_cache), "marker_ok": True}
    return line, launches


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
            [sys.executable, "-c", SSH_SERVER, str(root), str(ROOT),
             f"{SSH_USER},{SSH_USER_2}"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=str(root),
            env={**os.environ, SSH_MARKER: self.marker})
        line = self.proc.stdout.readline().strip()
        if not line.isdigit():
            self.close()
            raise AssertionError(f"ssh: the minissh server did not start ({line!r})")
        self.port = int(line)

    def address(self, host: str = "127.0.0.1", user: str = SSH_USER) -> str:
        return f"{user}@{host}:{self.port}"

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


def ssh_phase(train_losses: list) -> tuple[list[dict], dict, dict]:
    """The paper's road over a real SSH channel (BASELINE config 1, the warm
    pool, the 125M LM's electron by RPC, the result cache on that pool, a
    two-worker FSDP gang whose workers are two SSH addresses), every
    executor on the minissh backend with the server's host key pinned.
    Returns the phase's lines, the flash launches of its LM arms and those
    of the ``cache`` arm's misses."""
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
                 "stack": stack}], {}, {}

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

    def lm_check(arm: str, losses: list, per_rank: list, shape: str | None,
                 steps: int = SSH_STEPS) -> float:
        if len(losses) != steps or not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"ssh {arm}: losses {losses}")
        gap = max(abs(a - b) for a, b in zip(losses, train_losses))
        if gap > TRAIN_LOSS_TOL:
            raise AssertionError(f"ssh {arm}: losses {losses} are {gap} from the train "
                                 f"phase's {train_losses}")
        for rank in per_rank:
            for name, n in rank["launches"].items():
                if n != 12 * steps:
                    raise AssertionError(f"ssh {arm}: {name} launched {n} times, "
                                         f"expected {12 * steps}")
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
            "advertised_codecs": advertised,
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
                    roads[road] = {**_overheads(timings), "breakdown": timings[-1]}
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
                cache = await _cache_arm(pool, check)
                return first, start, roads, frames, trained, cache
            finally:
                await pool.close()

        first, start, roads, frames, trained, (cache_line, cache_launches) = \
            asyncio.run(pool_arms())
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
        lines.append(cache_line)

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
                    [dict(steps=SSH_GANG_STEPS, batch_size=BATCH, seq_len=SEQ, seed=0,
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
        gap = lm_check("gang", out["losses"], out["ranks"], shape, SSH_GANG_STEPS)
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
                      "note": GANG_NOTE, "steps": SSH_GANG_STEPS,
                      "cut": f"{SSH_GANG_STEPS} steps of {SSH_STEPS}"})
    finally:
        obs_events.remove_listener(seen.append)
        server.close()
    return lines, launches, cache_launches


# --- the gang's lifecycle, the CAS's budget and serving over SSH -------------

#: The prewarm arm's upstream node: this long on the dispatcher, while the
#: downstream node's executor may dial its worker.
PREWARM_UPSTREAM_S = 2.5
#: The straggler arm: the gang's last rank leaves this long after the
#: others, against this budget.
STRAGGLER_DELAY_S = 3.0
STRAGGLER_BUDGET_S = 1.0
#: The cas arm's electrons, one bundle each: the weights of one block of
#: the 125M LM (attention and MLP, bf16) drawn from these seeds.  A block,
#: not the 50 MB token embedding: minissh moves 6.5-7.2 MB/s on loopback on
#: the H100's host, so three embeddings took 22 s.
CAS_SEEDS = (0, 1, 2)


def ssh_after_electron(x: int) -> dict:
    """The prewarm arm's downstream node: config 1's electron after its
    upstream's value."""
    return {**ssh_where_electron(), "after": x}


def late_rank_electron(delay: float, barrier: str) -> int:
    """A gang electron whose last rank leaves ``delay`` seconds after the
    others (the harness exports the rank before the electron runs).  Every
    rank first waits until all ranks have entered the electron (a file each
    in ``barrier``), so the ranks' start-up, which differs under load, does
    not order their exits: the early ranks leave together, only the last
    one waits."""
    import os
    import time

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    open(os.path.join(barrier, f"in.{rank}"), "w").close()
    deadline = time.monotonic() + 120.0
    while len(os.listdir(barrier)) < world:
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank {rank}: the gang never gathered in {barrier}")
        time.sleep(0.01)
    if rank == world - 1:
        time.sleep(delay)
    return rank


def cas_bundle_electron(blob: bytes) -> dict:
    """The cas arm's electron: what it was given, by size and digest."""
    import hashlib

    return {"bytes": len(blob), "sha256": hashlib.sha256(blob).hexdigest()}


def lm_block_bundle(seed: int) -> bytes:
    """One block of the 125M LM (its four attention projections, the MLP's
    two products and two norms) drawn from ``seed``, bf16, as bytes."""
    import torch

    from covalent_tpu_plugin_torch.models.transformer import lm_125m_config

    config = lm_125m_config()
    d, ff = config.d_model, config.d_ff
    weights = torch.randn(4 * d * d + 2 * d * ff + 2 * d,
                          generator=torch.Generator().manual_seed(seed)).to(torch.bfloat16)
    return weights.view(torch.int16).numpy().tobytes()


def _metric(name: str, **labels) -> float:
    from covalent_tpu_plugin_torch.obs.metrics import REGISTRY

    family = REGISTRY.get(name)
    if family is None:
        return 0.0
    child = family.labels(**labels)
    # a histogram's sum of observations, a counter's value
    return child.sum if hasattr(child, "sum") else child.value


def _on_dispatcher(coro):
    """Run ``coro`` on the workflow runner's loop, where the lattices' executors live."""
    from covalent_tpu_plugin_torch.workflow import runner

    return asyncio.run_coroutine_threadsafe(coro, runner._dispatcher_loop()).result(600)


def _prewarm_arm(executor) -> list[dict]:
    """A two-node lattice whose downstream node runs over minissh and waits
    on a ``PREWARM_UPSTREAM_S`` upstream node on the dispatcher: the
    downstream node's ``connect`` with ``prewarm`` on (dialed while it
    waited) and off (dialed on its own critical path).  Then
    ``teardown_gang`` on the warm executor: refused while an electron is in
    flight, done after; the next electron dials afresh."""
    import covalent_tpu_plugin_torch.workflow as ct
    from covalent_tpu_plugin_torch.obs import events as obs_events

    seen: list = []
    obs_events.add_listener(seen.append)
    lines, warm = [], None
    try:
        for prewarm in (True, False):
            ex = executor(f"prewarm_{'on' if prewarm else 'off'}", use_agent="pool",
                          pool_preload="cloudpickle", prewarm=prewarm)
            upstream = ct.electron(busy_electron)
            downstream = ct.electron(ssh_after_electron, executor=ex)
            flow = ct.lattice(lambda: downstream(upstream(1, PREWARM_UPSTREAM_S)))
            mark = len(seen)
            seconds_before = _metric("covalent_tpu_prewarm_seconds", pool="")
            out, wall = _dispatch(ct, flow)
            timings = dict(ex.last_timings)
            new = seen[mark:]
            spans = [e["duration_s"] for e in new
                     if e.get("type") == "span" and e.get("name") == "executor.prewarm"]
            prewarm_seconds = _metric("covalent_tpu_prewarm_seconds", pool="")
            line = {"arm": "prewarm", "prewarm": prewarm, "upstream_s": PREWARM_UPSTREAM_S,
                    "lattice_wall_s": wall, "downstream_connect_s": timings.get("connect"),
                    "downstream_preflight_s": timings.get("preflight"),
                    "downstream_wall_overhead_s": timings.get("wall_overhead"),
                    "downstream_breakdown": timings, "executor_prewarm_span_s": spans,
                    "prewarm_seconds_observed": prewarm_seconds - seconds_before,
                    "prewarmed": [e for e in new if e.get("type") == "executor.prewarm"],
                    "prewarm_failed": [e for e in new
                                       if e.get("type") == "executor.prewarm_failed"]}
            if out["after"] != 1 or (len(spans) != 1) is prewarm or line["prewarm_failed"]:
                raise AssertionError(f"lifecycle prewarm={prewarm}: {line}")
            lines.append(line)
            if prewarm:
                warm = ex
            else:
                _close(ex)
        on, off = lines
        if not on["downstream_connect_s"] < off["downstream_connect_s"]:
            raise AssertionError(f"lifecycle prewarm: connect {on['downstream_connect_s']} s "
                                 f"with prewarm, {off['downstream_connect_s']} s without")

        async def teardown():
            misses = _metric("covalent_tpu_pool_acquires_total", result="miss")
            task = asyncio.ensure_future(warm.run(busy_electron, [2, 3.0], {},
                                                  {"dispatch_id": "teardown", "node_id": 0}))
            while not warm._pids:
                await asyncio.sleep(0.02)
            during = await warm.teardown_gang()
            await task
            after = await warm.teardown_gang()
            cold = (warm.is_warm, dict(warm._agents))
            await warm.run(trivial_electron, [3], {}, {"dispatch_id": "teardown", "node_id": 1})
            return (during, after, cold, dict(warm.last_timings),
                    _metric("covalent_tpu_pool_acquires_total", result="miss") - misses)

        during, after, cold, timings, dialed = _on_dispatcher(teardown())
        torn = [e for e in seen if e.get("type") == "executor.gang_teardown"]
        line = {"arm": "teardown", "in_flight_refused": during is False, "after": after,
                "is_warm_after": cold[0], "agents_after": len(cold[1]),
                "next_connect_s": timings.get("connect"), "next_breakdown": timings,
                "fresh_dials": dialed, "gang_teardown_events": len(torn)}
        if during is not False or after is not True or cold[0] or cold[1] or dialed != 1:
            raise AssertionError(f"lifecycle teardown: {line}")
        lines.append(line)
    finally:
        obs_events.remove_listener(seen.append)
        if warm is not None:
            _close(warm)
    return lines


def _straggler_arm(executor, server) -> dict:
    """A gang of three over three SSH addresses of the one server whose
    last rank leaves ``STRAGGLER_DELAY_S`` after the others, under a budget
    of ``STRAGGLER_BUDGET_S`` and ``COVALENT_TPU_STRAGGLER_REDIAL``: the
    flagged worker and its differential, its channel dropped and dialed
    afresh by the next electron (which runs with the detection off: it
    only counts the dials); then ``health_canary`` on a live pool server
    and on one killed.  The ranks gather on a barrier before they leave,
    so no exit order comes from the machine's load.  (A gang of two is
    never flagged: the median of an even gang is its upper middle, the
    reference's rule.)"""
    import shutil

    from covalent_tpu_plugin_torch.fleet.health import HEALTH
    from covalent_tpu_plugin_torch.obs import events as obs_events

    workers = [server.address("127.0.0.1"), server.address("localhost"),
               server.address("127.0.0.1", SSH_USER_2)]
    ex = executor("straggler", workers=workers, coordinator_port=0, use_agent="pool",
                  pool_preload="cloudpickle")
    saved = {k: os.environ.get(k) for k in ("COVALENT_TPU_STRAGGLER_BUDGET_S",
                                            "COVALENT_TPU_STRAGGLER_REDIAL")}
    os.environ["COVALENT_TPU_STRAGGLER_BUDGET_S"] = str(STRAGGLER_BUDGET_S)
    os.environ["COVALENT_TPU_STRAGGLER_REDIAL"] = "1"
    barriers = [WORK / "lifecycle" / f"barrier{i}" for i in range(2)]
    for barrier in barriers:
        shutil.rmtree(barrier, ignore_errors=True)
        barrier.mkdir(parents=True)
    seen: list = []
    obs_events.add_listener(seen.append)

    async def run():
        try:
            wall = time.perf_counter()
            first = await ex.run(late_rank_electron, [STRAGGLER_DELAY_S, str(barriers[0])], {},
                                 {"dispatch_id": "straggler", "node_id": 0})
            wall = time.perf_counter() - wall
            await asyncio.gather(*list(ex._cleanup_tasks))
            dropped = ex._pool_key(workers[2]) not in ex._transports
            misses = _metric("covalent_tpu_pool_acquires_total", result="miss")
            os.environ["COVALENT_TPU_STRAGGLER_BUDGET_S"] = "0"
            second = await ex.run(late_rank_electron, [0.0, str(barriers[1])], {},
                                  {"dispatch_id": "straggler", "node_id": 1})
            dialed = _metric("covalent_tpu_pool_acquires_total", result="miss") - misses
            live = await ex.health_canary(workers[0])
            client = ex._agent_of(workers[0])
            conn = ex._transports[ex._pool_key(workers[0])]
            await conn.run(f"kill -9 {client._banner['pid']}")
            for _ in range(200):
                if not client.alive:
                    break
                await asyncio.sleep(0.05)
            dead = await ex.health_canary(workers[0])
            return first, second, wall, dropped, dialed, live, dead
        finally:
            await ex.close()

    try:
        first, second, wall, dropped, dialed, live, dead = asyncio.run(run())
    finally:
        obs_events.remove_listener(seen.append)
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    flagged = [e for e in seen if e.get("type") == "fleet.straggler"]
    redials = [e for e in seen if e.get("type") == "fleet.straggler_redial"]
    line = {"arm": "straggler", "workers": workers, "gang_size": len(workers),
            "delay_s": STRAGGLER_DELAY_S, "budget_s": STRAGGLER_BUDGET_S,
            "flagged": [{"worker": e["worker"], "differential_s": e["differential"]}
                        for e in flagged],
            "straggler_redial": [{"worker": e["worker"], "discarded": e["discarded"]}
                                 for e in redials],
            "channel_dropped": dropped, "next_electron_fresh_dials": dialed,
            "health": HEALTH.snapshot().get(workers[2]), "electron_wall_s": wall,
            "canary_live": live, "canary_after_kill": dead}
    if (first, second) != (0, 0) or [f["worker"] for f in line["flagged"]] != [workers[2]] \
            or not (STRAGGLER_BUDGET_S < flagged[0]["differential"] < STRAGGLER_DELAY_S + 3.0) \
            or [r["worker"] for r in line["straggler_redial"]] != [workers[2]] \
            or not dropped or dialed != 1 or live is not True or dead is not False:
        raise AssertionError(f"lifecycle straggler: {line}")
    return line


def _cas_arm(executor) -> dict:
    """The worker CAS's byte budget over minissh: electrons whose function
    pickles each carry one LM bundle (a block of the 125M LM), a budget of
    the harness and 1.2 bundles, so each electron's maintenance
    evicts the bundle before it; the harness and the running electron's
    pickle survive every prune.  The TTL clause rides the pre-flight."""
    import hashlib
    import re

    from covalent_tpu_plugin_torch import harness as harness_mod
    from covalent_tpu_plugin_torch.cache import harness_digest
    from covalent_tpu_plugin_torch.obs import events as obs_events

    bundles = [lm_block_bundle(seed) for seed in CAS_SEEDS]
    budget = os.path.getsize(harness_mod.__file__) + int(1.2 * len(bundles[0]))
    ex = executor("cas", use_agent=False, cas_max_bytes=budget)
    cas_dir = Path(ex.remote_cache) / "cas"
    digests: list = []
    stage = ex._write_function_files

    def keep(*args, **kwargs):
        staged = stage(*args, **kwargs)
        digests.append(staged.function_digest)
        return staged

    ex._write_function_files = keep
    seen: list = []
    obs_events.add_listener(seen.append)

    async def run():
        rows = []
        try:
            for seed, blob in zip(CAS_SEEDS, bundles):
                wall = time.perf_counter()
                out = await ex.run(cas_bundle_electron, [blob], {},
                                   {"dispatch_id": "cas", "node_id": seed})
                held = sorted(p.name for p in cas_dir.iterdir())
                rows.append({"seed": seed, "bytes": out["bytes"],
                             "wall_s": time.perf_counter() - wall,
                             "upload_s": ex.last_timings.get("upload"),
                             "cas_files": len(held), "cas_bytes": sum(
                                 (cas_dir / n).stat().st_size for n in held),
                             "harness_kept": f"{harness_digest()}.py" in held,
                             "running_pickle_kept": f"{digests[-1]}.pkl" in held,
                             "ok": out["sha256"] == hashlib.sha256(blob).hexdigest()})
            return rows, ex._preflight_command()
        finally:
            await ex.close()

    try:
        rows, preflight = asyncio.run(run())
    finally:
        obs_events.remove_listener(seen.append)
    evicted = [e["evicted"] for e in seen
               if e.get("type") == "cas.bytes_pruned" and e.get("site") == "remote"]
    ttl = re.search(r"-mmin \+(\d+)", preflight)
    line = {"arm": "cas", "bundle_bytes": len(bundles[0]), "cas_max_bytes": budget,
            "electrons": rows, "cas_evicted": evicted, "cas_evicted_total": sum(evicted),
            "ttl_mmin": int(ttl.group(1)) if ttl else None, "cas_ttl_hours": ex.cas_ttl_hours}
    if sum(evicted) != len(CAS_SEEDS) - 1 or not all(
            r["ok"] and r["harness_kept"] and r["running_pickle_kept"] for r in rows) \
            or line["ttl_mmin"] != int(ex.cas_ttl_hours * 60):
        raise AssertionError(f"lifecycle cas: {line}")
    return line


def _serving_launches(stats: dict) -> dict:
    return {k.split(".", 1)[1]: v for k, v in stats.items() if k.startswith("serving_launches.")}


async def _ssh_serving(executor, server, serve_streams: list, config,
                       device: str = "cuda") -> tuple[list, dict]:
    """The serve cell over minissh: one session through ``open_session``,
    then a replica set of two, each replica behind its own SSH address.
    Every stream against the local ``session`` phase's."""
    from covalent_tpu_plugin_torch.serving import open_replica_set, open_session

    prompts, caps = session_prompts(config.vocab_size)
    lines = []
    ex = executor("ssh_session", use_agent="pool", pool_preload=SERVE_PRELOAD)
    try:
        wall = time.perf_counter()
        handle = await open_session(ex, serve_factory(config, device), stats_interval_s=1.0,
                                    open_timeout_s=300)
        open_s = time.perf_counter() - wall
        await _warm(handle, config, 1)
        before = wire_bytes()
        results, wall, ttft, latency = await _timed_burst(handle, prompts, caps)
        wire = wire_delta(before, sum(caps))
        stats = await _settled_stats(handle.supervisor, len(prompts) + 1)
        frames = handle.supervisor._client.frames_active
        address = handle.supervisor.address
        closed = await handle.close()
    finally:
        await ex.close()
    differ = sum(a != b for s, w in zip(results, serve_streams) for a, b in zip(s, w))
    serving = _serving_launches(stats)
    line = {"arm": "ssh_session", "address": address, "open_s": open_s,
            "requests": len(prompts), "caps": caps, "tokens_per_s": sum(caps) / wall,
            "wall_s": wall, "ttft_s": _percentiles(ttft), "completion_s": _percentiles(latency),
            "wire": wire, "wire_bytes_per_token": wire["down_bytes_per_token"],
            "frames_active": frames, "tokens_differ_session_phase": differ,
            "streams_complete": sum(len(r) == c for r, c in zip(results, caps)),
            "served": closed.get("served"), "serving_launches": dict(serving),
            "flash_launches": _flash(stats),
            "worker_peak_mem_bytes": (stats.get("device_mem") or {}).get("peak_bytes_in_use")}
    if differ or line["streams_complete"] != len(prompts) or not frames \
            or not all(serving.get(k, 0) >= 1 for k in SERVING_ROUTES_ON_PATH) \
            or any(_flash(stats).values()):
        raise AssertionError(f"lifecycle ssh_session: {line}")
    lines.append(line)

    replicas = [executor(f"ssh_replica_{i}", use_agent="pool", pool_preload=SERVE_PRELOAD,
                         hostname=server.address(host))
                for i, host in enumerate(("127.0.0.1", "localhost"))]
    try:
        start = time.perf_counter()
        await asyncio.gather(*(r.lease_gang() for r in replicas))
        pools_s = time.perf_counter() - start
        start = time.perf_counter()
        rset = await open_replica_set(replicas, serve_factory(config, device),
                                      stats_interval_s=1.0, open_timeout_s=300)
        open_s = time.perf_counter() - start
        await _warm(rset, config, 2)
        results, wall, ttft, latency = await _timed_burst(rset, prompts, caps)
        placed = dict(rset.placed)
        set_stats = {rid: await _settled_stats(sup, sup.served)
                     for rid, sup in rset.supervisors.items()}
        addresses = {rid: sup.address for rid, sup in rset.supervisors.items()}
        await rset.close()
    finally:
        for r in replicas:
            await r.close()
    differ = sum(a != b for s, w in zip(results, serve_streams) for a, b in zip(s, w))
    for rid, st in set_stats.items():
        for k, n in _serving_launches(st).items():
            serving[k] = serving.get(k, 0) + n
    line = {"arm": "ssh_replicas", "replicas": 2, "addresses": addresses,
            "pools_start_s": pools_s, "open_s": open_s, "tokens_per_s": sum(caps) / wall,
            "wall_s": wall, "ttft_s": _percentiles(ttft), "completion_s": _percentiles(latency),
            "placed": placed, "tokens_differ_session_phase": differ,
            "streams_complete": sum(len(r) == c for r, c in zip(results, caps)),
            "serving_launches": {rid: _serving_launches(st) for rid, st in set_stats.items()}}
    if differ or line["streams_complete"] != len(prompts) or set(placed) != {"r0", "r1"}:
        raise AssertionError(f"lifecycle ssh_replicas: {line}")
    lines.append(line)
    return lines, serving


LIFECYCLE_PARTS = ("arms", "serving")


def lifecycle_phase(session_streams: list | None, device: str = "cuda",
                    parts: tuple = LIFECYCLE_PARTS) -> tuple[list[dict], dict]:
    """The executor's lifecycle over minissh (slice 5b-iii): the ``arms``
    part (the ``prewarm`` and ``teardown`` arms, the ``straggler`` arm and
    the canary, the ``cas`` arm), and the ``serving`` part, the serve cell
    over SSH (``ssh_session``, ``ssh_replicas``) held token for token
    against the ``session`` phase's ``session_streams``.  Either part may
    run alone, each on its own server.  Returns the lines and the serving
    kernels' launches over SSH."""
    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.models.transformer import lm_125m_config

    stack = _ssh_stack()
    if not stack["python"]["cryptography"]:
        return [{"skipped": "no SSH backend on this machine: missing the `cryptography` "
                            "package (minissh)", "stack": stack}], {}
    work = WORK / "lifecycle"
    server = SSHServer(work / "keys")

    def executor(name: str, **kwargs) -> "GPUExecutor":
        settings = dict(
            transport="minissh", hostname=server.address(), ssh_key_file=server.key_file,
            known_host_key_file=server.host_pub, strict_host_keys=True,
            cache_dir=str(work / name / "cache"), remote_cache=str(work / name / "remote"),
            remote_workdir=str(work / name / "work"), python_path=sys.executable,
            task_env={"PYTHONPATH": str(ROOT)}, task_timeout=600, poll_freq=0.25,
            max_connection_attempts=3, retry_wait_time=1.0)
        settings.update(kwargs)
        return GPUExecutor(**settings)

    lines: list = []
    serving: dict = {}
    try:
        for arm, run in (("prewarm", lambda: _prewarm_arm(executor)),
                         ("straggler", lambda: [_straggler_arm(executor, server)]),
                         ("cas", lambda: [_cas_arm(executor)])):
            if "arms" not in parts:
                break
            start = time.perf_counter()
            arm_lines = run()
            arm_lines[-1]["seconds"] = time.perf_counter() - start
            lines.extend(arm_lines)
        if "serving" in parts:
            start = time.perf_counter()
            serving_lines, serving = asyncio.run(_ssh_serving(
                executor, server, session_streams, lm_125m_config(max_seq=512), device))
            serving_lines[-1]["seconds"] = time.perf_counter() - start
            lines.extend(serving_lines)
    finally:
        server.close()
    return lines, serving


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
                       "bi_gemm": "bi_gemm_fma_", "bi_rmsnorm": "bi_rmsnorm_"}
#: The norm's two device functions: alone, and with the residual add.
NORM_KERNEL_TAGS = {"alone": "bi_rmsnorm_kernel", "fused": "bi_rmsnorm_add_kernel"}


def profile_step(step, spans: str | None = None, n_spans: int = 0):
    """One call of ``step`` under torch.profiler, after one profiled call
    that is not recorded (a trace that starts cold can lose the first
    kernels of its step).  Returns the profiler, the serving kernels'
    launches counted by their wrappers in the recorded call, and its host
    seconds.

    The tracer has delivered a recorded step without some of its device
    events (the step's first norm once; 108 of 657 kernels and a layer's
    ``decode_attention`` range another time) while every launch was counted.
    So the trace is checked against the wrappers' exact counts (one device
    event a launch for every tag of ``SERVING_KERNEL_TAGS``) and, given
    ``spans``, against ``n_spans`` ranges of that name on the device.  A
    trace that fails is taken again from a new step, up to
    ``PROFILE_STEP_TRIES`` steps; the step's launches are the program's and
    are not retried for."""
    import torch

    from covalent_tpu_plugin_torch.ops import _kernels

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    problem = ""
    for _ in range(PROFILE_STEP_TRIES):
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
        launches = _kernels.serving_launch_counts()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [e for e in events if not getattr(e, "is_user_annotation", False)]
        traced = {route: sum(tag in e.name for e in kernels)
                  for route, tag in SERVING_KERNEL_TAGS.items()}
        counted = {route: launches[route] for route in SERVING_KERNEL_TAGS}
        ranges = sum(getattr(e, "is_user_annotation", False) and e.name == spans
                     for e in events) if spans else 0
        if traced == counted and ranges == n_spans:
            return prof, launches, wall
        problem = (f"{len(kernels)} device events, serving kernels {traced} traced against "
                   f"{counted} launched, {ranges} {spans} ranges against {n_spans}")
    raise AssertionError(f"the profiler's trace of a step stayed incomplete in "
                         f"{PROFILE_STEP_TRIES} steps: {problem}")


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
        prof, serving_launches, wall = profile_step(step, "decode_attention",
                                                    model.config.n_layers)
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


# --- slice 3a: int8 weights and LoRA adapters ---------------------------------

#: The 125M LM's int8 products: (K, N, output type) of q/k/v/o, the MLP's wi
#: and wo, and the lm_head (bf16 features, f32 logits).
W8_SHAPES = {"qkvo": (768, 768, "bfloat16"), "mlp_wi": (768, 3072, "bfloat16"),
             "mlp_wo": (3072, 768, "bfloat16"), "lm_head": (768, 32768, "float32")}
#: The fine-tune: rank 16 on the default targets, B=8, S=1024, 3 steps.
LORA_RANK = 16
LORA_STEPS = 3
ADAPTER_MODES = ("fp", "int8", "kv_quant", "full_quant")
#: The modes_bank burst: request i takes the mode ADAPTER_MODES[i % 4] and
#: this adapter ("" the base); requests 12-15 are sent after ``third`` is
#: attached mid-burst.
ADAPTER_MIX = ("", "tuned", "seeded", "tuned") * 3 + ("", "third", "third", "tuned")
#: Dense products a decode step of an int8 model runs: 6 a layer and the lm_head.
W8_PER_STEP = 6 * 12 + 1


def _w8_operands(m: int, k: int, n: int, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(n, k, generator=gen, device="cuda") * 0.02
    scale = w.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return x, q, scale


def w8_kernel_check() -> dict:
    """The int8-weight product (``csrc/bi_gemm_w8.cu``) at M 1, 8, 128 and
    1024 on the 125M LM's shapes: the elements that differ from
    ``bi_gemm_tc`` on the widened weight followed by the reference's scale
    step (must be 0), device ms beside the plain version, the library call
    on a weight widened to bf16 beforehand (``F.linear``: the same function
    with twice the weight bytes; a yardstick only) and the bound (the int8
    weight's bytes at 3.35 TB/s, or the operations); and the rows that
    differ at batch 8, 128 and 1024 from each row alone (must be 0)."""
    import torch
    import torch.nn.functional as F

    from covalent_tpu_plugin_torch.ops import _kernels
    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    cases, fns, mismatched = {}, {}, {}
    for name, (k, n, out_name) in W8_SHAPES.items():
        dtype = getattr(torch, out_name)
        for tag, m in BI_ROWS.items():
            x, q, scale = _w8_operands(m, k, n, seed=m + n)
            wide = q.to(torch.bfloat16)
            got = bi.linear_w8(x, q, scale, dtype)
            twin = torch.empty(m, n, dtype=dtype, device="cuda")
            _kernels.bi_gemm(x, wide, twin)
            twin = twin * scale.to(dtype)
            label = f"{name}.{tag}"
            mismatched[label] = int((got != twin).sum())
            plan = _kernels.plan_bi_gemm(torch.bfloat16, torch.int8, (1, 1, 1, m, n, k))
            nbytes = x.numel() * 2 + q.numel() + scale.numel() * 4 + got.numel() * got.element_size()
            cases[label] = dict(m=m, k=k, n=n, out=out_name, tiles=plan.tiles, route=plan.route,
                                flops=2 * m * n * k, bytes=nbytes,
                                **_max_err(got, bi.linear_w8_plain(x, q, scale, dtype)))
            fns[f"{label}:kernel"] = (lambda x=x, q=q, s=scale, d=dtype: bi.linear_w8(x, q, s, d),
                                      "w8_")
            fns[f"{label}:plain"] = (lambda x=x, q=q, s=scale, d=dtype:
                                     bi.linear_w8_plain(x, q, s, d), None)
            fns[f"{label}:library"] = (lambda x=x, w=wide: F.linear(x, w), None)
    times = device_ms_labelled(fns, 20)
    for label, row in cases.items():
        bound_ms, bound_by = bound(row["flops"], row["bytes"], "bfloat16")
        row.update(ms=times[f"{label}:kernel"], plain_ms=times[f"{label}:plain"],
                   library_ms=times[f"{label}:library"], bound_ms=bound_ms, bound_by=bound_by,
                   elements_differ_bi_gemm_tc=mismatched[label])
    rows_differ = {}
    for name, (k, n, out_name) in W8_SHAPES.items():
        dtype = getattr(torch, out_name)
        x, q, scale = _w8_operands(1024, k, n, seed=k + n)
        rows_differ[name] = rows_alone(
            lambda x, q=q, s=scale, d=dtype: bi.linear_w8(x, q, s, d), x)
    out = {"shapes": cases, "elements_differ_bi_gemm_tc": sum(mismatched.values()),
           "rows_differ": rows_differ,
           "library_note": "F.linear on the weight widened to bf16 beforehand"}
    bad = [label for label, row in cases.items() if not row["ok"] or row["route"] != "w8"]
    if out["elements_differ_bi_gemm_tc"] or any(
            v for rows in rows_differ.values() for v in rows.values()) or bad:
        raise AssertionError(f"adapters w8_kernel: differ {mismatched}, rows {rows_differ}, "
                             f"off the plain version or the route: {bad}")
    return out


def seeded_adapter(config, seed: int) -> list:
    """An adapter of rank :data:`LORA_RANK` in the reference's wire form,
    every leaf from a generator seeded with ``seed`` (A ~ N(0, 1/r), B ~
    N(0, 0.02)): B non-zero, so it changes the streams."""
    import dataclasses

    import numpy as np

    from covalent_tpu_plugin_torch.models import lora
    from covalent_tpu_plugin_torch.models.transformer import TransformerLM

    template = TransformerLM(dataclasses.replace(config, lora_rank=LORA_RANK), device="meta")
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * (0.02 if i % 2 else 1.0 / LORA_RANK)
             ).astype(np.float32) for i, shape in enumerate(lora.adapter_shapes(template))]


def lora_train_arm() -> tuple[list, object]:
    """Two LoRA fine-tune electrons by RPC, on the float base, then QLoRA
    (``quantize_then_lora``): ``(results, run)``, ``run(executor)`` filling
    ``results``.  The ``train`` phase runs them on its warm pool; the
    ``adapters`` phase checks them."""
    from covalent_tpu_plugin_torch.models.lora import train_lora

    lines = []

    async def run(executor):
        for node, quantized in enumerate((False, True)):
            wall = time.perf_counter()
            out = await executor.run(
                train_lora, [], dict(steps=LORA_STEPS, batch_size=BATCH, seq_len=SEQ,
                                     rank=LORA_RANK, quantized=quantized, seed=0),
                {"dispatch_id": "chip_smoke_lora", "node_id": node})
            out["wall_s"] = time.perf_counter() - wall
            out["dispatch_mode"] = executor.last_dispatch_mode
            lines.append(out)
    return lines, run


def _oracle_model(base, mode: str, leaves):
    """The single-adapter model of one lane: ``base`` (bf16 weights) in
    ``mode``'s twin with the adapter of ``leaves`` on top, in
    ``quantize_then_lora``'s order; ``base``'s twin alone without one."""
    import dataclasses

    import torch

    from covalent_tpu_plugin_torch.models import lora, quant
    from covalent_tpu_plugin_torch.models.transformer import TransformerLM

    model = quant.quantize_lm(base) if mode in ("int8", "full_quant") else base
    if leaves is not None:
        model = lora.load_adapter(lora.add_lora(model, LORA_RANK), leaves)
    if mode in ("kv_quant", "full_quant"):
        twin = TransformerLM(dataclasses.replace(model.config, quantized_kv_cache=True),
                             device=torch.device("meta"))
        twin.load_state_dict(model.state_dict(), assign=True)
        model = twin
    return model


def _weight_bytes(model) -> int:
    """Bytes of the weights a decode step reads: every parameter but the
    embedding (a step gathers its rows), adapters excluded."""
    return sum(p.numel() * p.element_size() for n, p in model.named_parameters()
               if n != "embedding" and not n.endswith(("lora_a", "lora_b")))


async def _modes_bank_session(executor, config, adapters: dict, third: list) -> dict:
    """The serve cell's 16 requests through one session whose engine hosts
    the four decode modes and a bank of ``adapters``; ``third`` registered
    and attached mid-burst, then detached."""
    from covalent_tpu_plugin_torch.models import serve
    from covalent_tpu_plugin_torch.serving import open_session

    prompts, caps = session_prompts(config.vocab_size)
    factory = counting_factory(serve.lm_engine_factory(
        config=config, seed=0, device="cuda", max_batch=SESSION["slots"],
        sync_steps=SESSION["sync_steps"], max_new_tokens=SESSION["long"],
        decode_modes=ADAPTER_MODES, adapters=adapters, adapter_rank=LORA_RANK))
    start = time.perf_counter()
    handle = await open_session(executor, factory, stats_interval_s=1.0, open_timeout_s=300)
    open_s = time.perf_counter() - start
    await _warm(handle, config, 1)

    def params(i):
        p = {"max_new_tokens": caps[i], "quality": ADAPTER_MODES[i % 4]}
        if ADAPTER_MIX[i]:
            p["adapter"] = ADAPTER_MIX[i]
        return p

    start = time.perf_counter()
    first = [await handle.request(prompts[i], params=params(i)) for i in range(12)]
    while not any(r.tokens for r in first):
        await asyncio.sleep(0.01)
    record = executor.adapter_registry().put("third", third, rank=LORA_RANK)
    attach_start = time.perf_counter()
    attached = await handle.attach_adapter("third")
    attach_s = time.perf_counter() - attach_start
    in_flight_at_attach = sum(0 < len(r.tokens) < c for r, c in zip(first, caps))
    rest = [await handle.request(prompts[i], params=params(i)) for i in range(12, 16)]
    requests = first + rest
    results = await asyncio.gather(*(r.result(timeout=600) for r in requests))
    wall = time.perf_counter() - start
    detached = await handle.detach_adapter("third")
    stats = await _settled_stats(handle.supervisor, len(prompts) + 1)
    held = handle.adapters
    await handle.close()
    return {"results": results, "requests": requests, "wall": wall, "open_s": open_s,
            "attach_s": attach_s, "attached": attached, "detached": detached,
            "record": record, "stats": stats, "held_after_detach": held,
            "in_flight_at_attach": in_flight_at_attach}


def adapters_phase(pool_session: dict, trained: list | None = None,
                   w8: dict | None = None) -> tuple[list[dict], dict]:
    """Slice 3a on the card: the int8-weight kernel (``w8``: the line of
    :func:`w8_kernel_check`, which ``main`` runs on the quiet card before
    the lanes; run here when not given), the LoRA fine-tune electrons
    (``trained``: the ``train`` phase ran them on its warm pool; run here
    by RPC when not given), and one session hosting the four
    decode modes and a bank of adapters (attached and detached mid-burst),
    each lane held token for token to its single-adapter engine and each
    base lane to the ``session`` phase.  Returns the lines and the serving
    kernels' launches in the session's worker (the int8 kernel's path)."""
    import numpy as np
    import torch

    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.models import decode, quant, serve
    from covalent_tpu_plugin_torch.models.transformer import TransformerLM, lm_125m_config
    from covalent_tpu_plugin_torch.ops import _kernels

    from covalent_tpu_plugin_torch.serving.registry import adapter_content_digest, unpack_adapter

    if w8 is None:
        start = time.perf_counter()
        w8 = {"arm": "w8_kernel", **w8_kernel_check(), "seconds": time.perf_counter() - start}
    lines = [w8]

    config = lm_125m_config(max_seq=512)
    common = dict(transport="local", cache_dir=str(WORK / "cache_adapters"),
                  remote_workdir=str(WORK / "work"), python_path=sys.executable,
                  task_timeout=600, task_env={"PYTHONPATH": str(ROOT)})
    start = time.perf_counter()
    if trained is None:
        trained, run_training = lora_train_arm()

        async def train():
            executor = GPUExecutor(**common, remote_cache=str(WORK / "remote_lora"),
                                   dispatch_mode="rpc")
            try:
                await run_training(executor)
            finally:
                await executor.close()

        asyncio.run(train())
    executor = GPUExecutor(**common, remote_cache=str(WORK / "remote_adapters"),
                           use_agent="pool", pool_preload=SERVE_PRELOAD)

    async def drive():
        try:
            adapters = {"tuned": trained[0]["leaves"], "seeded": seeded_adapter(config, 1)}
            return await _modes_bank_session(executor, config, adapters,
                                             seeded_adapter(config, 2))
        finally:
            await executor.close()

    session = asyncio.run(drive())
    registry = executor.adapter_registry()
    for arm in trained:
        # the adapter as the registry ships it: its bundle's bytes in the
        # CAS, unpacked and digested again, against the worker's digest
        record = registry.put(f"lora_{'int8' if arm['quantized'] else 'float'}", arm["leaves"],
                              rank=LORA_RANK)
        shipped = unpack_adapter(Path(record["path"]).read_bytes())
        arm_line = {
            "arm": "lora_train", "quantized": arm["quantized"], "rank": arm["rank"],
            "dispatch_mode": arm["dispatch_mode"], "losses": arm["losses"],
            "step_ms": [s * 1e3 for s in arm["step_s"]], "launches": arm["launches"],
            "launches_per_step": {k: v / LORA_STEPS for k, v in arm["launches"].items()},
            "base_unchanged": arm["base_unchanged"],
            "adapter_leaves_moved": arm["adapter_leaves_moved"],
            "adapter_leaves_total": arm["adapter_leaves_total"], "digest": arm["digest"],
            "registry_digest": record["content"],
            "bundle_digest": adapter_content_digest(shipped["leaves"]),
            "bundle_bytes": record["size"],
            "electron_wall_s": arm["wall_s"], "device": arm["device"]}
        ok = (all(np.isfinite(arm["losses"])) and arm["losses"][-1] < arm["losses"][0]
              and all(v == 12 * LORA_STEPS for v in arm["launches"].values())
              and arm["base_unchanged"]
              and arm_line["digest"] == arm_line["registry_digest"] == arm_line["bundle_digest"]
              and arm["adapter_leaves_moved"] == arm["adapter_leaves_total"] == 144
              and arm["dispatch_mode"] == "rpc")
        if not ok:
            raise AssertionError(f"adapters lora_train: {arm_line}")
        lines.append(arm_line)

    # in-process on the card: the single-adapter engines, the lane groups'
    # int8 launches per decode step and the quantized lanes' logit cosines
    base = decode.inference_params(TransformerLM(
        config, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0)))
    adapters = {"tuned": trained[0]["leaves"], "seeded": seeded_adapter(config, 1),
                "third": seeded_adapter(config, 2)}
    prompts, caps = session_prompts(config.vocab_size)
    results = session["results"]
    differ = {}
    pairs = sorted({(ADAPTER_MODES[i % 4], ADAPTER_MIX[i]) for i in range(16)})
    for mode, name in pairs:
        idx = [i for i in range(16) if (ADAPTER_MODES[i % 4], ADAPTER_MIX[i]) == (mode, name)]
        if mode == "fp" and not name:
            # base lanes against the session phase's streams
            differ["fp/base"] = sum(a != b for i in idx
                                    for a, b in zip(results[i], pool_session["results"][i]))
            continue
        engine = serve.ContinuousEngine(
            _oracle_model(base, mode, adapters[name] if name else None),
            max_batch=SESSION["slots"], sync_steps=SESSION["sync_steps"],
            max_new_tokens=SESSION["long"])
        for i in idx:
            engine.admit(str(i), prompts[i], {"max_new_tokens": caps[i]})
        oracle: dict = {}
        while engine.busy:
            for event in engine.step():
                oracle.setdefault(int(event["rid"]), []).extend(event["tokens"])
        engine.close()
        differ[f"{mode}/{name or 'base'}"] = sum(
            (len(results[i]) != len(oracle[i])) + sum(a != b for a, b in zip(results[i], oracle[i]))
            for i in idx)
    groups = serve.ContinuousEngine(base, max_batch=1, sync_steps=1, max_new_tokens=4,
                                    decode_modes=ADAPTER_MODES,
                                    adapters={"tuned": adapters["tuned"]})
    w8_per_step, weight_bytes = {}, {}
    for mode in ADAPTER_MODES:
        groups.admit(mode, prompts[0][:16], {"quality": mode, "adapter": "tuned",
                                             "max_new_tokens": 4})
        groups.step()
        _kernels.reset_launch_counts()
        groups.step()
        w8_per_step[mode] = _kernels.serving_launch_counts()["bi_gemm_w8"]
        groups.cancel(mode)
        weight_bytes[mode] = _weight_bytes(groups.group(mode)._model)
    groups.close()
    tokens = torch.as_tensor(np.stack(prompts[:2]), dtype=torch.long, device="cuda")
    with torch.no_grad():
        fp = base(tokens, cache=decode.init_cache(base, 2)).double().flatten()
        cosine = {}
        for mode in ADAPTER_MODES[1:]:
            twin = quant.mode_variant(base, mode)
            got = twin(tokens, cache=decode.init_cache(twin, 2)).double().flatten()
            cosine[mode] = float(fp @ got / (fp.norm() * got.norm()))
    del base
    torch.cuda.empty_cache()

    reqs, stats = session["requests"], session["stats"]
    per_mode = {}
    for m_i, mode in enumerate(ADAPTER_MODES):
        idx = range(m_i, 16, 4)
        per_mode[mode] = {
            "requests": len(idx), "tokens": sum(caps[i] for i in idx),
            "tokens_per_s": sum(caps[i] for i in idx) / session["wall"],
            "ttft_p50_s": float(np.percentile([reqs[i].ttft_s for i in idx], 50)),
            "weight_bytes_per_step": weight_bytes[mode],
            "int8_launches_per_step": w8_per_step[mode],
            "engine_tokens": stats.get(f"mode_tokens_{mode}")}
    serving = _serving_launches(stats)
    line = {
        "arm": "modes_bank", "decode_modes": ADAPTER_MODES, "adapters": sorted(adapters),
        "mix": [f"{ADAPTER_MODES[i % 4]}/{ADAPTER_MIX[i] or 'base'}" for i in range(16)],
        "open_s": session["open_s"], "wall_s": session["wall"],
        "tokens_per_s": sum(caps) / session["wall"], "per_mode": per_mode,
        "adapter_bytes_per_row": sum(leaf.size * 2 for leaf in adapters["tuned"]),
        "logit_cosine_vs_fp": cosine, "tokens_differ_single_adapter": differ,
        "streams_complete": sum(len(r) == c for r, c in zip(results, caps)),
        "attach_s": session["attach_s"], "serve_attached": session["attached"],
        "serve_detached": session["detached"], "registry_record": session["record"],
        "in_flight_at_attach": session["in_flight_at_attach"],
        "held_after_detach": session["held_after_detach"],
        "engine_stats": {k: v for k, v in stats.items()
                         if k.startswith(("adapter_", "mode_")) or k == "mode_refusals"},
        "serving_launches": serving, "flash_launches": _flash(stats),
        "worker_peak_mem_bytes": (stats.get("device_mem") or {}).get("peak_bytes_in_use")}
    ok = (line["streams_complete"] == 16 and not any(differ.values())
          and cosine["int8"] > 0.999 and cosine["kv_quant"] > 0.999
          and w8_per_step["fp"] == w8_per_step["kv_quant"] == 0
          and w8_per_step["int8"] == w8_per_step["full_quant"] == W8_PER_STEP
          and serving.get("bi_gemm_w8", 0) >= 1 and not any(_flash(stats).values())
          and session["attached"].get("digest") == adapter_content_digest(adapters["third"])
          and "third" not in session["held_after_detach"] and stats.get("mode_refusals") == 0)
    if not ok:
        raise AssertionError(f"adapters modes_bank: {line}")
    line["seconds"] = time.perf_counter() - start
    lines.append(line)
    return lines, serving


# --- slice 4, part 3(a): decoding the 125M Switch-MoE LM ----------------------

#: The ``train`` phase's ``moe8`` arm, decoded: 8 experts at the reference's
#: default capacity factor (1.25), bf16 weights from seed 0.
MOE_SERVE = dict(max_seq=512, moe_experts=8)
#: The MoE block's kernel route against its plain twin: the block rounds
#: after each expert product and after the gate's product, so its bound is
#: four bf16 roundings of its largest plain value; the product alone is held
#: to ``_max_err``'s (two roundings of the largest value, at least 1).
MOE_BLOCK_TOL = 2.0**-6
#: Decode steps of the profiled step's warm-up chunk.
MOE_PROFILE_WARM = 4


def _tokens_differ(got: list, want: list) -> int:
    """Tokens of ``got`` that differ from ``want``, stream by stream, a
    missing or extra token counting as one."""
    return sum(sum(a != b for a, b in zip(g, w)) + abs(len(g) - len(w))
               for g, w in zip(got, want))


def _moe_parity(model) -> dict:
    """Layer 0's MoE block on the batch-invariant route against its plain
    twin on the card (routed per row, as the engine's lanes), at a decode
    step of 8 rows and at a wave of 8 rows of 128 tokens; and each of its
    products alone (the f32 router on ``csrc/bi_gemm.cu``, the expert
    products on ``csrc/bi_gemm_tc.cu``) at the decode step's shapes, with
    device times, the plain twin's, one library call's and the bound."""
    import torch
    import torch.nn.functional as F

    from covalent_tpu_plugin_torch.ops import _kernels
    from covalent_tpu_plugin_torch.ops import batch_invariant as bi

    def launched(fn):
        """``fn()`` and the serving kernels it launched (those launched at all)."""
        before = _kernels.serving_launch_counts()
        result = fn()
        after = _kernels.serving_launch_counts()
        return result, {k: after[k] - before[k] for k in after if after[k] != before[k]}

    block = model.layers[0].mlp
    cfg = model.config
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    with torch.no_grad():
        for name, (rows, seq) in {"decode_step": (8, 1), "wave": (8, 128)}.items():
            x = torch.randn(rows, seq, cfg.d_model, generator=gen, device="cuda").to(cfg.dtype)
            block.batch_invariant = True
            got, got_launches = launched(lambda: block(x, per_row=True))
            block.batch_invariant = False
            want, want_launches = launched(lambda: block(x, per_row=True))
            block.batch_invariant = True
            # the kernel side ran the router on bi_gemm and both expert
            # products on bi_gemm_tc; the plain side launched nothing
            routed = got_launches == {"bi_gemm": 1, "bi_gemm_tc": 2} and not want_launches
            err = (got.float() - want.float()).abs().max().item()
            tol = MOE_BLOCK_TOL * want.float().abs().max().item()
            out[f"block.{name}"] = {"shape": [rows, seq, cfg.d_model], "max_abs_err": err,
                                    "tol": tol, "launches": got_launches,
                                    "plain_launches": want_launches,
                                    "ok": err <= tol and routed,
                                    "tol_reason": "four bf16 roundings of the largest plain "
                                                  "value (h, the expert output, the gate)"}
        # the products at a decode step: each row's one token in its expert's
        # slot, capacity 1, so the stacks are (E, 8, d) and (E, 8, f)
        e, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
        wi, wo = block._expert_weights()
        tokens = torch.randn(8, d, generator=gen, device="cuda").to(cfg.dtype)
        xs = torch.randn(e, 8, d, generator=gen, device="cuda").to(cfg.dtype)
        hs = torch.randn(e, 8, f, generator=gen, device="cuda").to(cfg.dtype)
        router32 = block.router.float()
        cases = {
            "bi_gemm.router.m8": (
                lambda: bi.linear(tokens.float(), block.router, torch.float32),
                lambda: bi.linear_plain(tokens.float(), block.router, torch.float32),
                lambda: F.linear(tokens.float(), router32),
                2 * 8 * e * d, 8 * d * 4 + e * d * 2 + 8 * e * 4, "float32"),
            "bi_gemm_tc.expert_wi.m8": (
                lambda: bi.linear_rows(xs, wi, cfg.dtype),
                lambda: bi.linear_rows_plain(xs, wi, cfg.dtype),
                lambda: torch.bmm(xs, wi.transpose(1, 2)),
                2 * e * 8 * d * f, 2 * (e * 8 * d + e * f * d + e * 8 * f), "bfloat16"),
            "bi_gemm_tc.expert_wo.m8": (
                lambda: bi.linear_rows(hs, wo, cfg.dtype),
                lambda: bi.linear_rows_plain(hs, wo, cfg.dtype),
                lambda: torch.bmm(hs, wo.transpose(1, 2)),
                2 * e * 8 * d * f, 2 * (e * 8 * f + e * d * f + e * 8 * d), "bfloat16"),
        }
        for key, (kernel, plain, library, flops, nbytes, dtype) in cases.items():
            res = _max_err(kernel(), plain())
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            res.update({"ms": device_ms(kernel, 20), "plain_ms": device_ms(plain, 20),
                        "library_ms": device_ms(library, 20), "bound_ms": bound_ms,
                        "bound_by": bound_by})
            out[key] = res
    bad = {k: v for k, v in out.items() if not v["ok"]}
    if bad:
        raise AssertionError(f"serve_moe: kernel against plain out of bound: {bad}")
    return out


def _moe_profile(model) -> dict:
    """One decode step of 8 live rows at position 128 under torch.profiler:
    kernels a step, device and host ms, the card's busy share, the serving
    kernels' launches in the step, and every product a ``bi_gemm`` kernel
    (no library GEMM by name)."""
    import numpy as np
    import torch

    from covalent_tpu_plugin_torch.models import serve

    engine = serve.ContinuousEngine(model, max_batch=8, sync_steps=MOE_PROFILE_WARM,
                                    max_new_tokens=256)
    rng = np.random.default_rng(1)
    for i in range(8):
        engine.admit(str(i), rng.integers(0, model.config.vocab_size, 128),
                     {"max_new_tokens": 256})
    step = lambda: serve._run_steps(model, engine._state, 1, 0.0, None, None, None)  # noqa: E731
    with torch.no_grad():
        engine.step()
        torch.cuda.synchronize()
        unprofiled = time.perf_counter()
        for _ in range(16):
            step()
        torch.cuda.synchronize()
        unprofiled = (time.perf_counter() - unprofiled) / 16
        prof, launches, wall = profile_step(step)
    engine.close()
    kernels = device_events(prof)
    if not kernels:
        raise AssertionError("serve_moe: the profiled decode step has no device events")
    device = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    library = sorted({e.name[:80] for e in kernels if any(t in e.name for t in MATMUL_TAGS)
                      and "bi_gemm" not in e.name})
    by_route = {route: sum(e.time_range.elapsed_us() for e in kernels if tag in e.name) / 1e3
                for route, tag in SERVING_KERNEL_TAGS.items()}
    by_name: dict[str, list] = {}
    for evt in kernels:
        entry = by_name.setdefault(evt.name, [0.0, 0])
        entry[0] += evt.time_range.elapsed_us() / 1e3
        entry[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    n_layers = model.config.n_layers
    # per layer: the router (f32) and the two expert products, q/k/v/o, the
    # scores; the lm_head; the mix; the norms
    want = {"bi_gemm": n_layers, "bi_gemm_tc": 7 * n_layers + 1, "bi_gemm_mix": n_layers,
            "bi_rmsnorm": 2 * n_layers + 1, "bi_gemm_w8": 0}
    problems = []
    if library:
        problems.append(f"library GEMM kernels in the step: {library}")
    if launches != want:
        problems.append(f"the step's launches {launches}, expected {want}")
    if problems:
        raise AssertionError("serve_moe: " + "; ".join(problems))
    return {"kernels_per_step": len(kernels), "device_ms": device,
            "step_wall_ms": wall * 1e3, "unprofiled_step_wall_ms": unprofiled * 1e3,
            "device_busy_share": device / (wall * 1e3),
            "device_busy_share_unprofiled": device / (unprofiled * 1e3),
            "device_ms_by_serving_kernel": by_route, "serving_kernel_launches": launches,
            "library_gemm_kernels": library,
            "top": [{"name": n[:80], "ms": ms, "calls": c} for n, (ms, c) in top]}


async def _moe_session(config, prompts: list, caps: list, device: str) -> dict:
    """The ``serve`` phase's traffic through ``open_session`` on a pool
    server that builds the MoE LM from the seed (as ``lm_engine_factory``
    ships it): open seconds, one warm request, the 16 at once."""
    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.models import serve
    from covalent_tpu_plugin_torch.serving import open_session

    executor = GPUExecutor(transport="local", cache_dir=str(WORK / "cache_moe"),
                           remote_cache=str(WORK / "remote_moe"), python_path=sys.executable,
                           use_agent="pool", pool_preload=SERVE_PRELOAD,
                           task_env={"PYTHONPATH": str(ROOT)})
    try:
        factory = counting_factory(serve.lm_engine_factory(
            config=config, seed=0, device=device, max_batch=SESSION["slots"],
            sync_steps=SESSION["sync_steps"], max_new_tokens=SESSION["long"]))
        start = time.perf_counter()
        handle = await open_session(executor, factory, stats_interval_s=1.0,
                                    open_timeout_s=300)
        open_s = time.perf_counter() - start
        await _warm(handle, config, 1)
        start = time.perf_counter()
        requests = await asyncio.gather(*(
            handle.request(p, params={"max_new_tokens": c}) for p, c in zip(prompts, caps)))
        results = await asyncio.gather(*(r.result(timeout=600) for r in requests))
        wall = time.perf_counter() - start
        stats = await _settled_stats(handle.supervisor, len(prompts) + 1)
        await handle.close()
    finally:
        await executor.close()
    return {"results": results, "open_s": open_s, "wall_s": wall,
            "tokens_per_s": sum(caps) / wall,
            "ttft_s": _percentiles([r.ttft_s for r in requests]),
            "completion_s": _percentiles([r.latency_s for r in requests]),
            "worker_peak_mem_bytes": (stats.get("device_mem") or {}).get("peak_bytes_in_use"),
            "worker_flash_launches": _flash(stats),
            "worker_serving_launches": {k.removeprefix("serving_launches."): v
                                        for k, v in stats.items()
                                        if k.startswith("serving_launches.")}}


def _moe_model(config, device: str):
    """The serve_moe phase's model: bf16 inference weights from seed 0, as
    ``lm_engine_factory(config=, seed=0)`` builds them in a worker."""
    import torch

    from covalent_tpu_plugin_torch.models import decode
    from covalent_tpu_plugin_torch.models.transformer import TransformerLM

    return decode.inference_params(TransformerLM(
        config, device=device, generator=torch.Generator(device=device).manual_seed(0)))


def moe_kernel_arms() -> list[dict]:
    """The ``serve_moe`` arms that time kernels and profile a step, so need
    the card alone: ``main`` runs them in the quiet prefix and their lines
    leave with the phase's (the ``w8_kernel`` arm's way)."""
    import torch

    from covalent_tpu_plugin_torch.models.transformer import lm_125m_config, use_batch_invariant

    # on the serving route, as the engine puts it
    model = use_batch_invariant(_moe_model(lm_125m_config(**MOE_SERVE), "cuda"))
    lines = []
    for arm, fn in (("kernel_parity", _moe_parity), ("decode_profile", _moe_profile)):
        start = time.perf_counter()
        lines.append({"arm": arm, **fn(model), "seconds": time.perf_counter() - start})
    del model
    torch.cuda.empty_cache()
    return lines


def serve_moe_phase(kernel_lines: list | None = None, device: str = "cuda",
                    **overrides) -> tuple[list[dict], dict]:
    """The 125M Switch-MoE LM (``train``'s ``moe8`` arm, decoded) in bf16
    from seed 0: ``generate``, the engine on the serve cell's traffic, each
    stream against the same request served alone, the resident session and
    the peak memory, with ``kernel_lines`` (:func:`moe_kernel_arms`'s; run
    here when not given): the MoE block's kernels against their plain
    twins and one profiled decode step.  Returns the lines and the serving
    kernels' launches on the engine's run (the path).  To rehearse it on
    the CPU, give ``device="cpu"`` and a tiny config's ``overrides``: the
    kernel arms are then left out (they need the card)."""
    import numpy as np
    import torch

    from covalent_tpu_plugin_torch.models import decode, serve
    from covalent_tpu_plugin_torch.models.transformer import lm_125m_config
    from covalent_tpu_plugin_torch.ops import _kernels

    config = lm_125m_config(**{**MOE_SERVE, **overrides})
    cuda = device == "cuda"
    if cuda and kernel_lines is None:
        kernel_lines = moe_kernel_arms()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = _moe_model(config, device)
    lines = []
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    # (a) generate at batch 8, prompt 128, 128 new tokens: a warm call,
    # then the median of 3
    start = time.perf_counter()
    prompt = np.random.default_rng(0).integers(
        0, config.vocab_size, (SESSION["decode_batch"], SESSION["prompt_len"]))
    out = decode.generate(model, prompt, SESSION["long"])
    walls = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        out = decode.generate(model, prompt, SESSION["long"])
        sync()
        walls.append(time.perf_counter() - t0)
    median = statistics.median(walls)
    if tuple(out.shape) != (8, SESSION["prompt_len"] + SESSION["long"]):
        raise AssertionError(f"serve_moe: generate gave {tuple(out.shape)}")
    lines.append({"arm": "generate", "batch": 8, "prompt_len": SESSION["prompt_len"],
                  "new_tokens": SESSION["long"], "walls_s": walls, "median_s": median,
                  "decode_tokens_per_s": 8 * SESSION["long"] / median,
                  "ms_per_new_token": median * 1e3 / SESSION["long"],
                  "tokens_in_vocab": bool(((out >= 0) & (out < config.vocab_size)).all()),
                  "seconds": time.perf_counter() - start})

    # (b) the engine on the serve cell's traffic; the path's launches
    start = time.perf_counter()
    prompts, caps = session_prompts(config.vocab_size)
    engine_kwargs = dict(max_batch=SESSION["slots"], sync_steps=SESSION["sync_steps"],
                         max_new_tokens=SESSION["long"])
    _kernels.reset_launch_counts()
    engine = serve.ContinuousEngine(model, **engine_kwargs)
    streams, first, end, wall = serve._drive(engine, prompts, caps, sync)
    engine.close()
    path_launches = _kernels.serving_launch_counts()
    flash = _kernels.launch_counts()
    if any(flash.values()) or (cuda and not all(
            path_launches[k] for k in ("bi_gemm", "bi_gemm_tc", "bi_gemm_mix", "bi_rmsnorm"))):
        raise AssertionError(f"serve_moe: the engine's launches {path_launches}, flash {flash}")
    if [len(s) for s in streams] != caps or not all(
            0 <= t < config.vocab_size for s in streams for t in s):
        raise AssertionError("serve_moe: an engine stream is incomplete or out of the vocabulary")
    lines.append({"arm": "engine", "requests": len(prompts), "caps": caps, **engine_kwargs,
                  "wall_s": wall, "tokens_per_s": sum(caps) / wall,
                  "ttft_s": _percentiles(first), "completion_s": _percentiles(end),
                  "serving_launches": path_launches, "flash_launches": flash,
                  "seconds": time.perf_counter() - start})

    # (c) each request alone on an engine of the same max_batch
    start = time.perf_counter()
    alone = []
    for p, c in zip(prompts, caps):
        one = serve.ContinuousEngine(model, **engine_kwargs)
        alone.append(serve._drive(one, [p], [c], sync)[0][0])
        one.close()
    differ = _tokens_differ(streams, alone)
    lines.append({"arm": "batch_invariance", "streams": len(prompts),
                  "tokens_compared": sum(caps), "tokens_differ": differ,
                  "streams_differ": sum(a != b for a, b in zip(streams, alone)),
                  "seconds": time.perf_counter() - start})
    if differ:
        raise AssertionError(f"serve_moe: {differ} tokens differ between the batched streams "
                             "and the requests served alone")

    # (d) the MoE block and its products against their plain twins and (e)
    # one profiled decode step, on the quiet card
    lines += kernel_lines or []
    peak = torch.cuda.max_memory_allocated() if cuda else None

    # (f) the resident session on the same traffic
    start = time.perf_counter()
    session = asyncio.run(_moe_session(config, prompts, caps, device))
    results = session.pop("results")
    differ = _tokens_differ(results, streams)
    lines.append({"arm": "session", **session, "tokens_differ_engine": differ,
                  "seconds": time.perf_counter() - start})
    if differ or any(session["worker_flash_launches"].values()):
        raise AssertionError(f"serve_moe: the session's streams differ from the engine's by "
                             f"{differ} tokens (flash {session['worker_flash_launches']})")

    # (g) peak device memory of this process's phases
    lines.append({"arm": "memory", "peak_mem_bytes": peak,
                  "worker_peak_mem_bytes": session["worker_peak_mem_bytes"],
                  "n_params": model.parameter_count()})
    del model
    if cuda:
        torch.cuda.empty_cache()
    return lines, path_launches


# --- lanes: the phases after the quiet prefix, three at a time ---------------

#: The phases each child lane runs, in order (``python3 chip_smoke.py --lane
#: NAME``, started by ``main``); ``main`` itself runs the third lane (serve,
#: session, replicas and disagg, recovery, adapters).  Everything before the
#: lanes runs alone on the card: the kernels' parity and times, the train
#: phase, the profiles and the elastic phase's stall arm (whose check counts
#: the card's processes).  Each lane's own times are measured beside the
#: other two lanes' load: its lines say so (``lane``).
LANES = {"b": ("lattice", "elastic_preempt", "gang"),
         "c": ("lifecycle_arms", "ssh", "lifecycle_serving", "agent")}
LANE_DIR = WORK / "lanes"
#: The longest a lane waits for what another lane publishes.
LANE_WAIT_S = 900.0


def _publish(name: str, obj) -> None:
    """Hand ``obj`` to the other lanes (written whole, then renamed)."""
    LANE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LANE_DIR / f".{name}.{os.getpid()}.tmp"
    # numpy scalars and arrays as plain numbers and lists
    tmp.write_text(json.dumps(obj, default=lambda o: o.tolist()))
    os.replace(tmp, LANE_DIR / f"{name}.json")


def _awaited(name: str):
    """What another lane published as ``name``, once it has."""
    path = LANE_DIR / f"{name}.json"
    deadline = time.monotonic() + LANE_WAIT_S
    parent = os.getppid()
    while not path.exists():
        if os.getppid() != parent or time.monotonic() > deadline:
            raise AssertionError(f"lane: {name} was never published")
        time.sleep(0.2)
    return json.loads(path.read_text())


def _lane_lattice(smi: str, out: dict) -> None:
    """BASELINE configs 2-4 as lattices: no flash kernel, here or in the
    MNIST workers (which report their counts)."""
    from covalent_tpu_plugin_torch.ops import _kernels

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
    _publish("lattice", {line["arm"]: {k: line["overhead"][k] for k in (
        "dispatch_overhead_s", "wall_overhead_p50_s", "wall_overhead_p95_s")}
        for line in lattice_lines if "overhead" in line})


def _lane_elastic_preempt(smi: str, out: dict) -> None:
    """The 125M LM preempted once and resumed from its checkpoint beside an
    uninterrupted twin.  The attempts report their own launches (the first
    up to the checkpoint it left); ours are added."""
    from covalent_tpu_plugin_torch.ops import _kernels

    _kernels.reset_launch_counts()
    start = time.perf_counter()
    preempt = elastic_preempt()
    emit({"phase": "elastic", "card": smi, **preempt})
    out["elastic_s"] = time.perf_counter() - start
    out["elastic_launches"] = {
        name: n + preempt["launches"]["attempt1_to_checkpoint"].get(name, 0)
        + preempt["launches"]["attempt2"].get(name, 0)
        for name, n in _kernels.launch_counts().items()}


def _lane_gang(smi: str, out: dict) -> None:
    """BASELINE configs 5 and 4 as two-process gangs on the card: every rank
    reports its own launches; the phase fails if a rank of an LM arm ran a
    flash kernel a number of times other than 12 a step."""
    losses = _awaited("train")
    start = time.perf_counter()
    gang_lines, gang_launches, arm_launches = gang_phase(
        {name: losses[name] for name in ("standard", "fused", "moe8")})
    for line in gang_lines:
        emit({"phase": "gang", "card": smi, **line})
    emit({"phase": "gang", "card": smi, "seconds": time.perf_counter() - start,
          "flash_launches": gang_launches})
    out.update(gang_launches=gang_launches, gang_arm_launches=arm_launches)


def _lane_lifecycle_arms(smi: str, out: dict) -> None:
    """The executor's lifecycle over minissh, its first part: prewarm and
    teardown, a straggler and the canary, the CAS's byte budget.  Its lines
    leave with the second part's."""
    from covalent_tpu_plugin_torch.ops import _kernels

    _kernels.reset_launch_counts()
    start = time.perf_counter()
    lines, _ = lifecycle_phase(None, parts=("arms",))
    out["lifecycle"] = {"lines": lines, "seconds": time.perf_counter() - start}


def _lane_ssh(smi: str, out: dict) -> None:
    """The paper's road over a real SSH channel on loopback: config 1, the
    warm pool, the LM by RPC and the FSDP gang over two SSH addresses; the
    electrons ran in the workers, which report their counts, and ours (0
    after the reset unless the dispatcher launched one) are added.  The
    local lattice's overheads (lane b) stand beside the SSH ones."""
    from covalent_tpu_plugin_torch.ops import _kernels

    losses = _awaited("train")
    _kernels.reset_launch_counts()
    start = time.perf_counter()
    ssh_lines, ssh_launches, cache_launches = ssh_phase(losses["standard"])
    seconds = time.perf_counter() - start
    ssh_launches = {name: n + ssh_launches.get(name, 0)
                    for name, n in _kernels.launch_counts().items()}
    if "skipped" not in ssh_lines[0]:
        local = _awaited("lattice")
        for line in ssh_lines:
            if line.get("arm") == "config1":
                line["local_lattice"] = local.get("launch")
            for road, entry in (line.get("roads") or {}).items():
                entry["local_lattice"] = local.get(road)
    for line in ssh_lines:
        emit({"phase": "ssh", "card": smi, **line})
    emit({"phase": "ssh", "card": smi, "seconds": seconds, "flash_launches": ssh_launches})
    out.update(ssh_launches=ssh_launches, cache_launches=cache_launches,
               ssh_skipped="skipped" in ssh_lines[0])


def _lane_lifecycle_serving(smi: str, out: dict) -> None:
    """The lifecycle phase's second part: the serve cell over minissh, whose
    workers report the serving kernels' launches, against the ``session``
    phase's streams; then every lifecycle line."""
    from covalent_tpu_plugin_torch.ops import _kernels

    session = _awaited("session")
    start = time.perf_counter()
    lines, serving = lifecycle_phase(session["results"], parts=("serving",))
    first = out.pop("lifecycle")
    lines = first["lines"] + lines
    for line in lines:
        emit({"phase": "lifecycle", "card": smi, **line})
    emit({"phase": "lifecycle", "card": smi,
          "seconds": first["seconds"] + time.perf_counter() - start,
          "serving_launches": serving, "flash_launches": _kernels.launch_counts()})
    out.update(lifecycle_serving=serving, lifecycle_skipped="skipped" in lines[0])


def _lane_agent(smi: str, out: dict) -> None:
    """The native agent's roads, resident profiling, the per-session
    families and Pool targets: the electrons report their own launches (the
    RPC training electron ran in a --rpc-child), ours are added."""
    from covalent_tpu_plugin_torch.ops import _kernels

    losses, session = _awaited("train"), _awaited("session")
    _kernels.reset_launch_counts()
    start = time.perf_counter()
    launches = agent_phase(losses["standard"], session)
    launches = {name: n + launches.get(name, 0) for name, n in _kernels.launch_counts().items()}
    emit({"phase": "agent", "card": smi, "seconds": time.perf_counter() - start,
          "flash_launches": launches})
    out["agent_launches"] = launches


LANE_PHASES = {"lattice": _lane_lattice, "elastic_preempt": _lane_elastic_preempt,
               "gang": _lane_gang, "lifecycle_arms": _lane_lifecycle_arms, "ssh": _lane_ssh,
               "lifecycle_serving": _lane_lifecycle_serving, "agent": _lane_agent}


def lane_main(name: str) -> int:
    """One child lane: its phases in order, its lines on stdout (a file the
    main process prints once the lane is done), its results published as
    ``lane_<name>``.  SIGTERM (the main process giving up) unwinds it
    through every phase's clean-up."""
    import torch

    global _LANE
    _LANE = name
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the lattices' workflow config, one file a lane
    os.environ["COVALENT_TPU_CONFIG"] = str(WORK / f"config_{name}.toml")
    sys.path.insert(0, str(ROOT))
    smi = nvidia_smi()
    out: dict = {}
    for phase in LANES[name]:
        LANE_PHASES[phase](smi, out)
    _publish(f"lane_{name}", out)
    return 0


def _start_lanes() -> dict:
    env = dict(os.environ, CHIP_SMOKE_START=repr(_START))
    lanes = {}
    for name in LANES:
        with open(LANE_DIR / f"{name}.out", "w") as stdout:
            lanes[name] = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                            "--lane", name], stdout=stdout, env=env,
                                           cwd=str(ROOT))
    return lanes


def _check_lanes(lanes: dict) -> None:
    """Fail at once when a lane has failed, its last lines on stderr (its
    traceback is there already: a lane's stderr is ours)."""
    for name, proc in lanes.items():
        if proc.poll() not in (None, 0):
            tail = (LANE_DIR / f"{name}.out").read_text().splitlines()[-5:]
            print("\n".join(line[:2000] for line in tail), file=sys.stderr, flush=True)
            raise AssertionError(f"lane {name} failed (exit code {proc.returncode})")


def _join_lanes(lanes: dict) -> dict:
    """Each lane's results once it is done, its lines printed."""
    results = {}
    for name, proc in lanes.items():
        proc.wait(timeout=LANE_WAIT_S)
        _check_lanes({name: proc})
        results[name] = json.loads((LANE_DIR / f"lane_{name}.json").read_text())
    for name in lanes:
        for raw in (LANE_DIR / f"{name}.out").read_text().splitlines():
            print(raw, flush=True)
    return results


def _stop_lanes(lanes: dict) -> None:
    for proc in lanes.values():
        if proc.poll() is None:
            proc.terminate()
    for proc in lanes.values():
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def main() -> int:
    import concurrent.futures
    import shutil

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

    shutil.rmtree(LANE_DIR, ignore_errors=True)
    LANE_DIR.mkdir(parents=True)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    emit({"phase": "startup", "card": smi, **startup_phase()})

    # The build (nvcc, on the host's cores) beside the elastic phase's stall
    # arm, which needs no kernel and must see the card alone: an electron
    # that stops itself on attempt 1 is found stalled, escalated and
    # retried, and attempt 2 must not find attempt 1's process on the card.
    def timed_build():
        start = time.perf_counter()
        return _kernels.build(), time.perf_counter() - start

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(timed_build)
        start = time.perf_counter()
        stall = elastic_stall(before=_compute_apps())
        stall_s = time.perf_counter() - start
        libs, build_s = building.result()
    emit({"phase": "build", "seconds": build_s,
          "libraries": sorted(str(p.relative_to(ROOT)) for p in libs.values())})
    emit({"phase": "elastic", "card": smi, **stall})

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
    emit({"phase": "profile", "card": smi, **profile_phase()})

    # The small f32 LM of serve_check runs its serving products on the f32
    # CUDA-core route: that route's path.
    _kernels.reset_launch_counts()
    emit({"phase": "serve_check", **serve_check()})
    f32_path_launches = _kernels.serving_launch_counts()
    # The serving ops' rows at batch 1 and in a batch of 8, on the library
    # route (the diagnosis) and on the batch-invariant kernels (the repair),
    # then the kernels' times at the serve cell's shapes, a decode step's
    # profile and the int8-weight product's check and times (its line leaves
    # with the adapters phase's).
    start = time.perf_counter()
    invariance = batch_invariance_phase()
    emit({"phase": "batch_invariance", "card": smi, "seconds": time.perf_counter() - start,
          **invariance})
    serving_timing = serving_kernels_timing()
    emit({"phase": "serving_kernels", "card": smi, "shapes": serving_timing,
          "f32_rows_differ_alone": f32_rows_alone()})
    emit({"phase": "serve_profile", "card": smi, **serve_profile()})
    start = time.perf_counter()
    w8_check = {"arm": "w8_kernel", **w8_kernel_check(), "seconds": time.perf_counter() - start}
    moe_kernels = moe_kernel_arms()

    # The main path.  Each wrapper counts its launches in the process that
    # launches it; the electrons run in the harness subprocess, which starts
    # at 0 and reports its counts, so the path's launches are ours (0 after
    # the reset) plus the worker's.
    _kernels.reset_launch_counts()
    arms, lora_arms = train_phase()
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
    _publish("train", {arm["arm"]: arm["losses"] for arm in arms})

    # what this process cached on the card for the prefix goes back to it
    torch.cuda.empty_cache()
    lanes = _start_lanes()
    try:
        # Lane a.  The serving path.  Its attention over the KV cache runs
        # no flash kernel, and every product and norm takes the
        # batch-invariant kernels: the electron resets the launch counts in
        # its own process and reports them; the flash counts must stay 0,
        # the serving ones not.
        _kernels.reset_launch_counts()
        served = serve_phase()
        if any(_kernels.launch_counts().values()):
            raise AssertionError(f"serve: flash kernels launched {_kernels.launch_counts()}")
        serving_launches = {name: n + served["serving_launches"][name]
                            for name, n in _kernels.serving_launch_counts().items()}
        serve_streams = served.pop("_streams")
        emit({"phase": "serve", "card": smi, "lane": "a", **served})
        _check_lanes(lanes)
        # The resident session: the serve cell's traffic through
        # open_session, on frames and on JSON lines.
        start = time.perf_counter()
        session = session_phase(serve_streams)
        pool_session = {"results": session.pop("_results"),
                        "tokens_per_s": session["tokens_per_s"], "ttft_s": session["ttft_s"]}
        _publish("session", pool_session)
        emit({"phase": "session", "card": smi, "lane": "a",
              "seconds": time.perf_counter() - start, **session})
        _check_lanes(lanes)
        # Several resident workers on the card: a replica set, then a
        # disaggregated set, each with the serve cell's traffic.
        replicas, disagg = replica_phases(serve_streams)
        emit({"phase": "replicas", "card": smi, "lane": "a", **replicas})
        emit({"phase": "disagg", "card": smi, "lane": "a", **disagg})
        _check_lanes(lanes)
        # A journaling dispatcher crashes mid-burst and a second one adopts
        # its orphaned pool server; then a planned handoff and a SIGTERM
        # notice.
        emit({"phase": "recovery", "card": smi, "lane": "a", **recovery_phase(serve_streams)})
        _check_lanes(lanes)
        # Slice 3a: the LoRA fine-tune electrons (their worker reports their
        # flash launches) and one session hosting the four decode modes and
        # an adapter bank, whose worker reports the serving kernels'
        # launches: the int8 kernel's path.
        _kernels.reset_launch_counts()
        start = time.perf_counter()
        adapter_lines, adapter_serving = adapters_phase(pool_session, lora_arms, w8_check)
        lora_launches = {name: n + sum(line["launches"][name] for line in adapter_lines
                                       if line["arm"] == "lora_train")
                         for name, n in _kernels.launch_counts().items()}
        for line in adapter_lines:
            emit({"phase": "adapters", "card": smi, "lane": "a", **line})
        emit({"phase": "adapters", "card": smi, "lane": "a",
              "seconds": time.perf_counter() - start, "flash_launches": lora_launches,
              "serving_launches": adapter_serving})
        _check_lanes(lanes)
        # Slice 4, part 3(a): the MoE LM decoded in this process; the
        # engine's run is the path of its router's f32 product.
        start = time.perf_counter()
        moe_lines, moe_launches = serve_moe_phase(moe_kernels)
        for line in moe_lines:
            emit({"phase": "serve_moe", "card": smi, "lane": "a", **line})
        emit({"phase": "serve_moe", "card": smi, "lane": "a",
              "seconds": time.perf_counter() - start, "serving_launches": moe_launches})
        moe_parity = next(line for line in moe_lines if line["arm"] == "kernel_parity")
        lane = _join_lanes(lanes)
    finally:
        _stop_lanes(lanes)
    gang_launches, gang_arm_launches = lane["b"]["gang_launches"], lane["b"]["gang_arm_launches"]
    elastic_launches = lane["b"]["elastic_launches"]
    emit({"phase": "elastic", "card": smi, "seconds": stall_s + lane["b"]["elastic_s"],
          "flash_launches": elastic_launches})
    ssh_launches, cache_launches = lane["c"]["ssh_launches"], lane["c"]["cache_launches"]
    agent_launches, lifecycle_serving = lane["c"]["agent_launches"], lane["c"]["lifecycle_serving"]

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
            "elastic_launches": elastic_launches.get(kernel.name, 0),
            "cache_miss_launches": cache_launches.get(kernel.name, 0),
            "lora_launches": lora_launches.get(kernel.name, 0),
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
        if ssh_launches.get(kernel.name, 0) < 1 and not lane["c"]["ssh_skipped"]:
            raise AssertionError(f"{kernel.name} was not launched on the ssh phase's path")
        if agent_launches.get(kernel.name, 0) < 1:
            raise AssertionError(f"{kernel.name} was not launched on the agent phase's path")
        if elastic_launches.get(kernel.name, 0) < 1:
            raise AssertionError(f"{kernel.name} was not launched on the elastic phase's path")
        if cache_launches.get(kernel.name, 0) < 1 and not lane["c"]["ssh_skipped"]:
            raise AssertionError(f"{kernel.name} was not launched on the cache arm's misses")
        if lora_launches.get(kernel.name, 0) < 1:
            raise AssertionError(f"{kernel.name} was not launched by the LoRA fine-tune")
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
                 if k.startswith("bi_gemm."))),
            (_kernels.BI_RMSNORM, "bi_rmsnorm.add.m8",
             max(errs[stage][op]["max_abs_err"] for stage in errs
                 for op in ("rmsnorm", "add_rmsnorm")))):
        res = serving_timing[key]
        on_serve = kernel.name in SERVING_ROUTES_ON_PATH
        launches = serving_launches[kernel.name] if on_serve else f32_path_launches[kernel.name]
        # the MoE decode's products at its decode step (serve_moe)
        moe_shapes = {k: v for k, v in moe_parity.items() if k.startswith(kernel.name + ".")}
        kernels.append({
            "name": kernel.name, "route": "cuda",
            "source": f"covalent_tpu_plugin_torch/csrc/{kernel.source}",
            "replaces": kernel.replaces, "launches": launches,
            "path": "serve" if on_serve else "serve_check (f32 LM)",
            "serve_launches": serving_launches[kernel.name],
            "serve_moe_launches": moe_launches[kernel.name],
            "ssh_session_launches": lifecycle_serving.get(kernel.name, 0),
            "max_abs_err": err, "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["library_ms"], "shape": key,
            "shapes": {**{k: v for k, v in serving_timing.items()
                          if k.startswith(kernel.name + ".")}, **moe_shapes},
        })
        if launches < 1:
            raise AssertionError(f"{kernel.name} was not launched on its path")
        if moe_launches[kernel.name] < 1:
            raise AssertionError(f"{kernel.name} was not launched on the MoE engine's path")
        if on_serve and lifecycle_serving.get(kernel.name, 0) < 1 \
                and not lane["c"]["lifecycle_skipped"]:
            raise AssertionError(f"{kernel.name} was not launched on the serve cell over SSH")
    if serving_launches["bi_gemm"]:
        raise AssertionError(f"the bf16 serve path launched the f32 CUDA-core product "
                             f"{serving_launches['bi_gemm']} times")
    # The int8-weight product ports no Pallas kernel either: its path is the
    # adapters phase's session, whose int8 and full_quant lanes run it; the
    # row is the decode step's lm_head (8 rows), "shapes" has every other.
    w8 = w8_check["shapes"]["lm_head.m8"]
    kernels.append({
        "name": _kernels.BI_GEMM_W8.name, "route": "cuda",
        "source": f"covalent_tpu_plugin_torch/csrc/{_kernels.BI_GEMM_W8.source}",
        "replaces": _kernels.BI_GEMM_W8.replaces,
        "launches": adapter_serving.get(_kernels.BI_GEMM_W8.name, 0),
        "path": "adapters (modes_bank: the int8 and full_quant lanes)",
        "max_abs_err": max(r["max_abs_err"] for r in w8_check["shapes"].values()),
        "elements_differ_bi_gemm_tc": w8_check["elements_differ_bi_gemm_tc"],
        "ms": w8["ms"], "plain_ms": w8["plain_ms"], "bound_ms": w8["bound_ms"],
        "bound_by": w8["bound_by"], "library_ms": w8["library_ms"],
        "library_note": w8_check["library_note"], "shape": "bi_gemm_w8.lm_head.m8",
        "shapes": w8_check["shapes"],
    })
    if kernels[-1]["launches"] < 1:
        raise AssertionError("bi_gemm_w8 was not launched on the adapters session's path")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--lane"]:
        sys.exit(lane_main(sys.argv[2]))
    sys.exit(main())
