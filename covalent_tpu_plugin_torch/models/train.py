"""Losses and the single-device train step; the LM and MNIST training electrons.

Counterpart of ``covalent_tpu_plugin/models/train.py``: the step runs
eagerly (PyTorch has no ``jit``).  The LM's optimizer is
``torch.optim.AdamW(lr=3e-4, weight_decay=1e-4, eps=1e-8)``, which matches
``optax.adamw(3e-4)``'s defaults; the classifier's is ``torch.optim.Adam``
at ``optax.adam(1e-3)``'s.

Sharded training (``make_sharded_train_state``, ``make_train_step(...,
mesh=...)``): every rank of a gang (one process a device) builds the same
weights, shards them over the mesh (``parallel.sharding.apply_rules``) and
takes each step on its rows of the global batch (and, over ``seq``, on its
part of every sequence; over ``pipe``, through the GPipe schedule of
``models/pipeline_lm.py``).  The step's ``loss`` is the global mean and its
``grad_norm`` the norm of the whole gradient, as the reference's jitted step
reports them.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import _kernels
from ..ops.xent import (
    fused_cross_entropy,
    vocab_parallel_cross_entropy,
    vocab_parallel_fused_cross_entropy,
)
from ..parallel.sharding import _local
from .data import synthetic_lm_batches
from .mlp import MLP, MnistCNN, synthetic_mnist
from .moe import collect_moe_aux, lm_loss_with_moe_aux
from .transformer import TransformerLM, lm_125m_config, resolve_device


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy in float32 over integer labels."""
    if labels.is_floating_point() or labels.dtype == torch.bool:
        # optax's integer-label cross-entropy refuses these as well
        raise TypeError(f"labels must be integers, got {labels.dtype}")
    losses = F.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]), labels.reshape(-1).long(),
        reduction="none",
    ).reshape(labels.shape)
    if mask is not None:
        return (losses * mask).sum() / mask.sum().clamp_min(1)
    return losses.mean()


def _on_model(model: torch.nn.Module, value) -> torch.Tensor:
    """``value`` (a tensor, or any array numpy reads) on the model's device."""
    device = next(model.parameters()).device
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(np.asarray(value), device=device)


def _tokens(model: torch.nn.Module, batch: dict) -> torch.Tensor:
    return _on_model(model, batch["tokens"]).long()


def classifier_loss(model: torch.nn.Module, batch: dict) -> torch.Tensor:
    """Integer-label softmax cross-entropy of ``model(batch["image"])``, mean
    over the batch: ``optax.softmax_cross_entropy_with_integer_labels(
    logits.astype(f32), labels).mean()``, as the reference's."""
    logits = model(_on_model(model, batch["image"]))
    return cross_entropy_loss(logits, _on_model(model, batch["label"]))


def lm_loss(model: torch.nn.Module, batch: dict, vocab_chunk: int | None = None):
    """Next-token loss over a {"tokens": (B, S)} batch: the mean over its
    tokens.

    A rank of a mesh with ``seq`` > 1 takes its part of the sequence
    instead, ``{"tokens", "labels", "positions"}``
    (``parallel.sharding.shard_batch``): the inputs, the labels cut from the
    globally shifted sequence and the rows' global positions; the loss is
    then the mean over this rank's tokens.

    ``vocab_chunk`` switches to the fused vocab-chunked cross-entropy
    (``ops/xent.py``): the model returns its final features and the loss
    streams over lm_head chunks, so the (B, S, vocab) logits never exist.
    Under tensor parallelism each rank streams its block of the vocabulary.
    """
    tokens = _tokens(model, batch)
    if "labels" in batch:
        inputs, labels = tokens, _on_model(model, batch["labels"]).long()
        positions = _on_model(model, batch["positions"])
    else:
        inputs, labels, positions = tokens[:, :-1], tokens[:, 1:], None
    tp = getattr(model, "tp", None)
    if vocab_chunk is None:
        logits = model(inputs, positions=positions)
        if tp is not None:
            return vocab_parallel_cross_entropy(logits, labels, tp, model.vocab_block())
        return cross_entropy_loss(logits, labels)
    feats = model(inputs, return_features=True, positions=positions)
    kernel = _local(model.lm_head.weight)
    if not kernel.is_floating_point():
        raise ValueError(
            "vocab_chunk needs a plain float lm_head kernel "
            "(quantized/LoRA heads take the standard path)"
        )
    flat, labels = feats.reshape(-1, feats.shape[-1]), labels.reshape(-1)
    if tp is not None:
        return vocab_parallel_fused_cross_entropy(tp.enter(flat), kernel.t(), labels, tp,
                                                  model.vocab_block(), vocab_chunk)
    return fused_cross_entropy(flat, kernel.t(), labels, vocab_chunk)


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor] = lm_loss,
    accumulate_steps: int = 1,
    mesh=None,
) -> Callable[[dict], dict]:
    """Build ``step(batch) -> {"loss", "grad_norm", "step"}``.

    ``accumulate_steps > 1`` enables gradient accumulation: every batch leaf
    carries a leading microbatch axis of that length, the gradients of the
    microbatches sum in the (f32) ``.grad`` buffers and are scaled by
    ``1/accumulate_steps`` before one optimizer step, so activation memory
    stays one microbatch.

    With ``mesh`` (a model sharded over it, :func:`make_sharded_train_state`)
    ``batch`` is the global batch: each rank takes its rows
    (``parallel.sharding.shard_batch``; over ``seq`` also its part of every
    sequence, in the model's layout; with accumulation, its rows of every
    microbatch), the gradients are averaged over the batch axes (by FSDP2,
    or over ``data`` for plain replicas) and over ``seq``, ``loss`` is
    averaged over them too and ``grad_norm`` covers every shard and every
    pipeline stage's layers once.  Under FSDP2 the microbatches before the
    last skip their gradient reduce-scatter (the gradients accumulate
    unsharded, and the last microbatch's backward reduces their sum).
    """
    from ..parallel import sharding

    params = [p for p in model.parameters() if p.requires_grad]
    staged = {id(p) for p in getattr(model, "stage_parameters", list)()}
    count = 0
    sync = getattr(model, "set_requires_gradient_sync", None) if accumulate_steps > 1 else None

    def step(batch: dict) -> dict:
        nonlocal count
        if accumulate_steps == 1:
            parts = [batch]
        else:
            lead = {len(leaf) for leaf in batch.values()}
            if lead != {accumulate_steps}:
                raise ValueError(
                    f"accumulate_steps={accumulate_steps} but batch "
                    f"leaves have leading axis {sorted(lead)}; every "
                    "leaf needs a leading microbatch axis of that length"
                )
            parts = [{key: leaf[i] for key, leaf in batch.items()}
                     for i in range(accumulate_steps)]
        optimizer.zero_grad(set_to_none=True)
        loss = 0.0
        for i, part in enumerate(parts):
            if mesh is not None:
                part = sharding.shard_batch(part, mesh, zigzag=_zigzag(model, mesh, part))
            if sync is not None:
                sync(i == accumulate_steps - 1)
            micro = loss_fn(model, part)
            micro.backward()
            loss = loss + micro.detach()
        if accumulate_steps > 1:
            scale = 1.0 / accumulate_steps
            loss = loss * scale
            for p in params:
                p.grad.mul_(scale)
        if mesh is None:
            grad_norm = torch.nn.utils.get_total_norm([p.grad for p in params])
        else:
            sharding.average_gradients(model, mesh)
            grad_norm = sharding.global_norm(
                [p.grad for p in params if id(p) not in staged], mesh,
                stage_tensors=[p.grad for p in params if id(p) in staged])
            loss = sharding.batch_mean(loss, mesh)
        optimizer.step()
        count += 1
        return {"loss": loss, "grad_norm": grad_norm, "step": count}

    return step


def _zigzag(model: torch.nn.Module, mesh, batch: dict) -> bool:
    """The sequence layout of a batch split over ``seq``: the model's
    (``TransformerLM.sequence_zigzag``) for the sequence the loss reads."""
    if mesh["seq"].size() == 1:
        return False
    return model.sequence_zigzag(len(batch["tokens"][0]) - 1, mesh["seq"].size())


def make_classifier_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                               mesh=None) -> Callable[[dict], dict]:
    """``step({"image", "label"}) -> {"loss", "grad_norm", "step"}``;
    data-parallel over ``mesh`` when given (the reference's
    ``make_classifier_train_step(mesh, ...)``)."""
    return make_train_step(model, optimizer, loss_fn=classifier_loss, mesh=mesh)


def make_sharded_train_state(model: torch.nn.Module,
                             optimizer: Callable[[torch.nn.Module], torch.optim.Optimizer],
                             mesh, rules=None) -> tuple:
    """Shard ``model`` over ``mesh`` per the logical rules, then build its
    optimizer on the shards: ``(model, optimizer, shardings)``, where
    ``shardings`` maps each parameter to the mesh axes of its dimensions
    (``parallel.sharding.param_shardings``).  ``optimizer`` is a factory
    such as :func:`adamw`.  Every rank calls it on identical weights."""
    from ..parallel import sharding

    rules = sharding.DEFAULT_RULES if rules is None else rules
    shardings = sharding.param_shardings(model, mesh, rules)
    if getattr(model, "mesh", None) is None:
        sharding.apply_rules(model, mesh, rules)
    return model, optimizer(model), shardings


def adam(model: torch.nn.Module) -> torch.optim.Adam:
    """``optax.adam(1e-3)``: eps 1e-8 outside the square root, no eps_root,
    bias correction; the fused implementation, chosen explicitly."""
    return torch.optim.Adam(
        model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8, fused=True
    )


def adamw(model: torch.nn.Module) -> torch.optim.AdamW:
    """``optax.adamw(3e-4)`` with its defaults, as the reference trains."""
    return torch.optim.AdamW(
        model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )


def train_lm(
    steps: int = 5,
    batch_size: int = 8,
    seq_len: int = 1024,
    vocab_chunk: int | None = None,
    seed: int = 0,
    device=None,
    mesh_plan=None,
    accumulate_steps: int = 1,
    n_micro: int | None = None,
    **config_overrides,
) -> dict:
    """The slice's training electron: build the LM, take ``steps`` AdamW
    steps on the synthetic stream, return what happened.

    Defaults are the reference's ``lm_step`` bench arm: the 125M config at
    batch 8, seq 1024 (the batches hold ``seq_len + 1`` tokens because the
    loss shifts by one).  The weights come from a ``torch.Generator`` seeded
    with ``seed``, the batches from ``synthetic_lm_batches(seed=seed)``.  The
    launch counts of the CUDA kernels cover exactly these steps.

    ``mesh_plan`` (a ``parallel.MeshPlan``) trains as one rank of a gang: the
    process group is open (a gang electron's harness opens it), every rank
    builds the same weights, shards them over the plan's mesh and steps on
    its rows of the same global batches.  ``losses`` are then the global
    means, and ``ranks`` holds each rank's launches, the query shapes (and
    output types) its flash kernels took, its peak memory and step times
    (:func:`gang_report`).  Under ``MeshPlan(seq=n)`` with
    ``attention="ring"`` or ``"ulysses"`` each rank also takes its part of
    every sequence: the ring's kernels then take ``(B, H, S / n, D)`` with
    f32 outputs, a hop each.  Under ``MeshPlan(pipe=n)`` each rank holds its
    stage's layers and the step runs the GPipe schedule of ``n_micro``
    microbatches (``models.pipeline_lm.pipeline_lm_loss``).

    ``accumulate_steps`` > 1 cuts each batch into that many microbatches of
    ``batch_size / accumulate_steps`` rows and takes one optimizer step on
    their mean gradient.  A config with ``moe_experts`` trains on
    ``models.moe.lm_loss_with_moe_aux`` (aux weight 0.01).
    """
    if batch_size % accumulate_steps:
        raise ValueError(f"batch {batch_size} does not split into {accumulate_steps} "
                         "microbatches")
    device = resolve_device(device)
    _reset_peak_memory(device)
    config = lm_125m_config(**config_overrides)
    generator = torch.Generator(device=device).manual_seed(seed)
    model = TransformerLM(config, device=device, generator=generator)
    mesh = None if mesh_plan is None else gang_mesh(mesh_plan, device)
    if mesh is None:
        optimizer = adamw(model)
    else:
        model, optimizer, _ = make_sharded_train_state(model, adamw, mesh)
    if mesh is not None and mesh_plan.pipe > 1:
        from .pipeline_lm import pipeline_lm_loss

        if n_micro is None or vocab_chunk is not None:
            raise ValueError(f"mesh plan {mesh_plan.sizes} needs n_micro, the microbatch "
                             "count, and takes the standard loss (no vocab_chunk)")

        def loss_fn(m, b):
            return pipeline_lm_loss(m, b, mesh, n_micro)
    elif config.moe_experts:
        def loss_fn(m, b):
            return lm_loss_with_moe_aux(m, b, vocab_chunk=vocab_chunk)
    else:
        def loss_fn(m, b):
            return lm_loss(m, b, vocab_chunk=vocab_chunk)
    step = make_train_step(model, optimizer, loss_fn=loss_fn,
                           accumulate_steps=accumulate_steps, mesh=mesh)
    batches = [{"tokens": b["tokens"].reshape(accumulate_steps, -1, seq_len + 1)}
               if accumulate_steps > 1 else b
               for b in synthetic_lm_batches(steps=steps, batch_size=batch_size,
                                             seq_len=seq_len + 1,
                                             vocab_size=config.vocab_size, seed=seed)]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    launched = _kernels.launch_counts()
    shapes = _kernels.launch_shapes()
    losses, step_s = [], []
    moe_aux = []
    for batch in batches:
        sync()
        start = time.perf_counter()
        metrics = step(batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        sync()
        step_s.append(time.perf_counter() - start)
        if config.moe_experts:
            moe_aux.append(float(collect_moe_aux(model).detach()))
    result = {
        "losses": losses,
        # the MoE load-balance loss of each step's last forward, summed over layers
        **({"moe_aux": moe_aux} if config.moe_experts else {}),
        "step_s": step_s,
        "tokens_per_step": batch_size * seq_len,
        "launches": _launches_since(launched),
        "launch_shapes": _shapes_since(shapes),
        "n_params": model.parameter_count(),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "peak_mem_bytes": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
    }
    return result if mesh is None else gang_report(result, mesh)


def gang_mesh(mesh_plan, device: torch.device):
    """The plan's mesh over the open process group, on ``device``'s type; the
    group must hold exactly the plan's ranks."""
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "mesh_plan needs the gang's process group: run the electron with "
            "GPUExecutor(workers=[...]), whose harness opens it")
    if dist.get_world_size() != mesh_plan.total():
        raise ValueError(f"mesh plan {mesh_plan.sizes} needs {mesh_plan.total()} processes, "
                         f"the gang has {dist.get_world_size()}")
    return make_mesh(mesh_plan, device_type=device.type)


def gang_report(result: dict, mesh) -> dict:
    """``result`` (this rank's) with the gang's view: the mesh, the backend,
    the world size and ``ranks``, each rank's device, launches, launch
    shapes, peak memory and step times, in rank order."""
    import torch.distributed as dist

    from ..parallel.mesh import mesh_plan

    mine = {key: result.get(key) for key in (
        "device", "launches", "launch_shapes", "peak_mem_bytes", "step_s", "steps_per_s")}
    mine["rank"] = dist.get_rank()
    ranks: list = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return {**result, "mesh": mesh_plan(mesh).sizes, "backend": dist.get_backend(),
            "world_size": dist.get_world_size(), "ranks": ranks}


def _shapes_since(before: dict) -> dict:
    """The flash launches by query shape since ``before``."""
    now = _kernels.launch_shapes()
    return {name: {shape: n - before.get(name, {}).get(shape, 0)
                   for shape, n in shapes.items()
                   if n - before.get(name, {}).get(shape, 0)}
            for name, shapes in now.items()}


def _reset_peak_memory(device: torch.device) -> None:
    """Start the card's peak-memory counter at this electron: in a resident
    worker (an RPC electron) the process-lifetime peak would carry earlier
    electrons'.  Electrons that run at the same time in one process share
    the counter."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _launches_since(before: dict) -> dict:
    """The kernel launches of this process since ``before``: the
    electron's own, unless another ran beside it in the same process (RPC
    electrons at the same time share the counters)."""
    return {name: n - before.get(name, 0) for name, n in _kernels.launch_counts().items()}


def train_mnist(
    model: str = "mlp",
    batch_size: int = 256,
    n_batches: int = 64,
    epochs: int = 3,
    seed: int = 0,
    device=None,
    mesh_plan=None,
) -> dict:
    """The MNIST electron: the reference's ``mnist`` bench arm
    (``bench.py:1181-1253``), with the CNN beside the MLP.

    One pass over ``n_batches`` distinct batches of
    ``synthetic_mnist(batch_size, seed=i)`` from fresh weights (the loss
    curve), then ``epochs`` timed passes over the same batches.  Adam 1e-3;
    the weights come from a ``torch.Generator`` seeded with ``seed``.

    ``mesh_plan`` (``MeshPlan(data=N)``, BASELINE config 4's data-parallel
    CNN) trains as one rank of a gang, as :func:`train_lm` does: each step
    takes this rank's rows of the global batch of ``batch_size``, the
    gradients are averaged over ``data`` and the losses are global means.
    """
    device = resolve_device(device)
    _reset_peak_memory(device)
    builders = {"mlp": MLP, "cnn": MnistCNN}
    if model not in builders:
        raise ValueError(f"model must be one of {sorted(builders)}, got {model!r}")
    generator = torch.Generator(device=device).manual_seed(seed)
    net = builders[model](device=device, generator=generator)
    stream = [synthetic_mnist(batch_size, seed=i) for i in range(n_batches)]
    images = torch.as_tensor(np.stack([b["image"] for b in stream]), device=device)
    labels = torch.as_tensor(np.stack([b["label"] for b in stream]), device=device)
    mesh = None if mesh_plan is None else gang_mesh(mesh_plan, device)
    if mesh is not None:
        net, optimizer, _ = make_sharded_train_state(net, adam, mesh)
    else:
        optimizer = adam(net)
    step = make_classifier_train_step(net, optimizer, mesh=mesh)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    launched = _kernels.launch_counts()

    def epoch() -> torch.Tensor:
        return torch.stack([
            step({"image": images[i], "label": labels[i]})["loss"] for i in range(n_batches)
        ])

    curve = epoch().tolist()  # fresh weights; waits for the pass
    sync()
    start = time.perf_counter()
    for _ in range(epochs):
        last = epoch()
    final = float(last[-1])  # waits for the last step
    sync()
    elapsed = time.perf_counter() - start
    result = {
        "model": model,
        "batch_size": batch_size,
        "n_batches": n_batches,
        "epochs": epochs,
        "losses": curve,
        "loss_first": statistics.fmean(curve[:4]),
        "loss_last": statistics.fmean(curve[-4:]),
        "loss_final_epoch": final,
        "steps_per_s": epochs * n_batches / elapsed,
        "launches": _launches_since(launched),
        "n_params": sum(p.numel() for p in net.parameters()),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "peak_mem_bytes": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
    }
    return result if mesh is None else gang_report(result, mesh)
