"""Losses and the single-device train step; the LM and MNIST training electrons.

Counterpart of ``covalent_tpu_plugin/models/train.py`` for one device: the
step runs eagerly (PyTorch has no ``jit``).  The LM's optimizer is
``torch.optim.AdamW(lr=3e-4, weight_decay=1e-4, eps=1e-8)``, which matches
``optax.adamw(3e-4)``'s defaults; the classifier's is ``torch.optim.Adam``
at ``optax.adam(1e-3)``'s.  Meshes and sharded state come with the
scale-out slice.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import _kernels
from ..ops.xent import fused_cross_entropy
from .data import synthetic_lm_batches
from .mlp import MLP, MnistCNN, synthetic_mnist
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
    """Next-token loss over a {"tokens": (B, S)} batch.

    ``vocab_chunk`` switches to the fused vocab-chunked cross-entropy
    (``ops/xent.py``): the model returns its final features and the loss
    streams over lm_head chunks, so the (B, S, vocab) logits never exist.
    """
    tokens = _tokens(model, batch)
    if vocab_chunk is None:
        logits = model(tokens[:, :-1])
        return cross_entropy_loss(logits, tokens[:, 1:])
    feats = model(tokens[:, :-1], return_features=True)
    kernel = model.lm_head.weight
    if not kernel.is_floating_point():
        raise ValueError(
            "vocab_chunk needs a plain float lm_head kernel "
            "(quantized/LoRA heads take the standard path)"
        )
    flat = feats.reshape(-1, feats.shape[-1])
    labels = tokens[:, 1:].reshape(-1)
    return fused_cross_entropy(flat, kernel.t(), labels, vocab_chunk)


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor] = lm_loss,
    accumulate_steps: int = 1,
) -> Callable[[dict], dict]:
    """Build ``step(batch) -> {"loss", "grad_norm", "step"}``.

    ``accumulate_steps > 1`` enables gradient accumulation: every batch leaf
    carries a leading microbatch axis of that length, the gradients of the
    microbatches sum in the (f32) ``.grad`` buffers and are scaled by
    ``1/accumulate_steps`` before one optimizer step, so activation memory
    stays one microbatch.
    """
    params = [p for p in model.parameters() if p.requires_grad]
    count = 0

    def step(batch: dict) -> dict:
        nonlocal count
        optimizer.zero_grad(set_to_none=True)
        if accumulate_steps == 1:
            loss = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach()
        else:
            lead = {len(leaf) for leaf in batch.values()}
            if lead != {accumulate_steps}:
                raise ValueError(
                    f"accumulate_steps={accumulate_steps} but batch "
                    f"leaves have leading axis {sorted(lead)}; every "
                    "leaf needs a leading microbatch axis of that length"
                )
            loss = 0.0
            for i in range(accumulate_steps):
                micro = loss_fn(model, {key: leaf[i] for key, leaf in batch.items()})
                micro.backward()
                loss = loss + micro.detach()
            scale = 1.0 / accumulate_steps
            loss = loss * scale
            for p in params:
                p.grad.mul_(scale)
        grad_norm = torch.nn.utils.get_total_norm([p.grad for p in params])
        optimizer.step()
        count += 1
        return {"loss": loss, "grad_norm": grad_norm, "step": count}

    return step


def make_classifier_train_step(model: torch.nn.Module,
                               optimizer: torch.optim.Optimizer) -> Callable[[dict], dict]:
    """``step({"image", "label"}) -> {"loss", "grad_norm", "step"}``."""
    return make_train_step(model, optimizer, loss_fn=classifier_loss)


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
    **config_overrides,
) -> dict:
    """The slice's training electron: build the LM, take ``steps`` AdamW
    steps on the synthetic stream, return what happened.

    Defaults are the reference's ``lm_step`` bench arm: the 125M config at
    batch 8, seq 1024 (the batches hold ``seq_len + 1`` tokens because the
    loss shifts by one).  The weights come from a ``torch.Generator`` seeded
    with ``seed``, the batches from ``synthetic_lm_batches(seed=seed)``.  The
    launch counts of the CUDA kernels cover exactly these steps.
    """
    device = resolve_device(device)
    _reset_peak_memory(device)
    config = lm_125m_config(**config_overrides)
    generator = torch.Generator(device=device).manual_seed(seed)
    model = TransformerLM(config, device=device, generator=generator)
    step = make_train_step(
        model, adamw(model),
        loss_fn=lambda m, b: lm_loss(m, b, vocab_chunk=vocab_chunk),
    )
    batches = list(synthetic_lm_batches(
        steps=steps, batch_size=batch_size, seq_len=seq_len + 1,
        vocab_size=config.vocab_size, seed=seed,
    ))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    launched = _kernels.launch_counts()
    losses, step_s = [], []
    for batch in batches:
        sync()
        start = time.perf_counter()
        metrics = step(batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        sync()
        step_s.append(time.perf_counter() - start)
    return {
        "losses": losses,
        "step_s": step_s,
        "tokens_per_step": batch_size * seq_len,
        "launches": _launches_since(launched),
        "n_params": model.parameter_count(),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "peak_mem_bytes": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
    }


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
) -> dict:
    """The MNIST electron: the reference's ``mnist`` bench arm
    (``bench.py:1181-1253``), with the CNN beside the MLP.

    One pass over ``n_batches`` distinct batches of
    ``synthetic_mnist(batch_size, seed=i)`` from fresh weights (the loss
    curve), then ``epochs`` timed passes over the same batches.  Adam 1e-3;
    the weights come from a ``torch.Generator`` seeded with ``seed``.
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
    step = make_classifier_train_step(net, adam(net))
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
    return {
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
