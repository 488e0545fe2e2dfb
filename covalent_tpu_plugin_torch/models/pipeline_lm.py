"""Pipeline-parallel forward and loss for the transformer LM.

Counterpart of ``covalent_tpu_plugin/models/pipeline_lm.py``: glue between
the generic GPipe schedule (:mod:`..parallel.pipeline`) and
``TransformerLM``.  Each ``pipe`` rank holds the contiguous run of layers of
its stage (``parallel.sharding.apply_rules`` ->
``TransformerLM.pipeline_parallel``); the embedding, ``ln_final`` and the
lm_head are whole on every rank and run outside the pipelined region.  The
loss's backward through the schedule is the backward pipeline.  The stage's
layers are the model's own blocks, so ``remat`` holds inside the pipeline
too (``TransformerLM.run_layer``).

Every stage computes the head on the same broadcast outputs, so the head's
gradients are the same on every rank; the embedding's reaches only stage 0
and is summed over ``pipe`` (``parallel.pipeline.pipelined``).
"""

from __future__ import annotations

import torch

from ..parallel.pipeline import pipelined
from .train import _tokens, cross_entropy_loss
from .transformer import TransformerLM


def _stage_forward(model: TransformerLM, layers, x: torch.Tensor) -> torch.Tensor:
    """A stage's layers on the residual stream ``x`` (one microbatch)."""
    h = layers[0].ln_attn(x)
    for i, layer in enumerate(layers):
        after = layers[i + 1].ln_attn if i + 1 < len(layers) else None
        x, h = model.run_layer(layer, x, h, after)
    return x


def pipeline_lm_forward(
    model: TransformerLM,
    tokens: torch.Tensor,
    mesh,
    n_micro: int,
    axis_name: str = "pipe",
) -> torch.Tensor:
    """Logits for (B, S) tokens (this rank's rows) with the layers pipelined
    over ``mesh``'s ``pipe`` axis, ``n_micro`` microbatches deep."""
    cfg = model.config
    if cfg.moe_experts:
        raise ValueError("the pipelined block has a dense MLP (as the reference's): "
                         "moe_experts does not pipeline")
    if mesh[axis_name].size() > 1 and model.pipe_mesh is None:
        raise ValueError("the model is not split over pipe: "
                         "parallel.sharding.apply_rules(model, mesh) first")
    batch, seq_len = tokens.shape
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by n_micro {n_micro}")
    # Embedding: whole on every rank, outside the pipelined region.
    x = model._embed(tokens)
    micro = x.reshape(n_micro, batch // n_micro, seq_len, cfg.d_model)
    out = pipelined(lambda layers, h: _stage_forward(model, layers, h), mesh,
                    axis_name=axis_name)(model.layers, micro)
    # Final norm and head: whole on every rank, outside the pipeline.
    return model.lm_head(model.ln_final(out.reshape(batch, seq_len, cfg.d_model)))


def pipeline_lm_loss(
    model: TransformerLM,
    batch: dict,
    mesh,
    n_micro: int,
    axis_name: str = "pipe",
) -> torch.Tensor:
    """Next-token loss over ``{"tokens": (B, S + 1)}`` (this rank's rows),
    pipelined.  Differentiable: its backward is the pipeline's."""
    tokens = _tokens(model, batch)
    logits = pipeline_lm_forward(model, tokens[:, :-1], mesh, n_micro, axis_name)
    return cross_entropy_loss(logits, tokens[:, 1:])
