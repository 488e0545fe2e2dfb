"""Pipeline parallelism: a GPipe microbatch schedule over a mesh axis.

Counterpart of ``covalent_tpu_plugin/parallel/pipeline.py``.  Each rank of
the ``pipe`` axis holds one stage (a contiguous run of layers,
:func:`pipeline_stages`); the schedule runs ``M + S - 1`` ticks, and at tick
``t`` stage ``s`` works on microbatch ``t - s`` (the GPipe diagonal; the
``S - 1`` edge ticks are the bubble).  Activations hop from stage ``s`` to
``s + 1`` after each tick, by the ring permute of
``parallel/collectives.py`` (an ``all_to_all_single``: gloo has no
point-to-point sends on tensors on the card), as the reference's
``lax.ppermute``.  Autograd through the ticks and hops gives the backward
schedule: each hop's gradient goes back by the reverse permute.

Two departures from the reference, neither of which changes a result:

* a stage computes nothing on its bubble ticks (the reference computes a
  value there that no stage reads); every rank still joins every hop;
* the hops are threaded on a 0-dim order token, which the output carries
  (as ``+ 0``).  Each rank's backward then runs every hop's reverse permute,
  those whose activation no stage read included, in reverse tick order, so
  the ranks' collectives pair up as the reference's transposed schedule
  does.  The hop after the last tick, which carries nothing a stage reads,
  is left out on every rank.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .collectives import _ring_permute, copy_to_group, reduce_from_group


def pipeline_stages(layers: Any, n_stages: int) -> Any:
    """Split the layers into ``n_stages`` contiguous stages: a tensor with a
    leading layer axis into ``(n_stages, layers_per_stage, ...)``, a
    sequence (an ``nn.ModuleList``) into a list of ``n_stages`` lists."""
    count = layers.shape[0] if isinstance(layers, torch.Tensor) else len(layers)
    if count % n_stages:
        raise ValueError(
            f"layer axis {count} not divisible by "
            f"{n_stages} pipeline stages"
        )
    per = count // n_stages
    if isinstance(layers, torch.Tensor):
        return layers.reshape(n_stages, per, *layers.shape[1:])
    layers = list(layers)
    return [layers[i * per:(i + 1) * per] for i in range(n_stages)]


class _Hop(torch.autograd.Function):
    """One tick's hop (stage ``s`` to ``s + 1``), ordered by a token: the
    hop's backward needs the token's gradient, which the next hop's backward
    gives, so the reverse permutes run in reverse tick order on every rank."""

    @staticmethod
    def forward(ctx, y, token, group):
        ctx.group = group
        return _ring_permute(y.contiguous(), group, 1), token.clone()

    @staticmethod
    def backward(ctx, grad, grad_token):
        return _ring_permute(grad.contiguous(), ctx.group, -1), grad_token, None


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,
    mesh,
    *,
    axis_name: str = "pipe",
) -> torch.Tensor:
    """This rank's GPipe schedule.

    ``stage_params`` is this rank's stage; ``microbatches`` is ``(M, ...)``
    and the same on every stage (stage 0 reads it).  ``stage_fn(stage_params,
    x) -> y`` must keep ``x``'s shape.  Returns this stage's ``(M, ...)``
    outputs: the pipeline's on the last stage, zeros on the others
    (:func:`pipelined` takes the last stage's).
    """
    group = mesh.get_group(axis_name)
    n_stages, stage = mesh[axis_name].size(), mesh.get_local_rank(axis_name)
    n_micro = microbatches.shape[0]
    token = microbatches.new_zeros(())
    if torch.is_grad_enabled():
        token.requires_grad_()
        if microbatches.requires_grad:
            # every rank's microbatches on the graph, stage 0's read or not
            token = token + microbatches.reshape(-1)[0] * 0
    recv = torch.zeros_like(microbatches[0])
    outputs = [torch.zeros_like(recv) for _ in range(n_micro)]
    ticks = n_micro + n_stages - 1
    for t in range(ticks):
        m = t - stage
        if 0 <= m < n_micro:
            y = stage_fn(stage_params, microbatches[m] if stage == 0 else recv)
            if stage == n_stages - 1:
                outputs[m] = y
        else:
            y = torch.zeros_like(recv)  # the bubble: nothing to compute
        if t < ticks - 1:
            recv, token = _Hop.apply(y, token, group)
    return torch.stack(outputs) + token


def pipelined(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh,
    *,
    axis_name: str = "pipe",
) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """Wrap ``stage_fn`` into a pipeline over ``mesh``'s ``axis_name`` axis.

    Returns ``fn(stage_params, microbatches) -> outputs``: ``stage_params``
    is this rank's stage, ``microbatches`` ``(M, B, ...)`` this rank's rows
    (its block of the batch over the data axes, the same on every stage), and
    the outputs the last stage's, on every stage.  The microbatches'
    gradient is summed over the axis (the reference's replicated input):
    only stage 0 reads them.
    """
    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis_name!r}: {mesh.mesh_dim_names}")

    def fn(stage_params, microbatches):
        group = mesh.get_group(axis_name)
        if microbatches.requires_grad:
            microbatches = copy_to_group(microbatches, group)
        outputs = pipeline_apply(stage_fn, stage_params, microbatches, mesh,
                                 axis_name=axis_name)
        return _broadcast_from_last(outputs, mesh, axis_name)

    return fn


def _broadcast_from_last(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """Every stage gets the last stage's value (the sum of a one-hot mask).
    The gradient is not summed: every stage computes the same loss from it."""
    is_last = mesh.get_local_rank(axis_name) == mesh[axis_name].size() - 1
    # x * 0, not zeros: the order token stays on every rank's graph
    return reduce_from_group(x * float(is_last), mesh.get_group(axis_name))
