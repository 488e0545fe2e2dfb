"""Mixture-of-experts MLP: Switch-style top-1 routing, dense dispatch.

Counterpart of ``covalent_tpu_plugin/models/moe.py``.  Semantics (Switch
Transformer), as the reference's:

* top-1 routing with softmax gate scaling, the router in float32;
* capacity ``C = ceil(capacity_factor * N / E)`` over the flattened token
  set; a token's slot is its rank among its expert's tokens in the flat
  token order (a cumsum), so the first tokens get the slots; tokens over
  capacity are dropped: the expert layer gives them zero and they ride the
  residual;
* one-hot dispatch and combine tensors, and the experts' products as
  einsums (plain PyTorch: the reference computes them outside any Pallas
  kernel);
* the load-balance auxiliary loss ``E * sum_e f_e * P_e``.  Flax sows it
  into ``"intermediates"``; here each :class:`MoEMlp` keeps its last
  forward's in ``aux`` and :func:`collect_moe_aux` sums them.

Scale-out.  Experts shard over ``tensor`` (the rules' ``expert`` axis):
each rank routes every token, dispatches to its E / tensor experts and the
partial outputs meet in one all-reduce (a token's output is nonzero on the
one rank that holds its expert, so the sum is exact).  The router's
gradient from a rank covers its experts' tokens only, so it is summed over
the group, as is the input's.  Under a batch split over ``data``/``fsdp``
the reference traces the *global* batch: ``N``, the capacity and the
cumsum order run over the global token order and the aux's means are
global.  Each rank therefore offsets its slots by the per-expert counts of
the batch blocks before its own (an all-gather of the counts) and sums the
aux's means over the batch axes before their product.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import copy_to_group, reduce_from_group
from ..parallel.sharding import DEFAULT_RULES, _axes, _batch_block, _local, _mesh_axes_for


class MoEMlp(nn.Module):
    """Drop-in MLP replacement: route each token to one of ``moe_experts``.

    Parameters in the reference's layout: ``router`` (E, d) in PyTorch's
    ``(out, in)``, ``wi`` (E, d, d_ff) and ``wo`` (E, d_ff, d).
    """

    #: the ``parallel.sharding.TensorParallel`` handle under tensor parallelism
    tp = None
    #: the mesh when the batch is split over ``data``/``fsdp`` (``batch_parallel``)
    batch_mesh = None

    def __init__(self, cfg, device, generator):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff

        def param(shape, std):
            weight = torch.empty(shape, dtype=cfg.param_dtype, device=device)
            return nn.Parameter(nn.init.normal_(weight, 0.0, std, generator=generator))

        self.router = param((e, d), 0.02)
        self.wi = param((e, d, f), 0.02)
        self.wo = param((e, f, d), 0.02 / (2 * cfg.n_layers) ** 0.5)
        #: the load-balance loss of the last forward (a 0-dim f32 tensor)
        self.aux = None

    def tensor_parallel(self, tp) -> None:
        """Experts over ``tensor``: this rank holds ``tp.block(E)`` of them."""
        tp.block(self.cfg.moe_experts)  # refuses experts that do not split
        self.tp = tp

    def batch_parallel(self, mesh) -> None:
        """The mesh whose batch axes split the tokens: routing then follows
        the global token order (module docstring)."""
        if mesh["seq"].size() > 1:
            raise NotImplementedError(
                "moe_experts with seq > 1: a rank's part of the sequence is not a block "
                "of the global token order the routing follows")
        if _batch_block(mesh, DEFAULT_RULES)[1] > 1:
            self.batch_mesh = mesh

    def forward(self, x):
        cfg = self.cfg
        batch, seq_len, d_model = x.shape
        n_experts = cfg.moe_experts
        tokens = x.reshape(-1, d_model)
        router = _local(self.router)
        if self.tp is not None:
            tokens, router = self.tp.enter(tokens), self.tp.enter(router)
        gates = torch.softmax(F.linear(tokens.float(), router.float()), dim=-1)
        gate, index = gates.max(dim=-1)                            # (N,), first maximum
        onehot = F.one_hot(index, n_experts).float()               # (N, E)
        counts, mass = onehot.sum(dim=0), gates.sum(dim=0)
        offset = torch.zeros_like(counts)
        n_tokens = tokens.shape[0]
        if self.batch_mesh is not None:
            every, block = _gather_blocks(counts, self.batch_mesh)
            offset = every[:block].sum(dim=0)
            counts, n_tokens = every.sum(dim=0), n_tokens * len(every)
            mass = _psum_batch(mass, self.batch_mesh)
        capacity = int(-(-cfg.moe_capacity_factor * n_tokens // n_experts))  # ceil
        capacity = max(1, min(capacity, n_tokens))

        # Load-balance aux (Switch eq. 4): E * sum_e f_e * P_e, minimised at
        # uniform routing where it equals 1.  Under tensor parallelism each
        # rank sums its own experts' terms.
        experts = slice(0, n_experts) if self.tp is None else self.tp.block(n_experts)
        terms = (counts / n_tokens) * (mass / n_tokens)
        aux = n_experts * terms[experts].sum()
        self.aux = aux if self.tp is None else self.tp.leave(aux)

        # Each token's slot: its rank among its expert's tokens in the flat
        # (global) order; the dispatch tensor (N, local experts, C) is one-hot
        # in both, zero for a dropped token or another rank's expert.
        position = (torch.cumsum(onehot, dim=0) + offset).gather(1, index[:, None])[:, 0] - 1
        local = index - experts.start
        keep = (position < capacity) & (local >= 0) & (local < experts.stop - experts.start)
        width = experts.stop - experts.start
        dispatch = torch.zeros(tokens.shape[0], width, capacity, dtype=cfg.dtype,
                               device=x.device)
        # one write a token (0 where it is not kept): no duplicate index
        dispatch[torch.arange(tokens.shape[0], device=x.device), local.clamp(0, width - 1),
                 position.clamp(0, capacity - 1).long()] = keep.to(cfg.dtype)

        expert_in = torch.einsum("nec,nd->ecd", dispatch, tokens.to(cfg.dtype))
        h = torch.einsum("ecd,edf->ecf", expert_in, _local(self.wi).to(cfg.dtype))
        h = F.gelu(h, approximate="tanh")
        expert_out = torch.einsum("ecf,efd->ecd", h, _local(self.wo).to(cfg.dtype))
        # Combine: the gate-scaled return trip; a dropped token's dispatch row
        # is zero, so it keeps only its residual.
        combine = dispatch * gate[:, None, None].to(cfg.dtype)
        out = torch.einsum("nec,ecd->nd", combine, expert_out)
        if self.tp is not None:
            out = self.tp.leave(out)
        return out.reshape(batch, seq_len, d_model)


def _batch_axes(mesh) -> list[str]:
    return [a for a in _axes(_mesh_axes_for("batch", DEFAULT_RULES)) if mesh[a].size() > 1]


def _gather_blocks(value: torch.Tensor, mesh) -> tuple[torch.Tensor, int]:
    """Every batch block's ``value``, stacked in block order (the first batch
    axis outermost, as ``shard_batch`` cuts the rows), and this rank's block."""
    out = value[None]
    for axis in reversed(_batch_axes(mesh)):
        gathered = out.new_empty((mesh[axis].size() * len(out), *value.shape))
        dist.all_gather_into_tensor(gathered, out.contiguous(), group=mesh.get_group(axis))
        out = gathered
    return out, _batch_block(mesh, DEFAULT_RULES)[0]


def _psum_batch(value: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``value`` over the batch axes, differentiable as the
    reference's ``psum``: each rank's gradient is the sum of every rank's
    (each rank's loss holds the same aux, and the step averages the ranks'
    gradients)."""
    for axis in _batch_axes(mesh):
        group = mesh.get_group(axis)
        value = copy_to_group(reduce_from_group(value, group), group)
    return value


def collect_moe_aux(model: nn.Module) -> torch.Tensor:
    """The sum of every :class:`MoEMlp`'s load-balance loss from the last
    forward (0 for a model without experts)."""
    auxes = [m.aux for m in model.modules() if isinstance(m, MoEMlp) and m.aux is not None]
    return sum(auxes) if auxes else torch.zeros(())


def lm_loss_with_moe_aux(model: nn.Module, batch: dict, aux_weight: float = 0.01,
                         vocab_chunk: int | None = None) -> torch.Tensor:
    """Next-token loss plus the weighted MoE load-balance loss: use in place of
    ``train.lm_loss`` for MoE configs; ``make_train_step`` takes it as it is."""
    from .train import lm_loss

    loss = lm_loss(model, batch, vocab_chunk=vocab_chunk)
    return loss + aux_weight * collect_moe_aux(model)
