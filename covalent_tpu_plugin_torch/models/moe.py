"""Mixture-of-experts MLP: Switch-style top-1 routing, index dispatch.

Counterpart of ``covalent_tpu_plugin/models/moe.py``.  Semantics (Switch
Transformer), as the reference's:

* top-1 routing with softmax gate scaling, the router in float32;
* capacity ``C = ceil(capacity_factor * N / E)`` over the flattened token
  set; a token's slot is its rank among its expert's tokens in the flat
  token order (a cumsum), so the first tokens get the slots; tokens over
  capacity are dropped: the expert layer gives them zero and they ride the
  residual;
* dispatch and combine as exact index operations: the reference's one-hot
  dispatch and combine einsums have at most one nonzero term for each
  expert slot and each output row, so a gather gives their value bit for
  bit; the experts' products as E batches of stacked slots (plain PyTorch
  off the serving route: the reference computes them outside any Pallas
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

Serving.  The reference routes over whatever tokens a call holds: its
``generate`` applies the model to the whole (B, S) slab, so ``N = B * S``
(``N = B`` at a decode step), while its engine vmaps a batch-1 lane per
slot, so each row routes over its own tokens (``N`` = the row's padded
prompt bucket at admission, 1 at a decode step).  ``forward(x,
per_row=True)`` is the engine's mode: each row of ``x`` is a token set of
its own (a group), with its own ``N``, capacity and cumsum; the default
routes over one group of all B * S tokens.  Under ``batch_invariant`` (the
serving entry points' route, set by ``transformer.use_batch_invariant``)
the router goes through ``bi.linear`` in f32 (``csrc/bi_gemm.cu`` on the
card) and the two expert products through ``bi.linear_rows`` (one
``csrc/bi_gemm_tc.cu`` launch each, where a slot's bits do not depend on
the slots stacked beside it).  That route reads each expert's weight
k-contiguous, so it re-lays ``wi`` and ``wo`` in memory on the card
(:meth:`MoEMlp.serving_layout`: their strides change, not their shapes or
values).  Per-row mode and the batch-invariant route run on one process,
and compute the load-balance loss only where a gradient can use it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops import batch_invariant as bi
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
    #: the serving form on the batch-invariant kernels (module docstring)
    batch_invariant = False

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

    def forward(self, x, per_row: bool = False):
        """The layer on ``x`` (B, S, d): routed over all B * S tokens, or
        over each row's S alone with ``per_row`` (the serving engine's
        lanes)."""
        if (per_row or self.batch_invariant) and (self.tp is not None
                                                   or self.batch_mesh is not None):
            raise NotImplementedError(
                "the serving form of the MoE runs on one process (tensor-parallel decoding "
                "comes with ROADMAP Queue 1 item 1(b))")
        cfg = self.cfg
        batch, seq_len, d_model = x.shape
        n_experts = cfg.moe_experts
        # G groups of n tokens, each routed on its own
        groups, n_tokens = (batch, seq_len) if per_row else (1, batch * seq_len)
        tokens = x.reshape(groups, n_tokens, d_model)
        router = _local(self.router)
        if self.tp is not None:
            tokens, router = self.tp.enter(tokens), self.tp.enter(router)
        linear, linear_rows = (
            (bi.linear, bi.linear_rows) if self.batch_invariant
            else (bi.linear_plain, bi.linear_rows_plain))
        gates = torch.softmax(linear(tokens.float(), router, torch.float32), dim=-1)
        gate, index = gates.max(dim=-1)                            # (G, n), first maximum
        onehot = F.one_hot(index, n_experts).float()               # (G, n, E)
        # Each token's rank among its expert's tokens in its group's flat
        # (global) order, from 1: the first tokens get the slots.
        rank = torch.cumsum(onehot, dim=1)
        counts, total = rank[:, -1], n_tokens                      # (G, E)
        if self.batch_mesh is not None:                            # one group
            every, block = _gather_blocks(counts[0], self.batch_mesh)
            rank = rank + every[:block].sum(dim=0)
            counts, total = every.sum(dim=0)[None], n_tokens * len(every)
        capacity = int(-(-cfg.moe_capacity_factor * total // n_experts))  # ceil
        capacity = max(1, min(capacity, total))

        # Load-balance aux (Switch eq. 4): E * sum_e f_e * P_e, minimised at
        # uniform routing where it equals 1; the groups' terms summed, as the
        # reference's collect sums its lanes'.  Under tensor parallelism each
        # rank sums its own experts' terms.  Serving without a gradient
        # leaves it out.
        experts = slice(0, n_experts) if self.tp is None else self.tp.block(n_experts)
        self.aux = None
        if torch.is_grad_enabled() or not (per_row or self.batch_invariant):
            mass = gates.sum(dim=1)
            if self.batch_mesh is not None:
                mass = _psum_batch(mass, self.batch_mesh)
            terms = (counts / total) * (mass / total)
            aux = n_experts * terms[:, experts].sum()
            self.aux = aux if self.tp is None else self.tp.leave(aux)

        # Expert e's buffer holds the groups' C slots one after the other:
        # row g * C + slot of the (E, G * C) stack.  A token dropped, or
        # another rank's, points one row past the stack.  Dispatch and
        # combine are then exact index operations: each slot and each output
        # row has at most one nonzero term of the reference's one-hot einsums.
        position = rank.gather(2, index[..., None])[..., 0] - 1
        keep, local, width = position < capacity, index, n_experts
        if self.tp is not None:                                    # this rank's experts
            local, width = index - experts.start, experts.stop - experts.start
            keep = keep & (local >= 0) & (local < width)
        rows = groups * capacity
        first = torch.arange(groups, device=x.device)[:, None] * capacity
        dest = torch.where(keep, local * rows + first + position.long(), width * rows).reshape(-1)
        # Each kept token copied into its slot, the rest into a spare row cut
        # off after.  index_copy and index_select, not advanced indexing:
        # their backward is a gather and an index_add, where advanced
        # indexing's accumulates the spare row's many repeats one by one
        # (``tools/moe_train_steps.py`` times the two on the card).
        expert_in = tokens.new_zeros((width * rows + 1, d_model), dtype=cfg.dtype).index_copy(
            0, dest, tokens.reshape(-1, d_model).to(cfg.dtype))[:-1].view(width, rows, d_model)

        wi, wo = self._expert_weights()
        h = F.gelu(linear_rows(expert_in, wi, cfg.dtype), approximate="tanh")
        expert_out = linear_rows(h, wo, cfg.dtype).reshape(width * rows, d_model)
        # Combine: the gate-scaled return trip, one term a token; a dropped
        # token reads the zero row and keeps only its residual.
        picked = torch.cat([expert_out, expert_out.new_zeros((1, d_model))]).index_select(0, dest)
        out = picked * gate.reshape(-1, 1).to(cfg.dtype)
        if self.tp is not None:
            out = self.tp.leave(out)
        return out.reshape(batch, seq_len, d_model)

    def serving_layout(self) -> None:
        """Lay ``wi`` and ``wo`` out k-contiguous in memory on the card (a
        no-op elsewhere and once done), so the expert products read them in
        place.  ``transformer.use_batch_invariant`` calls it before a
        serving engine builds any twin that shares the weights."""
        for param in (self.wi, self.wo):
            if param.is_cuda and not param.transpose(1, 2).is_contiguous():
                with torch.no_grad():
                    param.data = param.data.transpose(1, 2).contiguous().transpose(1, 2)

    def _expert_weights(self):
        """This rank's ``wi`` and ``wo`` as (E, out, in) views, as the
        products take them (k-contiguous on the serving route)."""
        if self.batch_invariant:
            self.serving_layout()
        return _local(self.wi).transpose(1, 2), _local(self.wo).transpose(1, 2)


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
