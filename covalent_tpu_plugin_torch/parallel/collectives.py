"""Collectives over one axis of a device mesh.

Counterpart of ``covalent_tpu_plugin/parallel/collectives.py``, whose
wrappers run inside ``shard_map`` with the reference's ``tiled=True``
semantics.  Here each takes the mesh axis name and the mesh, and runs on
that axis's process group (``mesh.get_group(axis_name)``) with
``torch.distributed``'s own collectives; the order of a gathered or
scattered axis is the rank order along the mesh axis, as in the reference.
None mutates its input.  :func:`ring_permute` and :func:`all_to_all` are
differentiable (ring and Ulysses attention train through them, as the
reference differentiates through ``ppermute`` and ``all_to_all``): the
gradient of a permute by ``shift`` is the permute by ``-shift``, that of an
all-to-all the all-to-all with the split and concatenated axes swapped.
The others are forward-only.

What a backend carries differs: gloo with tensors on the card has every
collective these functions use except point-to-point sends
(``parallel.probe``, the probe run on the H100: ``send``/``recv`` abort the
process).  So :func:`ring_permute` is an ``all_to_all_single`` in which each
rank sends its whole tensor to one peer, on every backend.

The model's tensor-parallel layers differentiate through two regions
(Megatron's f and g): :func:`copy_to_group` (identity forward, the sum of
the group's gradients backward) before a column-parallel product, and
:func:`reduce_from_group` (the group's sum forward, identity backward)
after a row-parallel one.  Their sums run in float32 for 16-bit inputs: a
sum of two ranks then rounds once, as one 16-bit add does, and no backend
needs a 16-bit reduction.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _group(axis_name: str, mesh):
    return mesh.get_group(axis_name)


def psum(x: torch.Tensor, axis_name: str, mesh) -> torch.Tensor:
    """Sum across the named mesh axis."""
    out = x.clone()
    dist.all_reduce(out, group=_group(axis_name, mesh))
    return out


def all_gather(x: torch.Tensor, axis_name: str, mesh, *, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Gather every member's shard along ``axis`` (``tiled``: concatenated;
    otherwise stacked on a new ``axis``)."""
    group = _group(axis_name, mesh)
    n = dist.get_world_size(group)
    if not tiled:
        x = x.unsqueeze(axis)
    axis %= x.dim()
    lead = x.movedim(axis, 0).contiguous()
    out = torch.empty((n * lead.shape[0], *lead.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, lead, group=group)
    return out.movedim(0, axis)


def reduce_scatter(x: torch.Tensor, axis_name: str, mesh, *, axis: int = 0) -> torch.Tensor:
    """Sum, then keep this member's block of ``axis`` (the ZeRO gradient path)."""
    group = _group(axis_name, mesh)
    n = dist.get_world_size(group)
    axis %= x.dim()
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of size {x.shape[axis]} does not split over {n}")
    lead = x.movedim(axis, 0).contiguous()
    out = torch.empty((lead.shape[0] // n, *lead.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, lead, group=group)
    return out.movedim(0, axis)


def _all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % n:
        raise ValueError(f"axis {split_axis} of size {x.shape[split_axis]} does not split over {n}")
    lead = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(lead)
    dist.all_to_all_single(out, lead, group=group)
    pieces = [piece.movedim(0, split_axis) for piece in out.chunk(n)]
    return torch.cat(pieces, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, concat_axis, split_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, axis_name: str, mesh, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Send block ``j`` of ``split_axis`` to member ``j``; concatenate what
    arrives along ``concat_axis`` in member order (the Ulysses swap).
    Differentiable: the gradient takes the swap back."""
    return _AllToAll.apply(x, _group(axis_name, mesh), split_axis % x.dim(),
                           concat_axis % x.dim())


def _ring_permute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if shift % n == 0:
        return x.clone()
    me = dist.get_group_rank(group, dist.get_rank())
    rows = x.shape[0] if x.dim() else 1
    flat = x.reshape(rows, -1).contiguous()
    send = [rows if j == (me + shift) % n else 0 for j in range(n)]
    recv = [rows if j == (me - shift) % n else 0 for j in range(n)]
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, output_split_sizes=recv, input_split_sizes=send,
                           group=group)
    return out.reshape(x.shape)


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ring_permute(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _ring_permute(grad.contiguous(), ctx.group, -ctx.shift), None, None


def ring_permute(x: torch.Tensor, axis_name: str, mesh, *, shift: int = 1) -> torch.Tensor:
    """Member ``i``'s tensor moves to member ``(i + shift) % n`` (ring
    attention's K/V hop), as one ``all_to_all_single`` with one non-empty
    split each way (module docstring).  Differentiable: the gradient moves
    back by ``-shift``."""
    return _RingPermute.apply(x, _group(axis_name, mesh), shift)


def axis_index(axis_name: str, mesh) -> int:
    """This rank's index along the mesh axis."""
    return mesh.get_local_rank(axis_name)


def axis_size(axis_name: str, mesh) -> int:
    return mesh[axis_name].size()


def _sum_(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x`` (a new tensor), in float32 for 16-bit floats."""
    wide = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.clone()
    dist.all_reduce(wide, group=group)
    return wide.to(x.dtype)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_(grad.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; backward, the sum of the group's gradients."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum forward; identity backward."""
    return _ReduceFromGroup.apply(x, group)
