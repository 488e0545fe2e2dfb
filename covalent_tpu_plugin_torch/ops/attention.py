"""Attention: the dense reference and flash attention over (B, H, S, D).

``mha_reference`` is the semantics oracle: plain matmul attention with a
float32 softmax, O(S^2) memory.  ``flash_attention`` is the memory-efficient
path: a ``torch.autograd.Function`` whose forward and two backward sweeps are
the hand-written CUDA kernels of ``csrc/`` on CUDA tensors (see
:mod:`._kernels`), and their plain PyTorch versions below on CPU tensors.
The forward saves only the per-row log-sum-exp; the backward recomputes every
probability from it, as the reference's FlashAttention-2 kernels do.

Counterpart of ``covalent_tpu_plugin/ops/attention.py``; the mask, tile-skip
and window rules are the same, so the two packages agree position for
position.
"""

from __future__ import annotations

import torch

from . import _kernels

#: Finite stand-in for -inf in masked scores (finite so downstream exp and
#: log-sum-exp arithmetic can never produce NaN).
NEG_INF = -1e30

#: Sequence tiles the reference accepts by default (forward query, forward
#: key).  The CUDA kernels tile by themselves and mask the ragged edge; these
#: only make the port refuse the lengths the reference refuses.
_REFERENCE_BLOCK_Q = 512
_REFERENCE_BLOCK_K = 1024


def _gqa_group(q: torch.Tensor, k: torch.Tensor) -> int:
    """Query-heads-per-kv-head ratio; validates the GQA head contract."""
    h_q, h_kv = q.shape[1], k.shape[1]
    if h_kv == 0 or h_q % h_kv:
        raise ValueError(
            f"GQA needs query heads ({h_q}) divisible by kv heads ({h_kv})"
        )
    return h_q // h_kv


def on_cuda(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def _band_visible(qpos, kpos, window: int | None, sinks: int = 0):
    """Causal(-band) visibility on broadcastable position grids: row sees
    column iff ``q >= k`` and (windowed) ``q - k < window``, OR, with
    ``sinks`` (StreamingLLM attention sinks), ``k < sinks`` and ``q >= k``."""
    causal_ok = qpos >= kpos
    if window is None:
        return causal_ok
    in_band = qpos - kpos < window
    if sinks:
        in_band = in_band | (kpos < sinks)
    return causal_ok & in_band


def _band_tile_needed(qpos_tile, kpos_tile, causal: bool, window: int | None,
                      sinks: int = 0) -> bool:
    """Whether a (query tile, key tile) pair intersects the visible band:
    ``min(k) <= max(q)`` kills tiles wholly in the future; with a window,
    ``max(k) > min(q) - window`` kills tiles wholly behind the band, unless
    the tile holds sink columns.  The CUDA kernels apply the same test on
    device (csrc/flash_common.cuh:tile_needed)."""
    needed = True if not causal else bool(kpos_tile.min() <= qpos_tile.max())
    if window is not None:
        behind_ok = bool(kpos_tile.max() > qpos_tile.min() - window)
        if sinks:
            behind_ok = behind_ok or bool(kpos_tile.min() < sinks)
        needed = needed and behind_ok
    return needed


def _check_window(window, causal, sinks: int = 0) -> None:
    if sinks:
        if sinks < 0:
            raise ValueError(f"sinks must be >= 0, got {sinks}")
        if window is None:
            raise ValueError("sinks (attention sinks) require a window")
    if window is None:
        return
    if not causal:
        raise ValueError("window (sliding-window attention) requires causal")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _fit_block(requested: int, seq_len: int) -> int:
    """Largest power-of-two shrink of ``requested`` that divides seq_len.

    Floors at 128 (or the whole sequence when shorter): a length with a
    large odd factor (4098 = 2·3·683) is refused with a clear "pad the
    sequence" error, as the reference refuses it.
    """
    block = min(requested, seq_len)
    while block > 1 and seq_len % block:
        block //= 2
    floor = min(128, seq_len)
    if block < floor:
        raise ValueError(
            f"seq_len {seq_len} has no usable tile size (>= {floor}); "
            "pad the sequence to a multiple of 128"
        )
    return block


def _check_blocks(seq_q: int, seq_k: int, block_q, block_k) -> None:
    """The reference's sequence-length contract: default blocks must fit
    (``_fit_block``), explicit blocks must divide the sequence."""
    block_q = (
        _fit_block(_REFERENCE_BLOCK_Q, seq_q) if block_q is None
        else min(block_q, seq_q)
    )
    block_k = (
        _fit_block(_REFERENCE_BLOCK_K, seq_k) if block_k is None
        else min(block_k, seq_k)
    )
    if seq_q % block_q or seq_k % block_k:
        raise ValueError(
            f"seq lengths ({seq_q}, {seq_k}) must be divisible by "
            f"block sizes ({block_q}, {block_k}); pad the sequence"
        )


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: float | None = None,
    window: int | None = None,
    sinks: int = 0,
) -> torch.Tensor:
    """Dense multi-head attention oracle.  Shapes: (B, H, S, D).

    Grouped-query attention: ``k``/``v`` may carry fewer heads than ``q``;
    each kv head serves a contiguous group of query heads.  ``window=w``
    masks to the sliding causal band (row ``i`` sees ``(i-w, i]``);
    ``sinks=k`` keeps the first ``k`` columns visible to every row.
    """
    _check_window(window, causal, sinks)
    if k.shape[1] != q.shape[1]:
        group = _gqa_group(q, k)
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s_q, s_k = q.shape[2], k.shape[2]
        qi = torch.arange(s_q, device=q.device)[:, None]
        ki = torch.arange(s_k, device=q.device)[None, :]
        scores = scores.masked_fill(~_band_visible(qi, ki, window, sinks), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# --- Plain PyTorch versions of the three kernels ---------------------------
#
# Same function, same casts as the CUDA kernels (and as the reference's
# Pallas kernels): products accumulate in f32, P is cast to V's (dO's) type
# before PV (P^T dO), dS to K's or Q's type before dS K (dS^T Q).  Results
# are written in the input type, or in ``out_dtype`` / ``grad_dtype``
# (float32: ring attention's per-hop partials).  They compute dense score
# matrices, so they serve the CPU and the kernel checks, not long sequences.


def _positions(positions, length: int, device) -> torch.Tensor:
    if positions is None:
        return torch.arange(length, dtype=torch.int32, device=device)
    return torch.as_tensor(positions, dtype=torch.int32, device=device).reshape(length)


def _visible(qpos, kpos, causal, window, sinks):
    if not causal:
        return None
    return _band_visible(qpos[:, None], kpos[None, :], window, sinks)


def _scores(q, k, qpos, kpos, causal, window, sinks):
    group = _gqa_group(q, k)
    kx = k.repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kx.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    return s, _visible(_positions(qpos, q.shape[2], q.device),
                       _positions(kpos, k.shape[2], q.device), causal, window, sinks)


def flash_fwd_plain(q, k, v, qpos, kpos, causal, window, sinks, out_dtype=None):
    """Plain version of the forward kernel: ``(out, lse)``, ``out`` in
    ``out_dtype`` (q's type by default)."""
    s, mask = _scores(q, k, qpos, kpos, causal, window, sinks)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    vx = v.repeat_interleave(_gqa_group(q, k), dim=1)
    acc = torch.matmul(p.to(v.dtype).float(), vx.float())
    return (acc / l).to(out_dtype or q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs(q, k, lse, qpos, kpos, causal, window, sinks):
    s, mask = _scores(q, k, qpos, kpos, causal, window, sinks)
    p = torch.exp(s - lse[..., None])
    return p if mask is None else p.masked_fill(~mask, 0.0)


def _ds(q, v, dout, p, delta):
    vx = v.repeat_interleave(_gqa_group(q, v), dim=1)
    dp = torch.matmul(dout.float(), vx.float().transpose(-1, -2))
    return p * (dp - delta[..., None]) * q.shape[-1] ** -0.5


def flash_bwd_dkdv_plain(q, k, v, dout, lse, delta, qpos, kpos, causal, window, sinks,
                         grad_dtype=None):
    """Plain version of the dK/dV kernel: ``(dk, dv)`` at kv-head shape, in
    ``grad_dtype`` (k's type by default)."""
    p = _probs(q, k, lse, qpos, kpos, causal, window, sinks)
    ds = _ds(q, v, dout, p, delta)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), dout.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    b, h_kv, s_k, d = k.shape
    group = q.shape[1] // h_kv
    return (
        dk.view(b, h_kv, group, s_k, d).sum(dim=2).to(grad_dtype or k.dtype),
        dv.view(b, h_kv, group, s_k, d).sum(dim=2).to(grad_dtype or v.dtype),
    )


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, qpos, kpos, causal, window, sinks,
                       grad_dtype=None):
    """Plain version of the dQ kernel, ``dq`` in ``grad_dtype`` (q's type by
    default)."""
    p = _probs(q, k, lse, qpos, kpos, causal, window, sinks)
    ds = _ds(q, v, dout, p, delta)
    kx = k.repeat_interleave(_gqa_group(q, k), dim=1)
    return torch.matmul(ds.to(k.dtype).float(), kx.float()).to(grad_dtype or q.dtype)


# --- Device dispatch: the kernel on CUDA, its plain version on the CPU ----


def _pick(kernel, plain, q):
    if q.device.type == "cuda":
        return kernel
    if q.device.type == "cpu":
        return plain
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def _flash_forward(q, k, v, qpos, kpos, causal, window, sinks, out_dtype=None):
    """``(out, lse)``: out in ``out_dtype`` (q's type by default; float32
    lets ring callers merge unrounded block partials), lse (B, H, S) f32."""
    return _pick(_kernels.flash_fwd, flash_fwd_plain, q)(
        q, k, v, qpos, kpos, causal, window, sinks, out_dtype
    )


def flash_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``delta_i = rowsum(dO_i * O_i)`` in f32, (B, H, S): a cheap reduce,
    left to PyTorch."""
    return (g.float() * out.float()).sum(dim=-1)


def _flash_backward(q, k, v, out, lse, g, qpos, kpos, causal, window, sinks,
                    delta=None, grad_dtype=None):
    """``(dq, dk, dv)`` in ``grad_dtype`` (the inputs' types by default).
    Ring callers pass ``delta`` (:func:`flash_delta`), computed once for
    every hop, and ``grad_dtype=float32`` for per-hop partials."""
    if delta is None:
        delta = flash_delta(out, g)
    dk, dv = _pick(_kernels.flash_bwd_dkdv, flash_bwd_dkdv_plain, q)(
        q, k, v, g, lse, delta, qpos, kpos, causal, window, sinks, grad_dtype
    )
    dq = _pick(_kernels.flash_bwd_dq, flash_bwd_dq_plain, q)(
        q, k, v, g, lse, delta, qpos, kpos, causal, window, sinks, grad_dtype
    )
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, causal, window, sinks):
        out, lse = _flash_forward(q, k, v, qpos, kpos, causal, window, sinks)
        ctx.save_for_backward(q, k, v, out, lse, qpos, kpos)
        ctx.band = (causal, window, sinks)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, qpos, kpos = ctx.saved_tensors
        dq, dk, dv = _flash_backward(
            q, k, v, out, lse, g.contiguous(), qpos, kpos, *ctx.band
        )
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    *,
    q_positions: torch.Tensor | None = None,
    k_positions: torch.Tensor | None = None,
    block_q: int | None = None,
    block_k: int | None = None,
    window: int | None = None,
    sinks: int = 0,
) -> torch.Tensor:
    """Flash attention over (B, H, S, D) inputs.

    Grouped-query attention: ``k``/``v`` may have fewer heads than ``q``
    (``H_q % H_kv == 0``); kv head ``i`` serves query heads
    ``[i*G, (i+1)*G)``, and dk/dv come back at the kv-head shape.

    ``q_positions``/``k_positions`` ((S,) int) override the causal mask's
    notion of position: row ``i`` attends column ``j`` iff
    ``q_positions[i] >= k_positions[j]`` (and the band allows it).  ``k`` may
    have a different sequence length than ``q``.

    ``window=w`` (requires ``causal``) restricts each query to the ``w``
    most recent positions; ``sinks=k`` keeps columns ``< k`` visible to every
    row alongside the band.

    ``block_q``/``block_k`` keep the reference's length contract (explicit
    blocks must divide the sequence; default ones must fit it, see
    ``_fit_block``); the CUDA kernels choose their own tiles.

    On CUDA tensors the forward and both backward sweeps are the CUDA kernels;
    on CPU tensors they are the plain PyTorch versions above.
    """
    _check_window(window, causal, sinks)
    _gqa_group(q, k)
    _check_blocks(q.shape[2], k.shape[2], block_q, block_k)
    qpos = None if q_positions is None else _positions(q_positions, q.shape[2], q.device)
    kpos = None if k_positions is None else _positions(k_positions, k.shape[2], q.device)
    return _FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), qpos, kpos, causal, window, sinks
    )
