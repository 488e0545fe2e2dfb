"""Fused (vocab-chunked) softmax cross-entropy: the logits are never whole.

Counterpart of ``covalent_tpu_plugin/ops/xent.py``.  The standard LM loss
materialises a (tokens, vocab) f32 logits tensor (~1 GB at 8x1024 tokens and
a 32k vocab), writes it, re-reads it for the softmax and visits it again in
the backward.  This loss streams over vocabulary chunks instead, carrying an
online log-sum-exp per token (the flash-attention rescaling trick applied to
the classifier), and recomputes each chunk's logits in the backward.  Peak
live memory is O(T·chunk + T·d) instead of O(T·V).

Plain PyTorch around ``torch.matmul``: the reference computes it outside any
Pallas kernel, so there is no kernel here to port.

Under tensor parallelism the lm_head is sharded over the vocabulary.  The
standard loss runs on the logits' shards (:func:`vocab_parallel_cross_entropy`)
and the fused loss on the kernel's (:func:`vocab_parallel_fused_cross_entropy`):
each rank streams its block of the vocabulary in chunks, carrying its online
``(m, l)`` and the label's logit, and the group combines them (the max of
``m``, the rescaled sum of ``l``, the sum of the label logits, which one
rank's block holds).  The backward recomputes each chunk against the global
log-sum-exp; ``dx`` is this rank's part (the caller sums it over the group,
``TensorParallel.enter``) and ``dW`` stays local.  The reference shards its
fused loss like any dense layer, vocab on the chunked axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _chunks(vocab: int, chunk: int) -> int:
    if vocab % chunk:
        raise ValueError(
            f"vocab size {vocab} must be divisible by chunk {chunk}"
        )
    return vocab // chunk


def _logits_chunk(xf, w, j, chunk, dtype):
    """Chunk ``j`` of ``x @ w`` with ``w`` cast to the features' type and
    products accumulated in f32 (``xf`` is the features upcast once)."""
    wc = w[:, j * chunk:(j + 1) * chunk].to(dtype)
    return torch.matmul(xf, wc.float()), wc


def _stream(x, w, labels, chunk):
    """The forward's pass over the chunks of ``w`` (d, V): per token the
    running max ``m`` and sum ``l`` of the logits' exponentials, and the
    label's logit (0 where no chunk holds the label)."""
    tokens = x.shape[0]
    n = _chunks(w.shape[1], chunk)
    xf = x.float()
    m = torch.full((tokens,), float("-inf"), device=x.device)
    l = torch.zeros(tokens, device=x.device)
    lab = torch.zeros(tokens, device=x.device)
    for j in range(n):
        s, _ = _logits_chunk(xf, w, j, chunk, x.dtype)
        m_new = torch.maximum(m, s.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, None]).sum(dim=-1)
        idx = labels - j * chunk
        in_chunk = (idx >= 0) & (idx < chunk)
        got = s.gather(1, idx.clamp(0, chunk - 1)[:, None])[:, 0]
        lab = torch.where(in_chunk, got, lab)
        m = m_new
    return m, l, lab


def _grads(x, w, labels, lse, chunk, coef):
    """``(dx, dw)`` of ``coef * sum(lse - label logit)``: each chunk's
    softmax recomputed from ``lse``, the label's one-hot taken off."""
    n = _chunks(w.shape[1], chunk)
    cols = torch.arange(chunk, device=x.device)[None, :]
    xf = x.float()
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dw_chunks = []
    for j in range(n):
        s, wc = _logits_chunk(xf, w, j, chunk, x.dtype)
        p = torch.exp(s - lse[:, None])  # softmax chunk, recomputed
        p = p - (cols == (labels - j * chunk)[:, None]).float()
        dl = (p * coef).to(x.dtype)
        dx = dx + torch.matmul(dl.float(), wc.float().t())
        dw_chunks.append(torch.matmul(xf.t(), dl.float()).to(w.dtype))
    return dx.to(x.dtype), torch.cat(dw_chunks, dim=1)


class _FusedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, chunk):
        labels = labels.long()
        m, l, lab = _stream(x, w, labels, chunk)
        lse = m + torch.log(l)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.chunk = chunk
        return (lse - lab).mean()

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        dx, dw = _grads(x, w, labels, lse, ctx.chunk, (g / x.shape[0]).float())
        return dx, dw, None, None


def fused_cross_entropy(x, w, labels, chunk: int = 8192):
    """Mean cross-entropy of ``softmax(x @ w)`` against integer labels.

    ``x``: (T, d) features, ``w``: (d, V) lm_head kernel, ``labels``: (T,)
    int.  The logits are ``x`` times ``w`` cast to ``x``'s type, accumulated
    in f32, as the reference computes them.
    """
    return _FusedCrossEntropy.apply(x, w, labels, chunk)


class _VocabParallelFusedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, chunk, group, start):
        # labels relative to this rank's block: those outside it match no column
        labels = labels.long() - start
        m, l, lab = _stream(x, w, labels, chunk)
        top = m.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        l = l * torch.exp(m - top)
        dist.all_reduce(l, group=group)
        dist.all_reduce(lab, group=group)
        lse = top + torch.log(l)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.chunk = chunk
        return (lse - lab).mean()

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        dx, dw = _grads(x, w, labels, lse, ctx.chunk, (g / x.shape[0]).float())
        return dx, dw, None, None, None, None


def vocab_parallel_fused_cross_entropy(x, w, labels, tp, block: slice, chunk: int = 8192):
    """:func:`fused_cross_entropy` with the vocabulary sharded over ``tensor``
    (module docstring).

    ``x``: (T, d) features, the same on every rank of the group, after
    ``tp.enter`` (whose backward sums the ranks' ``dx``); ``w``: (d, V /
    tensor), this rank's ``block`` of the lm_head kernel; ``labels``: (T,)
    global token ids; the block must split into chunks of ``chunk``.  Every
    rank returns the same loss.
    """
    return _VocabParallelFusedCrossEntropy.apply(x, w, labels, chunk, tp.group, block.start)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, tp,
                                 block: slice) -> torch.Tensor:
    """Mean cross-entropy of logits sharded over the vocabulary.

    ``logits``: (..., V / tensor), this rank's ``block`` of the vocabulary;
    ``labels``: (...) global token ids; ``tp``: the
    ``parallel.sharding.TensorParallel`` handle.  In float32, as
    ``optax.softmax_cross_entropy_with_integer_labels``: the group's max (a
    constant, no gradient), the sum of ``exp`` and the label's logit summed
    over the group.  Every rank returns the same loss; each rank's backward
    gives the gradient of that loss with respect to its own shard.
    """
    width = block.stop - block.start
    logits = logits.float().reshape(-1, width)
    labels = labels.reshape(-1).long()
    with torch.no_grad():
        top = logits.amax(dim=-1)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=tp.group)
    shifted = logits - top[:, None]
    total = tp.leave(torch.exp(shifted).sum(dim=-1))
    idx = labels - block.start
    inside = (idx >= 0) & (idx < width)
    picked = shifted.gather(1, idx.clamp(0, width - 1)[:, None])[:, 0]
    picked = tp.leave(torch.where(inside, picked, torch.zeros_like(picked)))
    return (torch.log(total) - picked).mean()
