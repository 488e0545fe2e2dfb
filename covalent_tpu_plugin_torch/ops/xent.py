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
"""

from __future__ import annotations

import torch


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


class _FusedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, chunk):
        tokens = x.shape[0]
        n = _chunks(w.shape[1], chunk)
        labels = labels.long()
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
        lse = m + torch.log(l)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.chunk = chunk
        return (lse - lab).mean()

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        tokens = x.shape[0]
        n = _chunks(w.shape[1], chunk)
        coef = (g / tokens).float()
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
        return dx.to(x.dtype), torch.cat(dw_chunks, dim=1), None, None


def fused_cross_entropy(x, w, labels, chunk: int = 8192):
    """Mean cross-entropy of ``softmax(x @ w)`` against integer labels.

    ``x``: (T, d) features, ``w``: (d, V) lm_head kernel, ``labels``: (T,)
    int.  The logits are ``x`` times ``w`` cast to ``x``'s type, accumulated
    in f32, as the reference computes them.
    """
    return _FusedCrossEntropy.apply(x, w, labels, chunk)
