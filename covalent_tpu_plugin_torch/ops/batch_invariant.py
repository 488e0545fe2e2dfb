"""Batch-invariant products and RMSNorm for the serving paths.

The reference engine's contract (``tests/test_continuous.py``): a slot's
lane computes exactly what a batch-1 decode computes, so greedy streams are
bit-identical however requests share slots.  The serving control plane
leans on it: a reconnect, a re-route, a hedge or a handoff replays a stream
from token 0 in another batch and drops every replayed token below the
delivered high-water mark without comparing it.

A library GEMM (cuBLAS behind ``F.linear`` and ``einsum``) picks its
algorithm, tiling and split-K by the problem's shape, and a library
reduction sizes its blocks by the number of rows, so on the card a row's
sums are taken in an order that depends on what shares its batch.  The
functions here take CUDA tensors to hand-written kernels whose order of
summation is fixed per output element by the dtypes and K, never by the
number of rows: the batch-invariant matmul and RMSNorm of
Thinking Machines' "Defeating Nondeterminism in LLM Inference" (2025).  The
product has three routes (``_kernels.plan_bi_gemm``): bf16 operands on the
tensor cores (``csrc/bi_gemm_tc.cu``; the decode attention's mix, its cache
operand read transposed, in ``csrc/bi_gemm_mix.cu``), a pair with an f32
operand on the CUDA cores (``csrc/bi_gemm.cu``); the norm, alone or with the
residual add before it, is ``csrc/bi_rmsnorm.cu``.  CPU
tensors take the ``*_plain`` versions beside them, which make the same
casts; the model uses the plain versions outright where the route is off
(training).

:func:`..models.transformer.use_batch_invariant` turns the route on; the
serving entry points (``generate``, ``continuous_generate``,
``ContinuousEngine``) call it.  There is no fallback: on a CUDA tensor a
kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _kernels


def _route(x: torch.Tensor) -> bool:
    """True for the kernel, False for the plain version (CPU tensors)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"the batch-invariant ops run on cuda or cpu, got {x.device}")


def linear_plain(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ weight.T`` with both cast to ``dtype`` first (the reference's
    dense dtype rule)."""
    return F.linear(x.to(dtype), weight.to(dtype))


def linear(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """:func:`linear_plain` on the batch-invariant GEMM for CUDA tensors."""
    if not _route(x):
        return linear_plain(x, weight, dtype)
    # A bf16 weight under an f32 product goes to the kernel as it is, and so
    # do bf16 features beside it (the lm_head's, out of the final norm):
    # widening bf16 to f32 is exact, so the kernel computes the plain
    # version's function, its f32 sums taken on the tensor cores.  Any other
    # operand is cast as the plain version casts it.
    if not (weight.dtype == torch.bfloat16 and dtype == torch.float32):
        weight = weight.to(dtype)
    if not (x.dtype == weight.dtype == torch.bfloat16):
        x = x.to(dtype)
    rows = x.reshape(-1, x.shape[-1])
    out = torch.empty(*x.shape[:-1], weight.shape[0], dtype=dtype, device=x.device)
    _kernels.bi_gemm(rows, weight, out.view(-1, weight.shape[0]))
    return out


def attention_scores_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Scores of the decode attention: q (B, Q, H_kv, G, D) against the
    cache's k (B, S, H_kv, D), both upcast to f32 (exact for bf16), as an
    f32 (B, H_kv, G, Q, S)."""
    return torch.einsum("bqhgd,bshd->bhgqs", q.float(), k.float())


def attention_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """:func:`attention_scores_plain` on the batch-invariant GEMM for CUDA
    tensors: batch (b, kv head, group), rows the queries, k read in place."""
    if not _route(q):
        return attention_scores_plain(q, k)
    b, nq, h, g, d = q.shape
    out = torch.empty((b, h, g, nq, k.shape[1]), dtype=torch.float32, device=q.device)
    keys = k.permute(0, 2, 1, 3)[:, :, None].expand(b, h, g, k.shape[1], d)
    return _kernels.bi_gemm(q.permute(0, 2, 3, 1, 4), keys, out)


def attention_mix_plain(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The probabilities (B, H_kv, G, Q, S) times the cache's v (B, S,
    H_kv, D), both upcast to f32, as an f32 (B, Q, H_kv, G, D)."""
    return torch.einsum("bhgqs,bshd->bqhgd", probs.float(), v.float())


def attention_mix(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """:func:`attention_mix_plain` on the batch-invariant GEMM for CUDA
    tensors: v read transposed, the output written in its final layout."""
    if not _route(probs):
        return attention_mix_plain(probs, v)
    b, h, g, nq, s = probs.shape
    d = v.shape[-1]
    out = torch.empty((b, nq, h, g, d), dtype=torch.float32, device=probs.device)
    values = v.permute(0, 2, 3, 1)[:, :, None].expand(b, h, g, d, s)
    _kernels.bi_gemm(probs, values, out.permute(0, 2, 3, 1, 4))
    return out


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 over the last dim, times ``scale``, cast to ``dtype``."""
    x32 = x.float()
    norm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (norm * scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
             eps: float = 1e-6) -> torch.Tensor:
    """:func:`rms_norm_plain` on the one-warp-a-row kernel for CUDA tensors."""
    if not _route(x):
        return rms_norm_plain(x, scale, dtype, eps)
    return _kernels.bi_rmsnorm(x.contiguous(), scale.contiguous(), dtype, eps)


def add_rms_norm_plain(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype, eps: float = 1e-6):
    """The residual add ``s = x + delta`` and :func:`rms_norm_plain` of
    ``s``: ``(s, y)``, the reference layer's two ops."""
    s = x + delta
    return s, rms_norm_plain(s, scale, dtype, eps)


def add_rms_norm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype, eps: float = 1e-6):
    """:func:`add_rms_norm_plain` in one launch of the norm's kernel for
    CUDA tensors: ``s`` bit-equal to torch's add, ``y`` to :func:`rms_norm`
    of ``s``."""
    if not _route(x):
        return add_rms_norm_plain(x, delta, scale, dtype, eps)
    return _kernels.bi_add_rmsnorm(x.contiguous(), delta.contiguous(), scale.contiguous(),
                                   dtype, eps)
