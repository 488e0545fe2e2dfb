"""Ring attention: sequence/context parallelism over the mesh's ``seq`` axis.

Counterpart of ``covalent_tpu_plugin/ops/ring_attention.py``.  Q, K and V
are sharded along the sequence across the ranks of the ``seq`` axis; each
rank keeps its query shard while the K/V shards rotate around the ring
(``parallel.collectives.ring_permute``, one hop a step), and the partial
results merge with the online softmax, so no rank ever holds the S x S
scores.  The reference runs its per-shard bodies under ``shard_map``; here
every function takes this rank's shards as plain tensors, ``(B/data,
H/tensor, S/seq, D)``, and the mesh whose ``seq`` group it talks to.

Three bodies, as in the reference:

* :func:`ring_attention`, the einsum ring: dense f32 scores per (q-shard,
  k-shard) block, differentiated by autograd through the permutes;
* :func:`ring_flash_attention`: every block through the flash kernels
  (``ops/attention.py``; the CUDA kernels on the card, their plain versions
  on the CPU) with float32 partials (``out_dtype`` / ``grad_dtype``), so n
  16-bit roundings do not pile up around the ring.  Its backward is a
  second ring pass with the global softmax statistics: ``delta`` once, and
  the dK/dV partials riding the ring home with their shards;
* :func:`ulysses_attention`: two all-to-alls swap the sequence for the
  heads, and the flash kernels run over the whole sequence on H/n heads.

Layouts.  A rank's rows are contiguous (rank ``i`` holds ``[i L, (i+1) L)``)
or zigzag-striped (stripes ``i`` and ``2n-1-i``, :func:`stripe_sequence`),
which balances causal work around the ring.  The layout is the caller's:
:func:`sequence_parallel_attention` takes shards already laid out by
:func:`default_zigzag`'s rule unless told otherwise, and
``parallel.sharding.shard_batch`` cuts a model's tokens by the same rule.
Which hops carry work, and how many hops the ring runs, follow from the
index formula on the host; no device value is read to decide them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import all_to_all, ring_permute
from .attention import (
    NEG_INF,
    _flash_backward,
    _flash_forward,
    flash_attention,
    flash_delta,
    on_cuda,
)


def _shard_indices(shard: int, n: int, seq_local: int, zigzag: bool) -> np.ndarray:
    """Global positions of ``shard``'s local rows ((seq_local,) int32)."""
    if zigzag:
        # Rank i holds stripes i and 2n-1-i (each seq_local//2 long): the
        # mirror pairing balances causal work across the ring.
        stripe = seq_local // 2
        low = shard * stripe + np.arange(stripe, dtype=np.int32)
        high = (2 * n - 1 - shard) * stripe + np.arange(stripe, dtype=np.int32)
        return np.concatenate([low, high])
    return shard * seq_local + np.arange(seq_local, dtype=np.int32)


def _block_attend(q, k, v, q_idx, k_idx, scale, causal, window=None):
    """Score one (local-q, rotating-k) block pair; return (m, l, o) partials.

    Shapes: q (B,H,Sq,D), k/v (B,H,Sk,D); ``q_idx``/``k_idx`` are the GLOBAL
    positions of each local row ((Sq,)/(Sk,) int tensors on q's device).
    ``window`` adds the band's upper edge (a row sees a column iff ``0 <= q -
    k < window``).  The products take the inputs' values with f32
    accumulation; P is rounded to V's type before PV, as the reference
    casts it; the statistics are f32.
    """
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = None
    if causal:
        mask = q_idx[:, None] >= k_idx[None, :]
        if window is not None:
            mask = mask & (q_idx[:, None] - k_idx[None, :] < window)
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)  # (B,H,Sq,1)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return m, l, o


def _hop_needed(q_idx: np.ndarray, k_idx: np.ndarray, window) -> bool:
    """Whether a (q-shard, k-shard) hop intersects the visible band, from the
    host's index vectors: ``min(k) <= max(q)`` kills hops wholly in the
    future; with a window, ``max(k) > min(q) - window`` kills hops wholly
    behind the band (exact for contiguous layouts, conservative for striped
    ones)."""
    needed = int(k_idx.min()) <= int(q_idx.max())
    if window is not None:
        needed = needed and int(k_idx.max()) > int(q_idx.min()) - window
    return needed


def _ring_steps(n: int, seq_local: int, window, zigzag: bool) -> int:
    """Number of ring hops that can carry in-band work.

    Contiguous layout with a sliding window: rank ``i``'s queries span
    ``[i*L, (i+1)*L)`` and their band reaches back at most ``window - 1``
    keys, so only the own shard and the previous ``ceil((window-1)/L)``
    shards matter: ``min(n, (window-2)//L + 2)`` hops instead of ``n``.
    Striped (zigzag) shards interleave early and late stripes, so every hop
    may carry band work: ``n`` hops.
    """
    if window is None or zigzag:
        return n
    return max(1, min(n, (window - 2) // seq_local + 2))


class _Ring:
    """This rank's place on the ring: its group, size and index, and the
    positions of every shard (host arrays and tensors on ``device``)."""

    def __init__(self, mesh, axis_name: str, seq_local: int, zigzag: bool, device):
        self.mesh, self.axis_name = mesh, axis_name
        self.n = mesh[axis_name].size()
        self.me = mesh.get_local_rank(axis_name)
        self.host = [_shard_indices(i, self.n, seq_local, zigzag) for i in range(self.n)]
        self.pos = [torch.as_tensor(idx, device=device) for idx in self.host]

    def permute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        return ring_permute(x, self.axis_name, self.mesh, shift=shift)

    def src(self, t: int) -> int:
        """The shard this rank holds at hop ``t``."""
        return (self.me - t) % self.n


def ring_attention(q, k, v, mesh, axis_name: str = "seq", causal: bool = True,
                   scale: float | None = None, zigzag: bool = False,
                   window: int | None = None) -> torch.Tensor:
    """The einsum ring on this rank's seq-sharded (B, H, S/n, D) shards.

    Hop ``t`` holds the K/V shard that started on rank ``(my_index - t) mod
    n``; after scoring it moves to the next rank.  ``zigzag`` says the shards
    are striped (:func:`stripe_sequence`).  ``window`` masks to the sliding
    causal band; on the contiguous layout the ring then runs only the hops
    that can carry band work.

    Autograd differentiates it, through the permutes, so every hop computes
    its block, a wholly masked one too (its partials (-1e30, 0, 0) leave
    the merge as it was, as the reference's skip does): a hop skipped on one
    rank alone would drop that rank's backward of the permute that brought
    the shard, and the ranks' collectives would no longer pair up.
    """
    seq_local, head_dim = q.shape[2], q.shape[3]
    scale = head_dim**-0.5 if scale is None else scale
    ring = _Ring(mesh, axis_name, seq_local, zigzag, q.device)
    q_idx = ring.pos[ring.me]
    steps = _ring_steps(ring.n, seq_local, window if causal else None, zigzag)
    shape = q.shape[:3] + (1,)
    m = torch.full(shape, NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for t in range(steps):
        m_blk, l_blk, o_blk = _block_attend(
            q, k_cur, v_cur, q_idx, ring.pos[ring.src(t)], scale, causal, window)
        m_new = torch.maximum(m, m_blk)
        alpha_prev, alpha_blk = torch.exp(m - m_new), torch.exp(m_blk - m_new)
        l = l * alpha_prev + l_blk * alpha_blk
        acc = acc * alpha_prev + o_blk * alpha_blk
        m = m_new
        if t < steps - 1:  # the last hop's rotation would go unused
            k_cur, v_cur = ring.permute(k_cur), ring.permute(v_cur)
    return (acc / torch.clamp_min(l, 1e-37)).to(q.dtype)


class _RingFlash(torch.autograd.Function):
    """The ring-flash forward and backward passes: every (q-shard, k-shard)
    pair through the flash sweeps, with f32 partials."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name, causal, zigzag, window):
        seq_local = q.shape[2]
        ring = _Ring(mesh, axis_name, seq_local, zigzag, q.device)
        skips = causal and (not zigzag or window is not None)
        steps = _ring_steps(ring.n, seq_local, window if causal else None, zigzag)
        q_idx = ring.pos[ring.me]
        f32 = torch.float32
        o = torch.zeros(q.shape, dtype=f32, device=q.device)
        lse = torch.full(q.shape[:3], NEG_INF, dtype=f32, device=q.device)
        k_cur, v_cur = k, v
        for t in range(steps):
            src = ring.src(t)
            if not skips or _hop_needed(ring.host[ring.me], ring.host[src], window):
                # f32 block outputs: the merge sums one partial per hop and
                # must not pay a 16-bit rounding at each one.
                o_blk, lse_blk = _flash_forward(q, k_cur, v_cur, q_idx, ring.pos[src], causal,
                                                window, 0, out_dtype=f32)
                # out = sum_blk exp(lse_blk - lse) o_blk; the statistics are
                # finite (-1e30, not -inf), so no NaN guard is needed.  A
                # skipped hop's (-1e30, 0) partial would leave both as they are.
                lse_new = torch.logaddexp(lse, lse_blk)
                o = (o * torch.exp(lse - lse_new)[..., None]
                     + o_blk * torch.exp(lse_blk - lse_new)[..., None])
                lse = lse_new
            if t < steps - 1:  # the last hop's rotation would go unused
                k_cur, v_cur = ring.permute(k_cur), ring.permute(v_cur)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (ring, causal, window, skips, steps)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        ring, causal, window, skips, steps = ctx.ring
        g = g.contiguous()
        q_idx = ring.pos[ring.me]
        # delta = rowsum(dO * O) is the same for every hop: once, not per hop
        delta = flash_delta(out, g)
        f32 = torch.float32
        dq = torch.zeros(q.shape, dtype=f32, device=q.device)
        dk = torch.zeros(k.shape, dtype=f32, device=q.device)
        dv = torch.zeros(v.shape, dtype=f32, device=q.device)
        k_cur, v_cur = k, v
        for t in range(steps):
            src = ring.src(t)
            if not skips or _hop_needed(ring.host[ring.me], ring.host[src], window):
                # f32 per-hop gradient partials (grad_dtype): n 16-bit
                # roundings per accumulator would otherwise stack up.
                dq_blk, dk_blk, dv_blk = _flash_backward(
                    q, k_cur, v_cur, out, lse, g, q_idx, ring.pos[src], causal, window, 0,
                    delta=delta, grad_dtype=f32)
                dq += dq_blk
                dk += dk_blk
                dv += dv_blk
            if t < steps - 1:
                k_cur, v_cur = ring.permute(k_cur), ring.permute(v_cur)
            # dk/dv partials ride the ring WITH their shards; after n
            # rotations each shard's gradient is home.
            dk, dv = ring.permute(dk), ring.permute(dv)
        if steps < ring.n:
            # the truncated ring leaves each partial `steps` hops past its
            # home: one permute re-homes it
            dk = ring.permute(dk, shift=ring.n - steps)
            dv = ring.permute(dv, shift=ring.n - steps)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


def ring_flash_attention(q, k, v, mesh, axis_name: str = "seq", causal: bool = True,
                         zigzag: bool = False, window: int | None = None) -> torch.Tensor:
    """Ring attention through the flash kernels on this rank's seq-sharded
    (B, H, S/n, D) shards (GQA: k/v may carry fewer heads).

    Same contract as :func:`ring_attention`, but each (q-shard, k-shard)
    pair runs the flash forward, and the backward is a second ring pass that
    recomputes each pair's gradients from the global softmax statistics, so
    a rank's memory stays O(S/n * D) at any length.  The sweeps write f32
    partials.  On CUDA tensors every hop launches the CUDA kernels; on CPU
    tensors their plain versions run.
    """
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(), mesh, axis_name,
                            causal, zigzag, window)


def ulysses_attention(q, k, v, mesh, axis_name: str = "seq", causal: bool = True,
                      window: int | None = None, sinks: int = 0) -> torch.Tensor:
    """Ulysses (all-to-all) sequence parallelism on this rank's seq-sharded
    (B, H, S/n, D) shards, contiguous layout.

    Two all-to-alls swap shard ownership sequence <-> heads: each rank runs
    the flash kernels over the WHOLE sequence for H/n of the heads, then
    swaps back.  Because the local attention sees the whole sequence at its
    own positions, windows and attention sinks compose unchanged.  The
    local heads must divide by the axis size; GQA k/v with fewer heads are
    repeated up to H first.
    """
    n = mesh[axis_name].size()
    if n == 1:
        return flash_attention(q, k, v, causal=causal, window=window, sinks=sinks)
    h_q, h_kv = q.shape[1], k.shape[1]
    if h_q % n:
        raise ValueError(
            f"ulysses needs local heads ({h_q}) divisible by the "
            f"'{axis_name}' axis ({n})"
        )
    if h_kv != h_q:
        group = h_q // h_kv
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    # (B, H, S/n, D) -> (B, H/n, S, D): heads scatter, sequence gathers.
    q, k, v = (all_to_all(t, axis_name, mesh, split_axis=1, concat_axis=2) for t in (q, k, v))
    out = flash_attention(q, k, v, causal=causal, window=window, sinks=sinks)
    return all_to_all(out, axis_name, mesh, split_axis=2, concat_axis=1)


def _stripe_permutation(seq_len: int, n: int) -> np.ndarray:
    """Index vector mapping natural order -> zigzag-striped order.

    The sequence splits into 2n stripes; rank i's contiguous shard becomes
    [stripe i ; stripe 2n-1-i], pairing a cheap (early) stripe with an
    expensive (late) one on every rank.
    """
    if seq_len % (2 * n):
        raise ValueError(
            f"zigzag striping needs seq_len divisible by 2*n ({2 * n}); "
            f"got {seq_len} — pad the sequence or pass zigzag=False"
        )
    return np.concatenate([_shard_indices(i, n, seq_len // n, True) for i in range(n)])


def stripe_sequence(x: torch.Tensor, n: int, axis: int = 2) -> torch.Tensor:
    """Permute ``axis`` into the zigzag layout for an ``n``-rank ring."""
    perm = torch.as_tensor(_stripe_permutation(x.shape[axis], n), device=x.device)
    return x.index_select(axis, perm.long())


def unstripe_sequence(x: torch.Tensor, n: int, axis: int = 2) -> torch.Tensor:
    """Inverse of :func:`stripe_sequence`."""
    perm = np.argsort(_stripe_permutation(x.shape[axis], n))
    return x.index_select(axis, torch.as_tensor(perm, device=x.device).long())


def default_zigzag(causal: bool, n: int, seq_len: int, window: int | None,
                   impl: str | None = None) -> bool:
    """The reference's layout rule: zigzag for an unwindowed causal ring
    whose (global) ``seq_len`` splits into 2n stripes; Ulysses and windowed
    rings keep the contiguous layout."""
    return (impl != "ulysses" and causal and n > 1 and seq_len % (2 * n) == 0
            and window is None)


def sequence_positions(seq_len: int, n: int, index: int, zigzag: bool) -> np.ndarray:
    """The global positions of rank ``index``'s rows of a ``seq_len``
    sequence on an ``n``-rank ring (int32, on the host)."""
    if zigzag:
        _stripe_permutation(seq_len, n)  # refuses a length that does not stripe
    elif seq_len % n:
        raise ValueError(f"seq_len {seq_len} does not split over the {n} ranks of 'seq'")
    return _shard_indices(index, n, seq_len // n, zigzag)


def sequence_parallel_attention(q, k, v, mesh, causal: bool = True, axis_name: str = "seq",
                                zigzag: bool | None = None, impl: str | None = None,
                                window: int | None = None, sinks: int = 0) -> torch.Tensor:
    """Attention over the mesh's ``seq`` axis on this rank's shards.

    ``q``/``k``/``v`` are this rank's (B/data, H/tensor, S/seq, D) blocks:
    the caller has cut the batch and the heads (the reference's
    ``shard_map`` specs over its ``batch_axes`` and ``head_axis``).
    Returns this rank's block of the output.

    ``zigzag`` (default: on for an unwindowed causal ring whose sequence
    splits into 2n stripes, :func:`default_zigzag`) says the shards are in
    the striped layout of :func:`stripe_sequence`; ``window`` masks to the
    sliding causal band (default layout contiguous, so the ring can
    truncate to the hops that carry band work).

    ``impl``: ``"flash"`` runs each block pair through the flash kernels,
    ``"einsum"`` the dense block path, ``"ulysses"`` two all-to-alls around
    the full-sequence flash kernels on H/n heads (needs head divisibility;
    the only impl that composes with ``sinks``).  Default: flash on CUDA
    tensors, einsum elsewhere.
    """
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires causal")
    n = mesh[axis_name].size()
    if impl is None:
        impl = "flash" if on_cuda(q) else "einsum"
    if impl not in ("flash", "einsum", "ulysses"):
        raise ValueError(
            f"impl must be 'flash', 'einsum', or 'ulysses', got {impl!r}"
        )
    if sinks and impl != "ulysses":
        raise ValueError(
            "sinks require impl='ulysses' (the rotating ring would need "
            "shard 0's sink slab resident on every hop)"
        )
    if impl == "ulysses":
        # the full sequence is local after the swap: nothing to balance
        return ulysses_attention(q, k, v, mesh, axis_name=axis_name, causal=causal,
                                 window=window, sinks=sinks)
    seq_len = q.shape[2] * n
    if zigzag is None:
        zigzag = default_zigzag(causal, n, seq_len, window)
    if zigzag:
        _stripe_permutation(seq_len, n)  # the reference refuses what does not stripe
    body = ring_flash_attention if impl == "flash" else ring_attention
    return body(q, k, v, mesh, axis_name=axis_name, causal=causal, zigzag=zigzag,
                window=window)
