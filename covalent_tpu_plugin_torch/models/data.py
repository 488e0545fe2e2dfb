"""Synthetic LM data: deterministic, learnable token streams.

Own copy of ``covalent_tpu_plugin/models/data.py`` (numpy only), so the two
packages see byte-identical batches from one seed.  Sealed accelerator hosts
can't download corpora, and the benchmark/test tiers measure framework and
compute behaviour, not tokenization, so the LM stream is generated: each
next token follows a fixed affine map of the previous one with a small
random-reset rate.  A model that learns the bigram map drives the loss well below the
uniform-entropy floor quickly, making "loss goes down" a meaningful
assertion at tiny scales.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

#: the learnable next-token rule: t+1 = (A * t + B) mod vocab
_A, _B = 7, 3


def synthetic_lm_batch(
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
    noise: float = 0.05,
) -> dict[str, np.ndarray]:
    """One ``{"tokens": (B, S) int32}`` batch of the affine-map stream.

    ``noise`` is the per-position probability of a random reset — it keeps
    the stream from collapsing onto one cycle and sets the achievable loss
    floor (≈ ``noise * log(vocab)``).
    """
    rng = np.random.default_rng(seed)
    tokens = np.empty((batch_size, seq_len), np.int64)
    tokens[:, 0] = rng.integers(0, vocab_size, batch_size)
    resets = rng.random((batch_size, seq_len)) < noise
    randoms = rng.integers(0, vocab_size, (batch_size, seq_len))
    for t in range(1, seq_len):
        follow = (tokens[:, t - 1] * _A + _B) % vocab_size
        tokens[:, t] = np.where(resets[:, t], randoms[:, t], follow)
    return {"tokens": tokens.astype(np.int32)}


def synthetic_lm_batches(
    steps: int,
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
    noise: float = 0.05,
) -> Iterator[dict[str, np.ndarray]]:
    """``steps`` deterministic batches (seed advances per step).

    Every pod process generating the same stream sees identical global
    batches — combine with ``parallel.process_local_slice`` so each worker
    feeds only its shard (``parallel.shard_batch_per_process``).  Per-step
    seeds derive through ``SeedSequence((seed, step))`` so no stream batch
    collides with a direct ``synthetic_lm_batch(seed=k)`` eval batch.
    """
    for step in range(steps):
        derived = int(np.random.SeedSequence((seed, step)).generate_state(1)[0])
        yield synthetic_lm_batch(
            batch_size, seq_len, vocab_size, seed=derived, noise=noise
        )
