"""Attention and loss operators of the PyTorch port: flash attention (the
hand-written CUDA kernels, their plain versions on the CPU), ring,
ring-flash and Ulysses attention over the mesh's ``seq`` axis, and the
fused vocab-chunked cross-entropy."""

from .attention import NEG_INF, flash_attention, mha_reference, on_cuda
from .ring_attention import (
    ring_attention,
    ring_flash_attention,
    sequence_parallel_attention,
    ulysses_attention,
)
from .xent import fused_cross_entropy

__all__ = [
    "NEG_INF",
    "flash_attention",
    "fused_cross_entropy",
    "mha_reference",
    "on_cuda",
    "ring_attention",
    "ring_flash_attention",
    "sequence_parallel_attention",
    "ulysses_attention",
]
