"""Attention and loss operators of the PyTorch port."""

from .attention import NEG_INF, flash_attention, mha_reference, on_cuda
from .xent import fused_cross_entropy

__all__ = [
    "NEG_INF",
    "flash_attention",
    "fused_cross_entropy",
    "mha_reference",
    "on_cuda",
]
