"""Models of the PyTorch port: the transformer LM and its training path."""

from .convert import params_from_jax
from .data import synthetic_lm_batch, synthetic_lm_batches
from .train import (
    adamw,
    cross_entropy_loss,
    lm_loss,
    make_train_step,
    train_lm,
)
from .transformer import TransformerConfig, TransformerLM, lm_125m_config

__all__ = [
    "TransformerConfig",
    "TransformerLM",
    "adamw",
    "cross_entropy_loss",
    "lm_125m_config",
    "lm_loss",
    "make_train_step",
    "params_from_jax",
    "synthetic_lm_batch",
    "synthetic_lm_batches",
    "train_lm",
]
