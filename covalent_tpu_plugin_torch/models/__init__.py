"""Models of the PyTorch port: the transformer LM, its training path and
its serving path (KV-cache decoding, ``generate``, continuous batching)."""

from .convert import params_from_jax
from .data import synthetic_lm_batch, synthetic_lm_batches
from .decode import generate, inference_params, init_cache
from .serve import (
    ContinuousEngine,
    RollingCacheUnsupported,
    continuous_generate,
    lm_engine_factory,
    serve_lm,
    step_accounting,
)
from .train import (
    adamw,
    cross_entropy_loss,
    lm_loss,
    make_train_step,
    train_lm,
)
from .transformer import LayerCache, TransformerConfig, TransformerLM, lm_125m_config

__all__ = [
    "ContinuousEngine",
    "LayerCache",
    "RollingCacheUnsupported",
    "TransformerConfig",
    "TransformerLM",
    "adamw",
    "continuous_generate",
    "cross_entropy_loss",
    "generate",
    "inference_params",
    "init_cache",
    "lm_125m_config",
    "lm_engine_factory",
    "lm_loss",
    "make_train_step",
    "params_from_jax",
    "serve_lm",
    "step_accounting",
    "synthetic_lm_batch",
    "synthetic_lm_batches",
    "train_lm",
]
