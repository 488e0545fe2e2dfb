"""Models of the PyTorch port: the MNIST MLP and CNN, the transformer LM
(dense or with Switch MoE blocks), their training paths (one process, or one
rank of a sharded or pipelined gang) and the LM's serving path (KV-cache
decoding, ``generate``, continuous batching, int8 weights and LoRA adapters)."""

from .convert import cnn_params_from_jax, mlp_params_from_jax, params_from_jax, place_on_mesh
from .data import synthetic_lm_batch, synthetic_lm_batches
from .decode import generate, inference_params, init_cache
from .lora import (
    LoRADense,
    add_lora,
    lora_mask,
    lora_optimizer,
    make_lora_train_state,
    make_lora_train_step,
    merge_lora,
    quantize_then_lora,
)
from .mlp import MLP, MnistCNN, synthetic_mnist
from .moe import MoEMlp, lm_loss_with_moe_aux
from .pipeline_lm import pipeline_lm_forward, pipeline_lm_loss
from .quant import QuantDense, quantize_lm
from .serve import (
    AdapterUnsupported,
    ContinuousEngine,
    RollingCacheUnsupported,
    continuous_generate,
    lm_engine_factory,
    serve_lm,
    step_accounting,
)
from .train import (
    adam,
    adamw,
    classifier_loss,
    cross_entropy_loss,
    lm_loss,
    make_classifier_train_step,
    make_sharded_train_state,
    make_train_step,
    train_lm,
    train_mnist,
)
from .transformer import (
    LayerCache,
    TransformerConfig,
    TransformerLM,
    lm_125m_config,
    use_batch_invariant,
)

__all__ = [
    "MLP",
    "AdapterUnsupported",
    "ContinuousEngine",
    "LayerCache",
    "LoRADense",
    "MnistCNN",
    "MoEMlp",
    "QuantDense",
    "RollingCacheUnsupported",
    "TransformerConfig",
    "TransformerLM",
    "adam",
    "adamw",
    "add_lora",
    "classifier_loss",
    "cnn_params_from_jax",
    "continuous_generate",
    "cross_entropy_loss",
    "generate",
    "inference_params",
    "init_cache",
    "lm_125m_config",
    "lm_engine_factory",
    "lm_loss",
    "lm_loss_with_moe_aux",
    "lora_mask",
    "lora_optimizer",
    "make_classifier_train_step",
    "make_lora_train_state",
    "make_lora_train_step",
    "make_sharded_train_state",
    "make_train_step",
    "merge_lora",
    "mlp_params_from_jax",
    "params_from_jax",
    "pipeline_lm_forward",
    "pipeline_lm_loss",
    "place_on_mesh",
    "quantize_lm",
    "quantize_then_lora",
    "serve_lm",
    "step_accounting",
    "synthetic_lm_batch",
    "synthetic_lm_batches",
    "synthetic_mnist",
    "train_lm",
    "train_mnist",
    "use_batch_invariant",
]
