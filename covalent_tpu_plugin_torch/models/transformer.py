"""Decoder-only transformer LM (BASELINE config 5: the 125M pretrain).

Counterpart of ``covalent_tpu_plugin/models/transformer.py``, training path
only: bfloat16 activations, float32 master weights, RMSNorm, half-split
rotary embeddings, tanh-GELU MLP, and an lm_head in ``logits_dtype``.  Every
numerical choice follows the reference (casts included), so weights
converted with :func:`..models.convert.params_from_jax` give the same
logits.  On CUDA tensors ``attention="auto"`` resolves to the hand-written
flash kernels; elsewhere to the dense reference.

The reference's layer stacking (``scan_layers``) and logical sharding axes
have no counterpart here: layers are an ``nn.ModuleList``, and the
converter reads either stacked or unrolled reference parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention, mha_reference, on_cuda

#: Config knobs that later slices of the port bring, with the slice that
#: does.  Setting one raises instead of being silently ignored.
_LATER_SLICES = {
    "decode": "slice 2 (serving)",
    "rolling_cache": "slice 2 (serving)",
    "quantized_kv_cache": "slice 2 (serving)",
    "quantized": "slice 3 (quantization, LoRA, speculative and beam decoding)",
    "lora_rank": "slice 3 (quantization, LoRA, speculative and beam decoding)",
    "moe_experts": "slice 4 (scale-out)",
    "mesh": "slice 4 (scale-out)",
    "remat": "slice 5 (remat and the rest of the executor)",
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    #: kv heads for grouped-query attention; None = n_heads (plain MHA).
    n_kv_heads: int | None = None
    d_ff: int = 3072
    max_seq: int = 1024
    dtype: torch.dtype = torch.bfloat16        # activations
    param_dtype: torch.dtype = torch.float32   # master weights
    #: lm_head matmul dtype (the loss re-casts to f32 for the softmax).
    logits_dtype: torch.dtype = torch.float32
    #: auto | flash | reference ("ring" and "ulysses" come with scale-out).
    attention: str = "auto"
    #: sliding-window attention: each query sees the `sliding_window` most
    #: recent positions.
    sliding_window: int | None = None
    #: attention sinks: the first positions stay visible to every query.
    attention_sinks: int = 0
    #: rotary embedding wavelength base (theta).
    rope_base: float = 10000.0
    # Knobs of later slices (see _LATER_SLICES); only the defaults run here.
    decode: bool = False
    rolling_cache: bool = False
    quantized_kv_cache: bool = False
    quantized: bool = False
    lora_rank: int = 0
    moe_experts: int = 0
    mesh: Any = None
    remat: bool = False

    def __post_init__(self):
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1, got {self.sliding_window}"
            )
        if self.rolling_cache and self.sliding_window is None:
            raise ValueError("rolling_cache requires sliding_window")
        if self.attention_sinks:
            if self.attention_sinks < 0:
                raise ValueError(
                    f"attention_sinks must be >= 0, got {self.attention_sinks}"
                )
            if self.sliding_window is None:
                raise ValueError("attention_sinks require sliding_window")
        if self.attention in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention={self.attention!r} comes with slice 4 (scale-out)"
            )
        if self.attention not in ("auto", "flash", "reference"):
            raise ValueError(
                f"attention must be auto, flash or reference, got {self.attention!r}"
            )
        for name, slice_name in _LATER_SLICES.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet: it comes "
                    f"with {slice_name}"
                )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def lm_125m_config(**overrides) -> TransformerConfig:
    """GPT-2-small-class preset (~125M params with a 32k vocab)."""
    return TransformerConfig(**overrides)


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; never a silent CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def _rotary(x: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over (B, S, H, D) with D even, half-split;
    cos/sin are cast to the activation dtype before the multiply."""
    _, seq_len, _, head_dim = x.shape
    half = head_dim // 2
    freqs = base ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    positions = torch.arange(seq_len, dtype=torch.float32, device=x.device)
    angles = positions[:, None] * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Dense(nn.Module):
    """Bias-free dense layer with the reference's dtype rule: inputs and the
    (param_dtype) weight are both cast to ``dtype`` before the product."""

    def __init__(self, in_features: int, out_features: int, dtype, param_dtype,
                 std: float, device, generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, dtype=param_dtype, device=device)
        )
        nn.init.normal_(self.weight, 0.0, std, generator=generator)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class RMSNorm(nn.Module):
    """RMSNorm in f32 (eps 1e-6, f32 scale), cast back to ``dtype``."""

    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        x32 = x.float()
        norm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
        return (norm * self.scale).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        self.kv_heads = cfg.n_kv_heads or cfg.n_heads
        if cfg.n_heads % self.kv_heads:
            raise ValueError(
                f"n_heads {cfg.n_heads} must be divisible by n_kv_heads {self.kv_heads}"
            )
        d, hd = cfg.d_model, cfg.head_dim
        dense = lambda i, o, std: Dense(  # noqa: E731
            i, o, cfg.dtype, cfg.param_dtype, std, device, generator
        )
        self.q_proj = dense(d, cfg.n_heads * hd, 0.02)
        self.k_proj = dense(d, self.kv_heads * hd, 0.02)
        self.v_proj = dense(d, self.kv_heads * hd, 0.02)
        # residual-output kernel: depth-scaled init (GPT-2 convention)
        self.out_proj = dense(cfg.n_heads * hd, d, 0.02 / (2 * cfg.n_layers) ** 0.5)

    def forward(self, x):
        cfg = self.cfg
        batch, seq, _ = x.shape
        q = self.q_proj(x).view(batch, seq, cfg.n_heads, cfg.head_dim)
        k = self.k_proj(x).view(batch, seq, self.kv_heads, cfg.head_dim)
        v = self.v_proj(x).view(batch, seq, self.kv_heads, cfg.head_dim)
        q = _rotary(q, base=cfg.rope_base)
        k = _rotary(k, base=cfg.rope_base)
        # (B, S, H, D) -> (B, H, S, D) for the attention kernels
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        impl = cfg.attention
        if impl == "auto":
            impl = "flash" if on_cuda(x) else "reference"
        attend = flash_attention if impl == "flash" else mha_reference
        out = attend(qh, kh, vh, causal=True, window=cfg.sliding_window,
                     sinks=cfg.attention_sinks)
        out = out.transpose(1, 2).reshape(batch, seq, cfg.n_heads * cfg.head_dim)
        return self.out_proj(out)


class MlpBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, generator):
        super().__init__()
        self.wi = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, cfg.param_dtype, 0.02,
                        device, generator)
        self.wo = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, cfg.param_dtype,
                        0.02 / (2 * cfg.n_layers) ** 0.5, device, generator)

    def forward(self, x):
        # flax nn.gelu is the tanh approximation
        return self.wo(F.gelu(self.wi(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, generator):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.attention = Attention(cfg, device, generator)
        self.ln_mlp = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.mlp = MlpBlock(cfg, device, generator)

    def forward(self, x):
        x = x + self.attention(self.ln_attn(x))
        return x + self.mlp(self.ln_mlp(x))


class TransformerLM(nn.Module):
    """Causal LM: tokens (B, S) -> logits (B, S, vocab).

    ``device`` defaults to the card; ``generator`` seeds the weight init.
    """

    def __init__(self, config: TransformerConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.embedding = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype, device=device
        ))
        nn.init.normal_(self.embedding, 0.0, 0.02, generator=generator)
        self.layers = nn.ModuleList(
            Block(cfg, device, generator) for _ in range(cfg.n_layers)
        )
        self.ln_final = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.logits_dtype,
                             cfg.param_dtype, 0.02, device, generator)

    def forward(self, tokens: torch.Tensor, return_features: bool = False):
        cfg = self.config
        if tokens.shape[-1] > cfg.max_seq:
            raise ValueError(
                f"sequence length {tokens.shape[-1]} exceeds config.max_seq "
                f"{cfg.max_seq}"
            )
        x = F.embedding(tokens, self.embedding.to(cfg.dtype))
        for layer in self.layers:
            x = layer(x)
        x = self.ln_final(x)
        if return_features:
            # The fused-xent loss (ops/xent.py) consumes the final features
            # and the lm_head weight directly, so the logits never exist.
            return x
        return self.lm_head(x)

    def parameter_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
