"""Decoder-only transformer LM (BASELINE config 5: the 125M pretrain).

Counterpart of ``covalent_tpu_plugin/models/transformer.py``: bfloat16
activations, float32 master weights, RMSNorm, half-split rotary embeddings,
tanh-GELU MLP, and an lm_head in ``logits_dtype``.  Every numerical choice
follows the reference (casts included), so weights converted with
:func:`..models.convert.params_from_jax` give the same logits.  On CUDA
tensors ``attention="auto"`` resolves to the hand-written flash kernels;
elsewhere to the dense reference.

The serving entry points call :func:`use_batch_invariant`, which routes
the dense products, the decode attention's two products and RMSNorm
through the batch-invariant kernels of :mod:`..ops.batch_invariant` (a row
computes the same bits whatever shares its batch, the reference engine's
contract).  Training keeps the library products.  Each residual add goes
with the norm after it (:meth:`RMSNorm.add_norm`), which the route takes in
one launch; the plain route runs the add and the norm apart, the
reference's ops in its order.

Incremental decoding passes an explicit KV cache, one :class:`LayerCache`
per layer (``models/decode.py: init_cache``), to ``forward(tokens,
cache=...)``, which updates it in place: the reference keeps the same state
in flax's "cache" collection.  The cache has a cursor per row, so rows of
one batch may sit at different positions (the serving engine's lanes).

Scale-out: :meth:`TransformerLM.param_logical_axes` names each parameter's
logical axes as the reference's ``nn.with_partitioning`` does, and
``parallel.sharding.apply_rules`` (or a config whose ``mesh`` is set) shards
the model over a device mesh: FSDP2 over ``fsdp``, and over ``tensor`` the
attention heads, the MLP hidden width and the vocabulary (Megatron's column
and row parallelism, :meth:`tensor_parallel`).  Each layer then computes on
its local shards as plain tensors: the flash kernels take ``(B, H / tensor,
S, D)``.  Over ``seq`` (``attention="ring"`` or ``"ulysses"``) each rank
holds its part of every sequence, at the global positions
``forward(..., positions=)`` must give (``parallel.sharding.shard_batch``
cuts them in the model's layout, :meth:`TransformerLM.sequence_zigzag`):
rotary takes them, and the attention joins the parts
(``ops/ring_attention.py``).  Over ``pipe`` each rank keeps the contiguous
run of layers its stage holds (:meth:`TransformerLM.pipeline_parallel`) and
``models/pipeline_lm.py`` runs the GPipe schedule.  The reference's layer
stacking (``scan_layers``) has no counterpart: layers are an
``nn.ModuleList``, and the converter reads either stacked or unrolled
reference parameters.

``moe_experts`` > 0 swaps every block's MLP for the Switch MoE of
``models/moe.py``; a decoding forward routes it over the call's tokens, or
over each row's with ``per_row`` (the serving engine's lanes).  ``remat``
runs each block under non-reentrant
``torch.utils.checkpoint``: ``remat_policy="full"`` recomputes the whole
block in the backward, ``"dots"`` saves the outputs of its 2-D products
(``aten.mm``/``addmm``, the reference's ``dots_with_no_batch_dims_saveable``,
which likewise saves no batched product) and recomputes the rest, the
flash forward included.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from ..ops import batch_invariant as bi
from ..ops.attention import NEG_INF, flash_attention, mha_reference, on_cuda
from ..ops.ring_attention import default_zigzag, sequence_parallel_attention
from ..parallel.sharding import _local
from .lora import LoRADense
from .moe import MoEMlp
from .quant import QuantDense

#: Decoding a tensor-parallel model comes with this slice.
SLICE_4_PART_3 = ("slice 4, part 3(b) (tensor-parallel decoding on a tensor gang, "
                  "ROADMAP Queue 1 item 1(b))")


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
    #: auto | flash | reference | ring | ulysses (the last two need a mesh).
    attention: str = "auto"
    #: sliding-window attention: each query sees the `sliding_window` most
    #: recent positions.
    sliding_window: int | None = None
    #: attention sinks: the first positions stay visible to every query.
    attention_sinks: int = 0
    #: rotary embedding wavelength base (theta).
    rope_base: float = 10000.0
    #: incremental decoding only: ``forward`` then needs a ``cache``.
    decode: bool = False
    #: circular KV cache of ``sliding_window + attention_sinks`` slots
    #: (sink slots pinned) instead of ``max_seq``.
    rolling_cache: bool = False
    #: int8 KV cache with one f32 scale per (row, slot, kv head).
    quantized_kv_cache: bool = False
    #: > 0 replaces every block's MLP with a Switch top-1 MoE of that many
    #: experts (models/moe.py); the "expert" logical axis shards them over
    #: the tensor mesh axis.
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    #: rematerialise each block in the backward (torch.utils.checkpoint)
    remat: bool = False
    #: "full" recomputes everything; "dots" saves the 2-D products' outputs
    remat_policy: str = "full"
    #: int8 weight-only denses (models/quant.py), the lm_head included;
    #: build via quant.quantize_lm().
    quantized: bool = False
    #: LoRA (models/lora.py): > 0 attaches rank-r adapters to the targeted
    #: denses; build via lora.add_lora() / lora.quantize_then_lora().
    lora_rank: int = 0
    lora_alpha: float = 16.0
    #: which dense layers get adapters (attention + MLP, not the lm_head).
    lora_targets: tuple = ("q_proj", "k_proj", "v_proj", "out_proj", "wi", "wo")
    #: a ``parallel.mesh`` DeviceMesh: the model shards itself over it
    #: (``parallel.sharding.apply_rules``) once built.
    mesh: Any = None

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
        if self.attention not in ("auto", "flash", "reference", "ring", "ulysses"):
            raise ValueError(
                "attention must be auto, flash, reference, ring or ulysses, got "
                f"{self.attention!r}"
            )
        if self.lora_rank < 0:
            raise ValueError(f"lora_rank must be >= 0, got {self.lora_rank}")
        if self.mesh is not None and (self.quantized or self.lora_rank):
            # the reference serves and tunes them on one device only
            raise NotImplementedError(
                "a quantized or LoRA model under a mesh is not ported: quantization "
                "and adapters run on one device")
        if self.remat and self.remat_policy not in ("full", "dots"):
            # the reference's message, raised when its remat block is built
            raise ValueError(
                f"remat_policy must be 'full' or 'dots', got {self.remat_policy!r}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def lm_125m_config(**overrides) -> TransformerConfig:
    """GPT-2-small-class preset (~125M params with a 32k vocab)."""
    return TransformerConfig(**overrides)


def use_batch_invariant(model: "TransformerLM") -> "TransformerLM":
    """Route ``model``'s dense products, decode-attention products,
    RMSNorms and MoE layers through the batch-invariant kernels (plain
    versions on the CPU): the serving entry points' route.  Returns
    ``model``."""
    for module in model.modules():
        if isinstance(module, (Dense, LoRADense, RMSNorm, Attention, MoEMlp)):
            module.batch_invariant = True
        if isinstance(module, MoEMlp):
            module.serving_layout()
    return model


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; never a silent CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def _rotary_tables(positions: torch.Tensor, head_dim: int, base: float, dtype):
    """cos and sin, (B or 1, S, 1, D/2) in ``dtype``, for float positions of
    shape (S,) or (B, S)."""
    half = head_dim // 2
    freqs = base ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    )
    angles = positions.to(torch.float32)[..., None] * freqs
    if angles.dim() == 2:
        angles = angles[None]
    return torch.cos(angles)[:, :, None, :].to(dtype), torch.sin(angles)[:, :, None, :].to(dtype)


def _apply_rotary(x: torch.Tensor, cos, sin) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rotary(x: torch.Tensor, base: float = 10000.0,
            positions: torch.Tensor | None = None) -> torch.Tensor:
    """Rotary position embedding over (B, S, H, D) with D even, half-split;
    cos/sin are cast to the activation dtype before the multiply.

    ``positions`` ((S,) or per row (B, S)) are the absolute positions of the
    S tokens, 0..S-1 when omitted: the reference's ``offset + arange(S)``,
    with a cursor per row instead of one offset.
    """
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    return _apply_rotary(x, *_rotary_tables(positions, x.shape[-1], base, x.dtype))


@dataclasses.dataclass
class LayerCache:
    """One layer's KV cache, updated in place by a decoding ``forward``.

    ``k``/``v`` are (B, L, kv heads, D) in the activation dtype, or int8 with
    f32 ``k_scale``/``v_scale`` of shape (B, L, kv heads, 1).  ``cursor``
    (B,) is each row's next position.  ``slot_pos`` (B, L), rolling caches
    only, is the absolute position each slot holds, -1 never written.
    ``bound`` is a host-side upper bound of ``cursor``, so a write that would
    run past the cache raises without reading the cursor from the device.
    """

    k: torch.Tensor
    v: torch.Tensor
    cursor: torch.Tensor
    bound: int = 0
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None
    slot_pos: torch.Tensor | None = None


def _quantize_kv(x: torch.Tensor):
    """Symmetric int8 per (b, s, h): scale = max(amax over D, 1e-8) / 127,
    rounded half to even and clipped to +-127, as the reference."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


class Dense(nn.Module):
    """Bias-free dense layer with the reference's dtype rule: inputs and the
    (param_dtype) weight are both cast to ``dtype`` before the product."""

    batch_invariant = False
    #: under tensor parallelism, a weight replicated over ``tensor`` of which
    #: this rank uses some rows: ``(TensorParallel, rows)`` (a GQA model's
    #: k/v projections).  Its gradient is summed over the group.
    shared_rows = None

    def __init__(self, in_features: int, out_features: int, dtype, param_dtype,
                 std: float, device, generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, dtype=param_dtype, device=device)
        )
        nn.init.normal_(self.weight, 0.0, std, generator=generator)

    def forward(self, x):
        linear = bi.linear if self.batch_invariant else bi.linear_plain
        weight = _local(self.weight)
        if self.shared_rows is not None:
            tp, rows = self.shared_rows
            weight = tp.enter(weight)[rows]
        return linear(x, weight, self.dtype)


def make_dense(cfg: TransformerConfig, name: str, in_features: int, out_features: int,
               dtype, std: float, device, generator) -> nn.Module:
    """The LM's one dense-layer factory (the reference's ``dense_general``,
    ``quant.py:92-142``): float, int8, or either with a LoRA adapter when
    ``name`` is one of ``cfg.lora_targets``.  All four hold the base weight
    under ``weight``, so state dicts line up across them."""
    if cfg.lora_rank and name in cfg.lora_targets:
        return LoRADense(in_features, out_features, dtype, cfg.param_dtype, std, device,
                         generator, rank=cfg.lora_rank, alpha=cfg.lora_alpha,
                         quantized=cfg.quantized)
    if cfg.quantized:
        return QuantDense(in_features, out_features, dtype, cfg.param_dtype, std, device,
                          generator)
    return Dense(in_features, out_features, dtype, cfg.param_dtype, std, device, generator)


class RMSNorm(nn.Module):
    """RMSNorm in f32 (eps 1e-6, f32 scale), cast back to ``dtype``."""

    batch_invariant = False

    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        norm = bi.rms_norm if self.batch_invariant else bi.rms_norm_plain
        return norm(x, _local(self.scale), self.dtype)

    def add_norm(self, x, delta):
        """The residual add before this norm and the norm of its sum: ``(x +
        delta, norm(x + delta))``, one kernel on the batch-invariant route."""
        add_norm = bi.add_rms_norm if self.batch_invariant else bi.add_rms_norm_plain
        return add_norm(x, delta, _local(self.scale), self.dtype)


class Attention(nn.Module):
    batch_invariant = False
    #: the ``parallel.sharding.TensorParallel`` handle under tensor parallelism
    tp = None
    #: the mesh of sequence-parallel attention (``sequence_parallel``), when
    #: the config carries none
    mesh = None

    def __init__(self, cfg: TransformerConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        self.kv_heads = cfg.n_kv_heads or cfg.n_heads
        if cfg.n_heads % self.kv_heads:
            raise ValueError(
                f"n_heads {cfg.n_heads} must be divisible by n_kv_heads {self.kv_heads}"
            )
        d, hd = cfg.d_model, cfg.head_dim
        dense = lambda name, i, o, std: make_dense(  # noqa: E731
            cfg, name, i, o, cfg.dtype, std, device, generator
        )
        self.q_proj = dense("q_proj", d, cfg.n_heads * hd, 0.02)
        self.k_proj = dense("k_proj", d, self.kv_heads * hd, 0.02)
        self.v_proj = dense("v_proj", d, self.kv_heads * hd, 0.02)
        # residual-output kernel: depth-scaled init (GPT-2 convention)
        self.out_proj = dense("out_proj", cfg.n_heads * hd, d, 0.02 / (2 * cfg.n_layers) ** 0.5)

    def tensor_parallel(self, tp) -> None:
        """Heads over ``tensor``: q/k/v column-parallel (this rank's block of
        query heads), ``out_proj`` row-parallel.  A GQA model's k/v
        projections stay whole on every rank (the rules' ``kv_heads``); each
        rank takes the rows of the kv heads its query heads read."""
        cfg = self.cfg
        group = cfg.n_heads // self.kv_heads
        local = cfg.n_heads // tp.size
        if cfg.n_heads % tp.size or (local % group and group % local):
            raise ValueError(
                f"{cfg.n_heads} query heads in groups of {group} do not split over "
                f"tensor={tp.size}"
            )
        self.tp = tp
        if self.kv_heads != cfg.n_heads:
            first = tp.rank * local // group
            count = max(1, local // group)
            rows = slice(first * cfg.head_dim, (first + count) * cfg.head_dim)
            self.k_proj.shared_rows = self.v_proj.shared_rows = (tp, rows)

    def sequence_parallel(self, mesh) -> None:
        """The mesh whose ``seq`` axis ``attention="ring"``/``"ulysses"`` runs
        over (``parallel.sharding.apply_rules`` hands it over)."""
        self.mesh = mesh

    def forward(self, x, cache: LayerCache | None = None, positions=None):
        cfg = self.cfg
        batch, seq, _ = x.shape
        if self.tp is not None:
            if cache is not None:
                raise NotImplementedError(
                    f"decoding a tensor-parallel model comes with {SLICE_4_PART_3}")
            x = self.tp.enter(x)
        # -1: this rank's heads under tensor parallelism, else all of them
        q = self.q_proj(x).view(batch, seq, -1, cfg.head_dim)
        k = self.k_proj(x).view(batch, seq, -1, cfg.head_dim)
        v = self.v_proj(x).view(batch, seq, -1, cfg.head_dim)
        if cache is not None:
            return self._decode_step(q, k, v, cache)
        # the rows' global positions: this rank's part of the sequence under
        # seq parallelism, where arange(S) would be wrong
        q = _rotary(q, base=cfg.rope_base, positions=positions)
        k = _rotary(k, base=cfg.rope_base, positions=positions)
        # (B, S, H, D) -> (B, H, S, D) for the attention kernels
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        impl = cfg.attention
        if impl == "auto":
            impl = "flash" if on_cuda(x) else "reference"
        if impl in ("ring", "ulysses"):
            mesh = cfg.mesh if cfg.mesh is not None else self.mesh
            if mesh is None:
                raise ValueError(f"attention={impl!r} requires config.mesh")
            if positions is None and mesh["seq"].size() > 1:
                # arange(S) is not where this rank's rows sit in the sequence
                raise ValueError(
                    f"attention={impl!r} over seq={mesh['seq'].size()} needs the global "
                    "positions of this rank's rows (parallel.sharding.shard_batch)")
            if cfg.attention_sinks and impl == "ring":
                # Sink columns live on shard 0 only; every hop would need them
                # resident.  Ulysses' full-sequence local attention composes.
                raise ValueError(
                    "attention_sinks are unsupported with attention='ring'"
                    " — use attention='ulysses'"
                )
            if impl == "ring" and kh.shape[1] != qh.shape[1]:
                # the ring shards the sequence, not the heads: repeat kv heads
                group = qh.shape[1] // kh.shape[1]
                kh = kh.repeat_interleave(group, dim=1)
                vh = vh.repeat_interleave(group, dim=1)
            out = sequence_parallel_attention(
                qh, kh, vh, mesh, causal=True, window=cfg.sliding_window,
                sinks=cfg.attention_sinks, impl="ulysses" if impl == "ulysses" else None,
            )
        else:
            attend = flash_attention if impl == "flash" else mha_reference
            out = attend(qh, kh, vh, causal=True, window=cfg.sliding_window,
                         sinks=cfg.attention_sinks)
        out = self.out_proj(out.transpose(1, 2).reshape(batch, seq, -1))
        return out if self.tp is None else self.tp.leave(out)

    def _decode_step(self, q, k, v, cache: LayerCache):
        """Incremental attention against the layer's KV cache.

        A multi-token call is a prefill: the slab's K/V land in the cache at
        each row's cursor and the slab attends the cache with per-row causal
        visibility by column position.  A one-token call is a decode step.
        The attention is plain products over the cache, as in the reference
        (``transformer.py:465-500``): decode has no flash kernel.  A write
        past the end of a plain cache raises (the reference's
        ``dynamic_update_slice`` would clamp it).
        """
        cfg = self.cfg
        batch, slab = q.shape[:2]
        rolling, sinks, window = cfg.rolling_cache, cfg.attention_sinks, cfg.sliding_window
        cache_len = cache.k.shape[1]
        if slab > cache_len:
            raise ValueError(f"slab of {slab} tokens exceeds the cache length {cache_len}")
        if cache.bound + slab > cache_len and (not rolling or slab > window):
            # A plain cache would overflow; a rolling slab wider than the
            # window that wraps would scatter two tokens into one slot (the
            # order of duplicate indices in a scatter is undefined).
            raise ValueError(
                f"a slab of {slab} tokens at cursor up to {cache.bound} does not fit "
                f"the {'rolling ' if rolling else ''}cache of {cache_len} slots"
                + (f" (rolling slabs that wrap must be <= sliding_window {window})"
                   if rolling else "")
            )
        quant = cache.k_scale is not None
        q_pos = cache.cursor[:, None] + torch.arange(slab, device=q.device)  # (B, S)
        cos, sin = _rotary_tables(q_pos, cfg.head_dim, cfg.rope_base, q.dtype)
        q, k = _apply_rotary(q, cos, sin), _apply_rotary(k, cos, sin)
        if quant:
            (k_store, k_s), (v_store, v_s) = _quantize_kv(k), _quantize_kv(v)
        else:
            k_store, v_store = k.to(cfg.dtype), v.to(cfg.dtype)

        # Rolling multi-token slabs attend the pre-write cache plus the slab
        # itself: the write below may overwrite ring slots that earlier slab
        # rows still need.  torch.cat copies, so this is the snapshot.
        if rolling and slab > 1:
            attend_k = torch.cat([cache.k, k_store], dim=1)
            attend_v = torch.cat([cache.v, v_store], dim=1)
            if quant:
                attend_ks = torch.cat([cache.k_scale, k_s], dim=1)
                attend_vs = torch.cat([cache.v_scale, v_s], dim=1)
            col_pos = torch.cat([cache.slot_pos, q_pos], dim=1)
        if rolling:
            # slot = position while p < sinks (pinned), else sinks + (p - sinks) % W
            idx = torch.where(q_pos < sinks, q_pos, sinks + (q_pos - sinks) % window)
        else:
            idx = q_pos
        rows = torch.arange(batch, device=q.device)[:, None]
        cache.k[rows, idx] = k_store
        cache.v[rows, idx] = v_store
        if quant:
            cache.k_scale[rows, idx] = k_s
            cache.v_scale[rows, idx] = v_s
        if rolling:
            cache.slot_pos[rows, idx] = q_pos
        cache.cursor += slab
        cache.bound += slab
        if not (rolling and slab > 1):
            attend_k, attend_v = cache.k, cache.v
            if quant:
                attend_ks, attend_vs = cache.k_scale, cache.v_scale
            col_pos = cache.slot_pos if rolling else torch.arange(cache_len, device=q.device)[None]

        with torch.profiler.record_function("decode_attention"):
            group = cfg.n_heads // self.kv_heads
            qg = q.reshape(batch, slab, self.kv_heads, group, cfg.head_dim)
            # The reference multiplies the dtype operands with an f32 result
            # (preferred_element_type).  Here both operands are upcast to f32
            # before the product: exact for bf16 inputs, f32 accumulation.
            scores_fn, mix_fn = (
                (bi.attention_scores, bi.attention_mix) if self.batch_invariant
                else (bi.attention_scores_plain, bi.attention_mix_plain)
            )
            scores = scores_fn(qg, attend_k.to(cfg.dtype)) * (cfg.head_dim ** -0.5)
            if quant:
                # the scale is constant over D: applied after the product
                scores = scores * attend_ks[..., 0].transpose(1, 2)[:, :, None, None, :]
            # a query sees a column iff it is written, causal-past and in the
            # band; sink positions stay visible at any distance
            sp, qp = col_pos[:, None, :], q_pos[:, :, None]
            visible = (sp >= 0) & (sp <= qp)
            if window is not None:
                in_band = sp > qp - window
                if sinks:
                    in_band |= sp < sinks
                visible &= in_band
            scores = torch.where(visible[:, None, None], scores, NEG_INF)
            probs = torch.softmax(scores, dim=-1)
            if quant:
                # the V scale folds into the probabilities (constant over D)
                probs = probs * attend_vs[..., 0].transpose(1, 2)[:, :, None, None, :]
            probs = probs.to(cfg.dtype)
            # P is rounded to the activation dtype first, as the reference;
            # the product again upcasts to f32
            out = mix_fn(probs, attend_v.to(cfg.dtype))
        out = out.reshape(batch, slab, cfg.n_heads * cfg.head_dim)
        return self.out_proj(out.to(cfg.dtype))


class MlpBlock(nn.Module):
    #: the ``parallel.sharding.TensorParallel`` handle under tensor parallelism
    tp = None

    def __init__(self, cfg: TransformerConfig, device, generator):
        super().__init__()
        self.wi = make_dense(cfg, "wi", cfg.d_model, cfg.d_ff, cfg.dtype, 0.02, device,
                             generator)
        self.wo = make_dense(cfg, "wo", cfg.d_ff, cfg.d_model, cfg.dtype,
                             0.02 / (2 * cfg.n_layers) ** 0.5, device, generator)

    def tensor_parallel(self, tp) -> None:
        """The hidden width over ``tensor``: ``wi`` column-, ``wo`` row-parallel."""
        self.tp = tp

    def forward(self, x, per_row: bool = False):
        """``per_row`` is the MoE's routing mode; a dense MLP's rows are
        independent either way."""
        if self.tp is not None:
            x = self.tp.enter(x)
        # flax nn.gelu is the tanh approximation
        out = self.wo(F.gelu(self.wi(x), approximate="tanh"))
        return out if self.tp is None else self.tp.leave(out)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device, generator):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.attention = Attention(cfg, device, generator)
        self.ln_mlp = RMSNorm(cfg.d_model, cfg.dtype, device)
        mlp = MoEMlp if cfg.moe_experts > 0 else MlpBlock
        self.mlp = mlp(cfg, device, generator)

    def forward(self, x, h, after: RMSNorm | None, cache: LayerCache | None = None,
                positions=None, per_row: bool = False):
        """The layer on the residual stream ``x`` and its norm ``h =
        ln_attn(x)``: the new stream and ``after``'s norm of it (the next
        layer's ``ln_attn``, or ``ln_final``).  Each residual add goes with
        the norm that follows it (:meth:`RMSNorm.add_norm`).  Without
        ``after`` (the last layer of a pipeline stage) the norm is None.
        ``per_row`` routes an MoE layer over each row's tokens alone."""
        x, h = self.ln_mlp.add_norm(x, self.attention(h, cache, positions))
        if after is None:
            return x + self.mlp(h, per_row), None
        return after.add_norm(x, self.mlp(h, per_row))


def _save_products(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the 2-D products' outputs, recompute the
    rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


class TransformerLM(nn.Module):
    """Causal LM: tokens (B, S) -> logits (B, S, vocab).

    ``device`` defaults to the card; ``generator`` seeds the weight init.
    ``forward(tokens, cache=...)`` decodes against a KV cache (one
    :class:`LayerCache` per layer, from ``models.decode.init_cache``).
    Under tensor parallelism ``forward`` returns this rank's block of the
    vocabulary's logits (:meth:`vocab_block`).
    """

    #: the ``parallel.sharding.TensorParallel`` handle under tensor parallelism
    tp = None
    #: the mesh whose ``pipe`` axis splits the layers (``pipeline_parallel``)
    pipe_mesh = None

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
        self.lm_head = make_dense(cfg, "lm_head", cfg.d_model, cfg.vocab_size,
                                  cfg.logits_dtype, 0.02, device, generator)
        if cfg.mesh is not None:
            from ..parallel.sharding import apply_rules

            apply_rules(self, cfg.mesh)

    def param_logical_axes(self) -> dict[str, tuple]:
        """Each parameter's logical axes, in the port's ``(out, in)`` layout:
        the reference's ``nn.with_partitioning`` names.  A GQA model's k/v
        projections take ``kv_heads`` (replicated), a plain one's ``heads``."""
        kv = "heads" if self.config.n_kv_heads in (None, self.config.n_heads) else "kv_heads"
        per_layer = {
            "ln_attn.scale": ("embed",), "ln_mlp.scale": ("embed",),
            "attention.q_proj.weight": ("heads", "embed"),
            "attention.k_proj.weight": (kv, "embed"),
            "attention.v_proj.weight": (kv, "embed"),
            "attention.out_proj.weight": ("embed", "heads"),
        }
        if self.config.moe_experts:
            per_layer.update({"mlp.router": (None, "embed"),
                              "mlp.wi": ("expert", "embed", "expert_mlp"),
                              "mlp.wo": ("expert", "expert_mlp", "embed")})
        else:
            per_layer.update({"mlp.wi.weight": ("mlp", "embed"),
                              "mlp.wo.weight": ("embed", "mlp")})
        axes = {"embedding": ("vocab", "embed"), "ln_final.scale": ("embed",),
                "lm_head.weight": ("vocab", "embed")}
        for i in range(len(self.layers)):
            axes.update({f"layers.{i}.{name}": a for name, a in per_layer.items()})
        return axes

    def fsdp_units(self) -> list[nn.Module]:
        """The modules FSDP2 gathers one at a time: each layer's attention and
        MLP.  The norms stay with the root (a layer's forward also runs the
        next layer's first norm)."""
        return [m for layer in self.layers for m in (layer.attention, layer.mlp)]

    def tensor_parallel(self, tp) -> None:
        """The vocabulary over ``tensor``: the embedding looks up this rank's
        rows (tokens outside them read 0) and sums over the group; the
        lm_head is column-parallel."""
        tp.block(self.config.vocab_size)  # refuses a vocabulary that does not split
        self.tp = tp

    def pipeline_parallel(self, mesh) -> None:
        """The layers over ``pipe``: this rank keeps the contiguous run of
        layers its stage holds (``parallel.pipeline.pipeline_stages``), built
        from the same generator stream as the whole model, and the layers
        are numbered from 0 on every stage.  The embedding, ``ln_final`` and
        the lm_head stay whole on every rank."""
        from ..parallel.pipeline import pipeline_stages

        stage = mesh.get_local_rank("pipe")
        self.layers = nn.ModuleList(pipeline_stages(list(self.layers), mesh["pipe"].size())[stage])
        self.pipe_mesh = mesh

    def stage_parameters(self) -> list[nn.Parameter]:
        """The parameters only this rank's pipeline stage holds (none unless
        the layers are split over ``pipe``)."""
        return [] if self.pipe_mesh is None else list(self.layers.parameters())

    def run_layer(self, layer: Block, x, h, after, cache=None, positions=None,
                  per_row: bool = False):
        """``layer(x, h, after, cache, positions, per_row)``, under activation
        checkpointing when the config asks for ``remat`` (training only)."""
        cfg = self.config
        if not (cfg.remat and cache is None and torch.is_grad_enabled()):
            return layer(x, h, after, cache, positions, per_row)
        context = ckpt.noop_context_fn
        if cfg.remat_policy == "dots":
            context = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                        _save_products)
        return ckpt.checkpoint(layer, x, h, after, None, positions, per_row,
                               use_reentrant=False, context_fn=context)

    def sequence_zigzag(self, seq_len: int, n: int) -> bool:
        """Whether a ``seq_len`` sequence split over ``n`` ``seq`` ranks lies
        zigzag-striped on them (else contiguous): the reference's rule
        (``ops.ring_attention.default_zigzag``), which the data layer
        (``parallel.sharding.shard_batch``) and the attention both follow."""
        cfg = self.config
        impl = "ulysses" if cfg.attention == "ulysses" else None
        return default_zigzag(True, n, seq_len, cfg.sliding_window, impl)

    def vocab_block(self) -> slice:
        """The block of the vocabulary this rank's logits hold."""
        if self.tp is None:
            return slice(0, self.config.vocab_size)
        return self.tp.block(self.config.vocab_size)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        table = _local(self.embedding).to(self.config.dtype)
        if self.tp is None:
            return F.embedding(tokens, table)
        block = self.vocab_block()
        idx = tokens - block.start
        inside = (idx >= 0) & (idx < block.stop - block.start)
        rows = F.embedding(torch.where(inside, idx, 0), table)
        # one rank holds each token's row, the others add zeros: exact
        return self.tp.leave(rows * inside[..., None].to(rows.dtype))

    def forward(self, tokens: torch.Tensor, return_features: bool = False,
                cache: list[LayerCache] | None = None, positions=None,
                per_row: bool = False):
        """``positions`` ((S,)) are the global positions of the rows of
        ``tokens``: under sequence parallelism this rank's part of each
        sequence (required there), else 0..S-1 by default.  ``per_row``
        routes every MoE layer over each row's tokens alone (the serving
        engine's lanes, the reference's vmapped batch-1 decode); by default
        an MoE layer routes over all the call's tokens, as the reference's
        ``generate`` and training do."""
        cfg = self.config
        if tokens.shape[-1] > cfg.max_seq:
            raise ValueError(
                f"sequence length {tokens.shape[-1]} exceeds config.max_seq "
                f"{cfg.max_seq}"
            )
        if self.pipe_mesh is not None:
            raise ValueError("a model split over pipe runs through "
                             "models.pipeline_lm.pipeline_lm_forward")
        if cache is None:
            if cfg.decode:
                raise ValueError("a decode=True model needs a cache (models.decode.init_cache)")
            cache = [None] * len(self.layers)
        elif len(cache) != len(self.layers):
            raise ValueError(f"cache has {len(cache)} layers, the model {len(self.layers)}")
        if positions is not None:
            positions = torch.as_tensor(positions, device=tokens.device)
        x = self._embed(tokens)
        # Only the first norm has no residual add before it.
        norms = [layer.ln_attn for layer in self.layers] + [self.ln_final]
        h = norms[0](x)
        for layer, after, layer_cache in zip(self.layers, norms[1:], cache):
            x, h = self.run_layer(layer, x, h, after, layer_cache, positions, per_row)
        if return_features:
            # The fused-xent loss (ops/xent.py) consumes the final features
            # and the lm_head weight directly, so the logits never exist.
            return h
        return self.lm_head(h if self.tp is None else self.tp.enter(h))

    def parameter_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
