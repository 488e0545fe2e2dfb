"""Weight-only int8 quantization for serving.

Counterpart of ``covalent_tpu_plugin/models/quant.py``.  Decode re-reads
the whole weight set every step, so fewer weight bytes are a direct
speedup: bf16 halves them (``decode.inference_params``) and int8 halves
them again.  The scheme is the reference's:

* each dense weight is stored as **int8** with a **per-output-channel f32
  scale** (``scale = max(amax(|w|), 1e-8) / 127`` over the input axes);
* the product is ``x @ q.to(dtype)`` followed by ``* scale.to(dtype)``,
  each rounded to ``dtype`` (``quant.py:84-89``): bf16 on the attention and
  MLP denses, ``logits_dtype`` (f32) on the lm_head;
* activations, the embedding and the norms are untouched.

On CUDA tensors the product is the hand-written int8-weight kernel of
``ops.batch_invariant.linear_w8`` (``csrc/bi_gemm_w8.cu``): the int8 weight
is what crosses HBM, widened to bf16 on the way to the tensor cores.

Usage::

    qmodel = quantize_lm(model)        # f32 or bf16 weights in
    generate(qmodel, prompt, n)        # the same API as before

``TransformerConfig(quantized=True)`` builds every dense as a
:class:`QuantDense` (the lm_head too); :func:`quantize_lm` builds that model
without initialising it and fills it from the float weights.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import batch_invariant as bi

#: The serving tier's closed decode-mode set (the per-request ``quality``
#: knob's values).  ``fp`` is the bit-exact lane every refusal falls back
#: to; the others trade exactness for HBM bytes.
SERVING_MODES = ("fp", "int8", "kv_quant", "full_quant")


def quantize_array(w, n_feature_dims: int):
    """Symmetric per-output-channel int8 of ``w``: ``(q, scale)``.

    The input (contraction) axes are the leading ``w.ndim - n_feature_dims``
    dims, the reference's ``DenseGeneral`` kernel layout
    (``quant.py:145-160``): ``scale = max(amax, 1e-8) / 127`` in f32, ``q``
    rounded half to even and clipped to +-127.  Takes a tensor or anything
    numpy reads; bit-equal to the reference on the same f32 values.
    """
    w32 = torch.as_tensor(w).float()
    input_axes = tuple(range(w32.dim() - n_feature_dims))
    amax = w32.abs().amax(dim=input_axes) if input_axes else w32.abs()
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(weight: torch.Tensor):
    """:func:`quantize_array` of a port dense weight, laid out ``(out, in)``:
    one scale per output row."""
    q, scale = quantize_array(weight.detach().t(), 1)
    return q.t().contiguous(), scale


class QuantDense(nn.Module):
    """Twin of ``transformer.Dense`` holding an int8 ``weight`` ``(out, in)``
    and an f32 ``scale`` ``(out,)``, under the same names, so a quantized
    state dict lines up with the dense model's (the reference's
    ``QuantDenseGeneral``, ``quant.py:42-89``).  Both are parameters that
    take no gradient: ``decode.inference_params`` casts the scale as the
    reference's casts every f32 leaf.  It has no other route: on CUDA
    tensors its product is always the int8-weight kernel."""

    def __init__(self, in_features: int, out_features: int, dtype, param_dtype, std: float,
                 device, generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros(out_features, in_features, dtype=torch.int8, device=device),
            requires_grad=False)
        self.scale = nn.Parameter(
            torch.ones(out_features, dtype=param_dtype, device=device), requires_grad=False)

    def forward(self, x):
        return bi.linear_w8(x, self.weight, self.scale, self.dtype)


def quantize_lm(model):
    """The ``quantized=True`` twin of a trained LM: int8 ``weight`` + f32
    ``scale`` pairs from the float denses (the lm_head included), the
    embedding and the norms copied through (``quant.py:205-266``).  The twin
    is built on the meta device, so no weights are initialised twice.
    Refuses MoE models and models that carry adapters (quantize the base
    first, then attach: :func:`..lora.quantize_then_lora`)."""
    from .transformer import Dense, TransformerLM

    config = model.config
    if config.moe_experts:
        raise ValueError("quantize_lm does not support MoE models yet")
    if config.lora_rank:
        raise ValueError("quantize the base first, then attach adapters "
                         "(lora.quantize_then_lora)")
    if config.quantized:
        raise ValueError("the model is quantized already")
    qmodel = TransformerLM(dataclasses.replace(config, quantized=True),
                           device=torch.device("meta"))
    source = dict(model.named_modules())
    state = {}
    with torch.no_grad():
        for name, module in qmodel.named_modules():
            if isinstance(module, QuantDense):
                dense = source[name]
                if not isinstance(dense, Dense):
                    raise ValueError(f"{name}: expected a float dense, got {type(dense).__name__}")
                q, scale = quantize_weight(dense.weight)
                state[f"{name}.weight"], state[f"{name}.scale"] = q, scale
        for name, tensor in model.state_dict().items():
            state.setdefault(name, tensor)
    # assign: the twin takes these tensors (the embedding and the norms
    # shared with ``model``), each parameter keeping its requires_grad
    qmodel.load_state_dict(state, assign=True)
    return qmodel


def mode_variant(model, mode: str):
    """The model twin of one serving decode mode (``quant.py:165-202``):

    * ``fp``: ``model`` itself (the bit-exact lane);
    * ``int8``: :func:`quantize_lm`;
    * ``kv_quant``: the same weights (shared, not copied) with an int8 KV
      cache;
    * ``full_quant``: both.

    Raises :class:`ValueError` on an unknown mode and propagates
    :func:`quantize_lm`'s refusals, which the serving engine records as a
    per-mode refusal with fp fallback.
    """
    from .transformer import TransformerLM

    if mode not in SERVING_MODES:
        raise ValueError(f"unknown decode mode {mode!r}; expected one of {SERVING_MODES}")
    if mode == "fp":
        return model
    base = quantize_lm(model) if mode in ("int8", "full_quant") else model
    if mode == "int8":
        return base
    twin = TransformerLM(dataclasses.replace(base.config, quantized_kv_cache=True),
                         device=torch.device("meta"))
    twin.load_state_dict(base.state_dict(), assign=True)
    return twin
