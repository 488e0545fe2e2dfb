"""Weights of the reference's models, as state dicts of the port's.

The MNIST models (``mlp_params_from_jax``, ``cnn_params_from_jax``): Flax
``Dense`` kernels are ``(in, out)`` with a bias, ``nn.Linear`` holds
``(out, in)``; Flax ``Conv`` kernels are HWIO, ``nn.Conv2d`` holds OIHW.  The
port's CNN flattens channels-last, as the reference does, so its first dense
kernel is a plain transpose too.

The LM (``params_from_jax``): the reference keeps flax ``DenseGeneral`` kernels: ``(in, heads, dim)`` for
the q/k/v projections, ``(heads, dim, out)`` for ``out_proj`` and
``(in, out)`` for the MLP and the lm_head, none with a bias.  The port's
dense layers hold PyTorch's ``(out, in)``.  A quantized model's int8
kernels take the same reshapes and transposes (and stay int8), each
``scale`` flattened with its features; a LoRA model's ``lora_a``
``(in..., rank)`` becomes ``(rank, in)`` and ``lora_b`` ``(rank, out...)``
becomes ``(out, rank)``.  The way back, for the adapter, is
``models.lora.adapter_leaves`` (the reference's leaf list).  Block parameters come either
stacked on a leading layer axis under ``layers`` (``scan_layers=True``) or
unrolled as ``layer_{i}`` (``scan_layers=False``); both convert.  An MoE
block's ``moe`` holds the router's ``(in, experts)`` kernel and ``wi``/``wo``
stacked per expert, which the port keeps in the reference's layout.  A
``pipe`` rank takes its stage's slice of the layers (``stage=``), numbered
from 0 as that rank's model holds them.

A gang starts from the same weights: :func:`place_on_mesh` copies the full
converted tensors into a model already sharded over a mesh (each rank keeps
its shard, ``distribute_tensor`` with the parameter's own placements).

The input is nested dicts of numpy arrays (``jax.tree.map(np.asarray, ...)``
of unboxed params), so this module needs no JAX.  Float32 leaves become
``config.param_dtype`` (RMSNorm scales stay float32); bfloat16 leaves, as in
the reference's ``inference_params`` tree, stay bfloat16, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .transformer import TransformerConfig


def _kernel(tree: dict, name: str) -> np.ndarray:
    layer = tree[name]
    if set(layer) != {"kernel"}:
        raise ValueError(
            f"{name}: only plain float dense layers convert, got keys {sorted(layer)}"
        )
    return np.asarray(layer["kernel"])


def _dense(layer: dict, prefix: str, n_in: int, n_out: int) -> dict:
    """One ``DenseGeneral`` (float or int8 ``kernel``, its ``scale``, the
    ``lora_a``/``lora_b`` adapter) flattened to ``n_in`` inputs and
    ``n_out`` outputs, in the port's ``(out, in)`` layout: the kernel and
    ``lora_a`` transposed, the scale flat, ``lora_b`` as ``(out, rank)``."""
    keys = set(layer)
    if keys - {"scale", "lora_a", "lora_b"} != {"kernel"} or \
            ("lora_a" in keys) != ("lora_b" in keys):
        raise ValueError(f"{prefix}: only plain float dense layers, their int8 form and "
                         f"their LoRA form convert, got keys {sorted(layer)}")
    state = {f"{prefix}.weight": np.asarray(layer["kernel"]).reshape(n_in, n_out).T}
    if "scale" in layer:
        state[f"{prefix}.scale"] = np.asarray(layer["scale"]).reshape(n_out)
    if "lora_a" in layer:
        rank = np.shape(layer["lora_a"])[-1]
        state[f"{prefix}.lora_a"] = np.asarray(layer["lora_a"]).reshape(n_in, rank).T
        state[f"{prefix}.lora_b"] = np.asarray(layer["lora_b"]).reshape(rank, n_out).T
    return state


def _block(tree: dict, cfg: TransformerConfig, prefix: str) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    kv = cfg.n_kv_heads or cfg.n_heads
    attn = tree["attention"]
    state = {f"{prefix}.ln_attn.scale": tree["ln_attn"]["scale"],
             f"{prefix}.ln_mlp.scale": tree["ln_mlp"]["scale"]}
    for name, n_in, n_out in (("q_proj", d, cfg.n_heads * hd), ("k_proj", d, kv * hd),
                              ("v_proj", d, kv * hd), ("out_proj", cfg.n_heads * hd, d)):
        state.update(_dense(attn[name], f"{prefix}.attention.{name}", n_in, n_out))
    if "moe" in tree:
        moe = tree["moe"]
        state.update({f"{prefix}.mlp.router": _kernel(moe, "router").T,
                      f"{prefix}.mlp.wi": moe["wi"], f"{prefix}.mlp.wo": moe["wo"]})
    else:
        state.update(_dense(tree["mlp"]["wi"], f"{prefix}.mlp.wi", d, cfg.d_ff))
        state.update(_dense(tree["mlp"]["wo"], f"{prefix}.mlp.wo", cfg.d_ff, d))
    return state


def params_from_jax(params: dict, config: TransformerConfig,
                    stage: tuple[int, int] | None = None) -> dict[str, torch.Tensor]:
    """State dict for :class:`TransformerLM` from the reference's params;
    with ``stage=(index, count)``, for the rank of pipeline stage ``index``
    of ``count``: its layers only."""
    if "layers" in params:
        stacked = params["layers"]
        depth = {np.shape(a)[0] for a in _leaves(stacked)}
        if depth != {config.n_layers}:
            raise ValueError(f"stacked layers have depth {depth}, config says {config.n_layers}")
        blocks = [_index(stacked, i) for i in range(config.n_layers)]
    else:
        blocks = [params[f"layer_{i}"] for i in range(config.n_layers)]
        if f"layer_{config.n_layers}" in params:
            raise ValueError(f"params hold more than {config.n_layers} layers")
    if stage is not None:
        from ..parallel.pipeline import pipeline_stages

        blocks = pipeline_stages(blocks, stage[1])[stage[0]]
    state = {
        "embedding": params["embedding"],
        "ln_final.scale": params["ln_final"]["scale"],
        **_dense(params["lm_head"], "lm_head", config.d_model, config.vocab_size),
    }
    for i, block in enumerate(blocks):
        state.update(_block(block, config, f"layers.{i}"))
    return {name: _tensor(name, value, config) for name, value in state.items()}


def _tensor(name: str, value, config: TransformerConfig) -> torch.Tensor:
    array = np.array(value, order="C")
    if array.dtype == np.int8:  # a quantized kernel stays int8
        return torch.from_numpy(array)
    if array.dtype.name == "bfloat16":
        # numpy knows bfloat16 only through JAX's ml_dtypes, and torch does
        # not take it: reinterpret the 16 bits instead.
        return torch.from_numpy(array.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(array).to(
        torch.float32 if name.endswith(".scale") else config.param_dtype
    )


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    else:
        yield tree


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {key: _index(value, i) for key, value in tree.items()}
    return np.asarray(tree)[i]


def _linear(layer: dict, prefix: str) -> dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _f32(np.asarray(layer["kernel"]).T),
            f"{prefix}.bias": _f32(layer["bias"])}


def _f32(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32, order="C"))


def mlp_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """State dict for :class:`..models.mlp.MLP` from the reference MLP's
    params (``Dense_0`` .. ``Dense_n``, the last one the logits)."""
    names = sorted((k for k in params if k.startswith("Dense_")), key=lambda k: int(k[6:]))
    if len(names) != len(params) or not names:
        raise ValueError(f"expected only Dense_i layers, got {sorted(params)}")
    state = {}
    for i, name in enumerate(names[:-1]):
        state.update(_linear(params[name], f"hidden.{i}"))
    state.update(_linear(params[names[-1]], "head"))
    return state


def cnn_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """State dict for :class:`..models.mlp.MnistCNN` from the reference
    CNN's params (``Conv_0``, ``Conv_1``, ``Dense_0``, ``Dense_1``)."""
    state = {}
    for i in range(2):
        conv = params[f"Conv_{i}"]
        state[f"conv{i + 1}.weight"] = _f32(np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))
        state[f"conv{i + 1}.bias"] = _f32(conv["bias"])
    state.update(_linear(params["Dense_0"], "fc"))
    state.update(_linear(params["Dense_1"], "head"))
    return state


def place_on_mesh(model: torch.nn.Module, state: dict[str, torch.Tensor]) -> torch.nn.Module:
    """Load a full state dict (``params_from_jax``'s, say) into ``model``
    after it was sharded (``parallel.sharding.apply_rules``, or a config with
    ``mesh`` set): every DTensor parameter takes its shard of the full
    tensor, by ``distribute_tensor`` on the parameter's mesh and placements;
    a plain one takes the whole.  Every rank calls it with the same
    ``state``.  Returns ``model``."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    params = dict(model.named_parameters())
    if set(params) != set(state):
        raise ValueError(f"state dict keys differ from the model's: missing "
                         f"{sorted(set(params) - set(state))}, unexpected "
                         f"{sorted(set(state) - set(params))}")
    with torch.no_grad():
        for name, param in params.items():
            full = state[name]
            if tuple(full.shape) != tuple(param.shape):
                raise ValueError(f"{name}: shape {tuple(full.shape)} != {tuple(param.shape)}")
            if isinstance(param, DTensor):
                local = param.to_local()
                full = full.to(device=local.device, dtype=param.dtype)
                param.copy_(distribute_tensor(full, param.device_mesh, param.placements))
            else:
                param.copy_(full)
    return model
