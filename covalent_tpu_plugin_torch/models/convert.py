"""Weights of the reference LM, as a state dict of the port's LM.

The reference keeps flax ``DenseGeneral`` kernels: ``(in, heads, dim)`` for
the q/k/v projections, ``(heads, dim, out)`` for ``out_proj`` and
``(in, out)`` for the MLP and the lm_head, none with a bias.  The port's
dense layers hold PyTorch's ``(out, in)``.  Block parameters come either
stacked on a leading layer axis under ``layers`` (``scan_layers=True``) or
unrolled as ``layer_{i}`` (``scan_layers=False``); both convert.

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


def _block(tree: dict, cfg: TransformerConfig, prefix: str) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    kv = cfg.n_kv_heads or cfg.n_heads
    attn, mlp = tree["attention"], tree["mlp"]
    return {
        f"{prefix}.ln_attn.scale": tree["ln_attn"]["scale"],
        f"{prefix}.attention.q_proj.weight":
            _kernel(attn, "q_proj").reshape(d, cfg.n_heads * hd).T,
        f"{prefix}.attention.k_proj.weight": _kernel(attn, "k_proj").reshape(d, kv * hd).T,
        f"{prefix}.attention.v_proj.weight": _kernel(attn, "v_proj").reshape(d, kv * hd).T,
        f"{prefix}.attention.out_proj.weight":
            _kernel(attn, "out_proj").reshape(cfg.n_heads * hd, d).T,
        f"{prefix}.ln_mlp.scale": tree["ln_mlp"]["scale"],
        f"{prefix}.mlp.wi.weight": _kernel(mlp, "wi").T,
        f"{prefix}.mlp.wo.weight": _kernel(mlp, "wo").T,
    }


def params_from_jax(params: dict, config: TransformerConfig) -> dict[str, torch.Tensor]:
    """State dict for :class:`TransformerLM` from the reference's params."""
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
    state = {
        "embedding": params["embedding"],
        "ln_final.scale": params["ln_final"]["scale"],
        "lm_head.weight": _kernel(params, "lm_head").T,
    }
    for i, block in enumerate(blocks):
        state.update(_block(block, config, f"layers.{i}"))
    return {name: _tensor(name, value, config) for name, value in state.items()}


def _tensor(name: str, value, config: TransformerConfig) -> torch.Tensor:
    array = np.array(value, order="C")
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
