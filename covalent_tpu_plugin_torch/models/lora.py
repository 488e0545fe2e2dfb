"""LoRA / QLoRA over the transformer's dense layers.

Counterpart of ``covalent_tpu_plugin/models/lora.py``.  Each targeted dense
learns a rank-``r`` update ``y += (x @ A) @ B * (alpha / r)`` while its base
weight stays frozen.  ``B`` starts at zero, so an adapted model is exactly
the base model at step 0.  With a quantized base (:func:`quantize_then_lora`)
the frozen weight is the int8 form of ``models/quant.py``: QLoRA.

The port's layout is PyTorch's: ``lora_a`` ``(rank, in)`` and ``lora_b``
``(out, rank)`` beside the base ``weight`` ``(out, in)`` of the same
:class:`LoRADense`.  The adapter's **wire form** is the reference's:
:func:`adapter_leaves` returns the ``lora_a``/``lora_b`` leaves of the
reference's Flax tree, in its key-sorted flatten order (``layer_10`` before
``layer_2``; in a block ``attention``'s ``k_proj, out_proj, q_proj, v_proj``
before ``mlp``'s ``wi, wo``; each ``lora_a`` before its ``lora_b``), in its
``DenseGeneral`` shapes (q_proj's ``lora_b`` ``(rank, heads, head_dim)``,
out_proj's ``lora_a`` ``(heads, head_dim, rank)``) as f32 numpy arrays.  So
an adapter digest (:func:`adapter_digest`) and a registry bundle
(``serving/registry.py``) mean the same thing on both sides, and a bundle the
JAX package packs installs into this package's engine
(:func:`adapter_state` reads the wire form back).

Training: the base parameters are frozen (``requires_grad=False``) and
AdamW (``models/train.py``'s, ``optax.adamw``'s defaults) moves only the
adapter leaves::

    lmodel = add_lora(model, rank=16)          # or quantize_then_lora(...)
    optimizer = make_lora_train_state(lmodel)
    step = make_lora_train_step(lmodel, optimizer)
    step(batch)                                # {"loss", "grad_norm", "step"}
    merged = merge_lora(lmodel)                # a plain model again

On the serving route (``transformer.use_batch_invariant``) the adapter's two
products take ``ops.batch_invariant.linear_rows``; a serving engine with an
adapter bank (``models/serve.py``) sets :attr:`LoRADense.bank` and each
row's slot in it, and every row then gathers its own ``A``/``B``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch
from torch import nn

from ..ops import batch_invariant as bi

ADAPTER_KEYS = ("lora_a", "lora_b")


class LoRADense(nn.Module):
    """A dense layer (float or int8 base) with a trainable low-rank bypass:
    the reference's ``LoRADenseGeneral`` (``lora.py:51-128``).  The base
    parameters keep the names of ``transformer.Dense`` /
    ``quant.QuantDense``, so a base checkpoint fills them as it is.

    ``bank`` (set by a serving engine): ``(A, B)`` stacked over bank slots,
    ``(n, rank, in)`` and ``(n, out, rank)`` in ``dtype``, and ``rows`` the
    (B,) bank slot of each row of the next forward; the module's own
    ``lora_a``/``lora_b`` are then unused."""

    batch_invariant = False

    def __init__(self, in_features: int, out_features: int, dtype, param_dtype, std: float,
                 device, generator, *, rank: int, alpha: float = 16.0,
                 quantized: bool = False):
        super().__init__()
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.dtype, self.rank, self.alpha, self.quantized = dtype, rank, float(alpha), quantized
        if quantized:
            self.weight = nn.Parameter(
                torch.zeros(out_features, in_features, dtype=torch.int8, device=device),
                requires_grad=False)
            self.scale = nn.Parameter(torch.ones(out_features, dtype=param_dtype, device=device),
                                      requires_grad=False)
        else:
            self.weight = nn.Parameter(
                torch.empty(out_features, in_features, dtype=param_dtype, device=device))
            nn.init.normal_(self.weight, 0.0, std, generator=generator)
        self.lora_a = nn.Parameter(torch.empty(rank, in_features, dtype=param_dtype, device=device))
        nn.init.normal_(self.lora_a, 0.0, 1.0 / rank, generator=generator)
        self.lora_b = nn.Parameter(torch.zeros(out_features, rank, dtype=param_dtype, device=device))
        self.bank: tuple[torch.Tensor, torch.Tensor] | None = None
        self.rows: torch.Tensor | None = None

    def base(self, x):
        if self.quantized:
            return bi.linear_w8(x, self.weight, self.scale, self.dtype)
        linear = bi.linear if self.batch_invariant else bi.linear_plain
        return linear(x, self.weight, self.dtype)

    def forward(self, x):
        y = self.base(x)
        # alpha / rank rounded to dtype first, as the reference's weakly
        # typed scalar is
        scaling = torch.tensor(self.alpha / self.rank, dtype=y.dtype)
        if self.bank is None and not self.batch_invariant:
            h = bi.linear_plain(x, self.lora_a, self.dtype)
            return y + bi.linear_plain(h, self.lora_b, self.dtype) * scaling
        if self.bank is None:
            a, b = self.lora_a[None], self.lora_b[None]
        else:
            if self.rows is None or self.rows.shape[0] != x.shape[0]:
                raise ValueError("an adapter bank needs the bank slot of each row")
            a, b = self.bank[0].index_select(0, self.rows), self.bank[1].index_select(0, self.rows)
        rows = bi.linear_rows if self.batch_invariant else bi.linear_rows_plain
        flat = x.reshape(x.shape[0], -1, x.shape[-1])
        u = rows(rows(flat, a, self.dtype), b, self.dtype)
        return y + (u * scaling).reshape(y.shape)


def _lora_modules(model) -> dict[str, LoRADense]:
    return {name: m for name, m in model.named_modules() if isinstance(m, LoRADense)}


def add_lora(model, rank: int, alpha: float = 16.0, generator: torch.Generator | None = None):
    """The adapted twin of a trained LM (``lora.py:131``): its config's
    ``lora_rank``/``lora_alpha`` set, the base parameters taken from
    ``model`` as they are (shared, not copied), fresh adapters: ``A`` normal
    over ``rank`` from ``generator`` (seed 0 on the model's device by
    default), ``B`` zero, so the twin computes what ``model`` computes.
    A quantized ``model`` gives QLoRA."""
    from .transformer import TransformerLM

    config = model.config
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    if config.lora_rank:
        raise ValueError("the model carries adapters already")
    device = model.embedding.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    lmodel = TransformerLM(dataclasses.replace(config, lora_rank=rank, lora_alpha=float(alpha)),
                           device=torch.device("meta"))
    state = dict(model.state_dict())
    for name, module in _lora_modules(lmodel).items():
        out_f, in_f = module.weight.shape
        a = torch.randn(rank, in_f, generator=generator, device=device, dtype=torch.float32)
        state[f"{name}.lora_a"] = (a / rank).to(config.param_dtype)
        state[f"{name}.lora_b"] = torch.zeros(out_f, rank, dtype=config.param_dtype, device=device)
    lmodel.load_state_dict(state, assign=True)
    return lmodel


def quantize_then_lora(model, rank: int, alpha: float = 16.0,
                       generator: torch.Generator | None = None):
    """QLoRA in one call: int8-freeze the base, then attach adapters
    (``lora.py:309``)."""
    from .quant import quantize_lm

    return add_lora(quantize_lm(model), rank=rank, alpha=alpha, generator=generator)


def lora_mask(model) -> dict[str, bool]:
    """Parameter name -> True on adapter leaves (``lora.py:188``)."""
    return {name: name.rsplit(".", 1)[-1] in ADAPTER_KEYS for name, _ in model.named_parameters()}


def adapter_parameters(model) -> list[nn.Parameter]:
    """The adapter leaves, in the module's order."""
    mask = lora_mask(model)
    params = [p for name, p in model.named_parameters() if mask[name]]
    if not params:
        raise ValueError("the model has no lora_a/lora_b leaves (not a LoRA model)")
    return params


def _flax_site(config, name: str) -> tuple[tuple, tuple, tuple]:
    """``(path, in_shape, out_shape)`` of the port's dense ``name`` in the
    reference's tree: its Flax path and its ``DenseGeneral`` input and
    output dims."""
    d, hd, kv = config.d_model, config.head_dim, config.n_kv_heads or config.n_heads
    if name == "lm_head":
        return ("lm_head",), (d,), (config.vocab_size,)
    _, i, block, dense = name.split(".")
    shapes = {
        "q_proj": ((d,), (config.n_heads, hd)), "k_proj": ((d,), (kv, hd)),
        "v_proj": ((d,), (kv, hd)), "out_proj": ((config.n_heads, hd), (d,)),
        "wi": ((d,), (config.d_ff,)), "wo": ((config.d_ff,), (d,)),
    }[dense]
    return (f"layer_{i}", block, dense), *shapes


def _wire_sites(model) -> list[tuple[tuple, str, LoRADense, tuple, tuple]]:
    """Each adapter leaf's ``(flax path, key, module, in_shape,
    out_shape)``, in the reference's flatten order."""
    sites = []
    for name, module in _lora_modules(model).items():
        path, in_shape, out_shape = _flax_site(model.config, name)
        sites += [(path + (key,), key, module, in_shape, out_shape) for key in ADAPTER_KEYS]
    return sorted(sites, key=lambda site: site[0])


def _wire_shape(key: str, module: LoRADense, in_shape: tuple, out_shape: tuple) -> tuple:
    return in_shape + (module.rank,) if key == "lora_a" else (module.rank,) + out_shape


def adapter_shapes(model) -> list[tuple]:
    """The shapes of the wire form's leaves, in its order (no values read:
    a model on the meta device answers too)."""
    return [_wire_shape(key, module, i, o) for _, key, module, i, o in _wire_sites(model)]


def adapter_leaves(model) -> list[np.ndarray]:
    """The adapter's wire form: the reference's ordered ``lora_a``/``lora_b``
    leaves (``lora.py:202``), in its layout and shapes, as f32 numpy
    arrays."""
    leaves = []
    for _, key, module, in_shape, out_shape in _wire_sites(model):
        t = getattr(module, key).detach().float().cpu().t().contiguous().numpy()
        leaves.append(t.reshape(_wire_shape(key, module, in_shape, out_shape)))
    if not leaves:
        raise ValueError("the model has no lora_a/lora_b leaves (not a LoRA model)")
    return leaves


def adapter_state(model, leaves) -> dict[str, torch.Tensor]:
    """The inverse of :func:`adapter_leaves`: ``{parameter name: tensor}``
    (CPU, f32, the port's layout) from a wire-form leaf list.  Raises
    :class:`ValueError` when the count or a shape does not match the
    model's adapters (another rank or geometry)."""
    leaves = list(leaves)
    sites = _wire_sites(model)
    if len(leaves) != len(sites):
        raise ValueError(f"the adapter has {len(leaves)} leaves; this model's template has "
                         f"{len(sites)}")
    names = {id(m): n for n, m in _lora_modules(model).items()}
    state = {}
    for leaf, (_, key, module, in_shape, out_shape) in zip(leaves, sites):
        arr = np.asarray(leaf, dtype=np.float32)
        want = _wire_shape(key, module, in_shape, out_shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"adapter leaf {tuple(arr.shape)} does not match the template "
                             f"{want} (rank or geometry mismatch)")
        flat = arr.reshape(-1, module.rank) if key == "lora_a" else arr.reshape(module.rank, -1)
        state[f"{names[id(module)]}.{key}"] = torch.from_numpy(np.ascontiguousarray(flat.T))
    return state


def load_adapter(model, leaves):
    """Copy a wire-form adapter into ``model``'s adapter leaves; returns
    ``model``."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, value in adapter_state(model, leaves).items():
            params[name].copy_(value)
    return model


def adapter_digest(leaves) -> str:
    """Content digest of an adapter's ordered leaf list (``lora.py:225``):
    sha256 over each leaf's shape, dtype and bytes.  One implementation
    serves both sides: the registry's numpy-only
    :func:`~..serving.registry.adapter_content_digest`, which the
    dispatcher runs without torch."""
    from ..serving.registry import adapter_content_digest

    return adapter_content_digest(leaves)


def lora_optimizer(model, lr: float = 3e-4, weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """AdamW over the adapter leaves only (``lora.py:240``), with
    ``optax.adamw``'s defaults: the base takes no step whatever its
    gradients."""
    return torch.optim.AdamW(adapter_parameters(model), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def merge_lora(model):
    """Fold the adapters into plain dense weights (``lora.py:259``):
    ``weight += (B @ A) * alpha / r`` in f32, cast back to the weight's
    type; returns the plain model (``lora_rank=0``).  Refuses a quantized
    base: folding a float update into int8 would requantize."""
    from .transformer import TransformerLM

    config = model.config
    if config.quantized:
        raise ValueError("merge_lora requires a float base (quantized=False)")
    if not config.lora_rank:
        raise ValueError("model has no adapters (lora_rank=0)")
    scaling = config.lora_alpha / config.lora_rank
    plain = TransformerLM(dataclasses.replace(config, lora_rank=0, lora_alpha=16.0),
                          device=torch.device("meta"))
    state = {}
    with torch.no_grad():
        for name, tensor in model.state_dict().items():
            prefix, _, key = name.rpartition(".")
            if key in ADAPTER_KEYS:
                continue
            module = model.get_submodule(prefix) if prefix else None
            if isinstance(module, LoRADense) and key == "weight":
                update = module.lora_b.float() @ module.lora_a.float()
                tensor = (tensor.float() + update * scaling).to(tensor.dtype)
            state[name] = tensor
    plain.load_state_dict(state, assign=True)
    return plain


def make_lora_train_state(model, lr: float = 3e-4,
                          weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """Freeze every base parameter (``requires_grad=False``) and return the
    optimizer of the adapters (``lora.py:324-403``: the reference splits
    the tree into adapters and frozen leaves because ``jax.grad`` refuses
    int8 inputs; here the frozen leaves simply take no gradient)."""
    mask = lora_mask(model)
    for name, param in model.named_parameters():
        param.requires_grad_(mask[name])
    return lora_optimizer(model, lr=lr, weight_decay=weight_decay)


def make_lora_train_step(model, optimizer, loss_fn=None):
    """``step(batch) -> {"loss", "grad_norm", "step"}`` moving only the
    adapters: ``models.train.make_train_step`` over the frozen model (float
    or int8 base alike)."""
    from .train import lm_loss, make_train_step

    return make_train_step(model, optimizer, loss_fn=loss_fn or lm_loss)


def train_lora(steps: int = 3, batch_size: int = 8, seq_len: int = 1024, rank: int = 16,
               alpha: float = 16.0, quantized: bool = False, seed: int = 0,
               adapter_seed: int = 1, device=None, **config_overrides) -> dict:
    """A LoRA fine-tune electron: the LM of ``lm_125m_config(**overrides)``
    with weights from a generator seeded with ``seed``, adapters of
    ``rank`` on the default targets (on the int8 base with ``quantized``:
    QLoRA), ``steps`` AdamW steps on the synthetic stream.  Returns the
    losses, each step's seconds, the flash and serving kernels' launches
    during the steps, whether every base parameter is bit-unchanged and every adapter
    leaf moved, the adapter's wire form and its digest."""
    from ..ops import _kernels
    from .data import synthetic_lm_batches
    from .quant import quantize_lm
    from .transformer import TransformerLM, lm_125m_config, resolve_device

    device = resolve_device(device)
    config = lm_125m_config(**config_overrides)
    base = TransformerLM(config, device=device,
                         generator=torch.Generator(device=device).manual_seed(seed))
    if quantized:
        base = quantize_lm(base)
    model = add_lora(base, rank=rank, alpha=alpha,
                     generator=torch.Generator(device=device).manual_seed(adapter_seed))
    optimizer = make_lora_train_state(model)
    step = make_lora_train_step(model, optimizer)
    mask = lora_mask(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batches = synthetic_lm_batches(steps=steps, batch_size=batch_size, seq_len=seq_len + 1,
                                   vocab_size=config.vocab_size, seed=seed)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    launched = _kernels.launch_counts()
    served = _kernels.serving_launch_counts()
    losses, step_s = [], []
    for batch in batches:
        sync()
        start = time.perf_counter()
        losses.append(float(step(batch)["loss"]))
        sync()
        step_s.append(time.perf_counter() - start)
    after = dict(model.named_parameters())
    base_unchanged = all(torch.equal(before[n], after[n]) for n in before if not mask[n])
    moved = [not torch.equal(before[n], after[n]) for n in before if mask[n]]
    leaves = adapter_leaves(model)
    return {
        "losses": losses, "step_s": step_s, "median_step_s": statistics.median(step_s),
        "launches": {k: v - launched[k] for k, v in _kernels.launch_counts().items()},
        # the int8 base's products (QLoRA) take the int8-weight kernel
        "serving_launches": {k: v - served[k]
                             for k, v in _kernels.serving_launch_counts().items()},
        "base_unchanged": base_unchanged, "adapter_leaves_moved": sum(moved),
        "adapter_leaves_total": len(moved), "quantized": quantized, "rank": rank,
        "alpha": alpha, "leaves": leaves, "digest": adapter_digest(leaves),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
