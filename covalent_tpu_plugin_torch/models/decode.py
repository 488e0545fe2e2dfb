"""Autoregressive generation with a per-layer KV cache.

Counterpart of ``covalent_tpu_plugin/models/decode.py``.  One batched
prefill pass (or several, with ``prefill_chunk``) pushes the prompt's K/V
into each layer's cache, then each decode step appends one token at the
cache cursor and attends the cached prefix.  The reference runs the loop as
one compiled ``lax.while_loop``; here it is an eager Python loop over the
same steps, with the same early exit once every row has emitted EOS.
``generate`` turns the model's batch-invariant route on
(``transformer.use_batch_invariant``), as every serving entry point does.

Sampling draws from an explicit ``torch.Generator``; the reference's
``jax.random`` streams cannot be reproduced, so the two agree on greedy
tokens and on the filters (as functions of the logits), not on sampled
tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.attention import NEG_INF
from .transformer import LayerCache, TransformerLM, use_batch_invariant


def init_cache(model: TransformerLM, batch_size: int) -> list[LayerCache]:
    """Zeroed KV cache, one :class:`LayerCache` per layer, on the model's
    device: ``max_seq`` slots, or ``sliding_window + attention_sinks`` for a
    rolling cache (whose empty slots hold position -1); int8 K/V with f32
    scales for ``quantized_kv_cache``."""
    cfg = model.config
    kv_heads = cfg.n_kv_heads or cfg.n_heads
    cache_len = (
        cfg.sliding_window + cfg.attention_sinks if cfg.rolling_cache else cfg.max_seq
    )
    device = model.embedding.device
    kv_dtype = torch.int8 if cfg.quantized_kv_cache else cfg.dtype
    shape = (batch_size, cache_len, kv_heads, cfg.head_dim)

    def layer() -> LayerCache:
        cache = LayerCache(
            k=torch.zeros(shape, dtype=kv_dtype, device=device),
            v=torch.zeros(shape, dtype=kv_dtype, device=device),
            cursor=torch.zeros(batch_size, dtype=torch.long, device=device),
        )
        if cfg.quantized_kv_cache:
            cache.k_scale = torch.zeros(shape[:3] + (1,), dtype=torch.float32, device=device)
            cache.v_scale = torch.zeros(shape[:3] + (1,), dtype=torch.float32, device=device)
        if cfg.rolling_cache:
            cache.slot_pos = torch.full(
                (batch_size, cache_len), -1, dtype=torch.long, device=device
            )
        return cache

    return [layer() for _ in range(cfg.n_layers)]


def set_cursor(cache: list[LayerCache], cursor, bound: int) -> None:
    """Set every layer's cursor to ``cursor`` (an int, or a (B,) tensor of
    per-row positions) whose largest value is at most ``bound``."""
    for layer in cache:
        if isinstance(cursor, torch.Tensor):
            layer.cursor.copy_(cursor)
        else:
            layer.cursor.fill_(int(cursor))
        layer.bound = int(bound)


def inference_params(model: TransformerLM) -> TransformerLM:
    """Cast every float32 parameter to bfloat16, RMSNorm scales included, in
    place, for serving (the reference's ``inference_params`` casts every f32
    leaf).  Decode re-reads the whole weight set every step, so halving its
    bytes is a direct speedup.  Returns ``model``."""
    for param in model.parameters():
        if param.dtype == torch.float32:
            param.data = param.data.to(torch.bfloat16)
    return model


def _filter_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Mask all but the ``top_k`` largest logits per row to NEG_INF (every
    logit tied with the k-th largest survives)."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def _filter_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    """Keep tokens whose probability is at least ``min_p`` times the most
    likely token's."""
    logprobs = torch.log_softmax(logits, dim=-1)
    floor = logprobs.amax(dim=-1, keepdim=True) + float(np.log(min_p))
    return torch.where(logprobs < floor, NEG_INF, logits)


def _apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                              penalty: float) -> torch.Tensor:
    """CTRL-style penalty over ``seen`` ((B, L), -1 padding): logits of
    tokens already emitted divide by ``penalty`` when positive and multiply
    when negative."""
    batch, vocab = logits.shape
    safe = torch.where(seen >= 0, seen, vocab)  # -1 pads -> overflow column
    appeared = torch.zeros((batch, vocab + 1), dtype=torch.bool, device=logits.device)
    appeared.scatter_(1, safe, True)
    penalised = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(appeared[:, :vocab], penalised, logits)


def _filter_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the sorted distribution
    whose mass reaches ``top_p``.  It thresholds by logit value, so every
    token tied with the cutoff logit survives (the reference's choice)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    cutoff = (mass_before < top_p).sum(dim=-1, keepdim=True)
    threshold = sorted_logits.gather(-1, (cutoff - 1).clamp_min(0))
    return torch.where(logits < threshold, NEG_INF, logits)


def _categorical(scaled: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(``scaled``), by the Gumbel-max trick on
    uniforms from ``generator`` (drawn on the generator's device)."""
    u = torch.rand(scaled.shape, generator=generator, device=generator.device)
    gumbel = -torch.log(-torch.log(u.to(scaled.device)))
    return torch.argmax(scaled + gumbel, dim=-1)


@torch.no_grad()
def generate(
    model: TransformerLM,
    prompt,
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    top_k: int | None = None,
    top_p: float | None = None,
    eos_token_id: int | None = None,
    pad_token_id: int | None = None,
    prefill_chunk: int | None = None,
    min_p: float | None = None,
    repetition_penalty: float | None = None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` ((B, P)
    integer array or tensor); returns the (B, P+N) token buffer (int64) on
    the model's device.

    ``temperature=0`` is greedy argmax; otherwise sampling at that
    temperature from ``generator``, optionally restricted by ``top_k``, the
    ``top_p`` nucleus and the ``min_p`` floor (in that order).
    ``repetition_penalty`` applies first, for greedy and sampling alike.
    ``eos_token_id`` stops a row once it emits EOS; its later slots hold
    ``pad_token_id`` (default: the EOS id) and the loop ends once every row
    is done.  ``prefill_chunk`` streams the prompt into the cache in slabs.
    With ``rolling_cache`` a prompt past the ring's capacity streams in
    chunks of at most ``sliding_window`` tokens (the default then).
    """
    config = model.config
    device = model.embedding.device
    use_batch_invariant(model)
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.as_tensor(np.asarray(prompt))
    prompt = prompt.to(device=device, dtype=torch.long)
    batch, prompt_len = prompt.shape
    total = prompt_len + max(max_new_tokens, 0)
    if config.rolling_cache:
        capacity = config.sliding_window + config.attention_sinks
        if prompt_len > capacity:
            if prefill_chunk is None:
                prefill_chunk = config.sliding_window
            if prefill_chunk > config.sliding_window:
                raise ValueError(
                    f"rolling_cache prefill chunks of {prefill_chunk} "
                    f"exceed sliding_window ({config.sliding_window}): "
                    "two slab tokens would scatter into the same ring "
                    "slot; use prefill_chunk <= sliding_window"
                )
    elif total > config.max_seq:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds config.max_seq ({config.max_seq})"
        )
    if temperature <= 0 and (top_k is not None or top_p is not None or min_p is not None):
        raise ValueError("top_k/top_p/min_p require sampling (temperature > 0)")
    if top_k is not None and not 1 <= top_k <= config.vocab_size:
        raise ValueError(f"top_k must be in [1, {config.vocab_size}], got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if min_p is not None and not 0.0 < min_p <= 1.0:
        raise ValueError(f"min_p must be in (0, 1], got {min_p}")
    if repetition_penalty is not None and repetition_penalty <= 0:
        raise ValueError(f"repetition_penalty must be > 0, got {repetition_penalty}")
    if pad_token_id is not None and eos_token_id is None:
        raise ValueError("pad_token_id requires eos_token_id")
    if prefill_chunk is not None and prefill_chunk < 1:
        raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
    if max_new_tokens <= 0:
        return prompt
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a generator")

    cache = init_cache(model, batch)
    buffer = torch.zeros((batch, total), dtype=torch.long, device=device)
    buffer[:, :prompt_len] = prompt
    cols = torch.arange(total, device=device)[None, :]

    def choose(step_logits: torch.Tensor, written: int) -> torch.Tensor:
        step_logits = step_logits.float()
        if repetition_penalty is not None:
            # unwritten slots hold 0: mask them so token 0 counts only once seen
            seen = torch.where(cols < written, buffer, -1)
            step_logits = _apply_repetition_penalty(step_logits, seen, repetition_penalty)
        if temperature > 0:
            scaled = step_logits / temperature
            if top_k is not None:
                scaled = _filter_top_k(scaled, top_k)
            if top_p is not None:
                scaled = _filter_top_p(scaled, top_p)
            if min_p is not None:
                scaled = _filter_min_p(scaled, min_p)
            return _categorical(scaled, generator)
        return torch.argmax(step_logits, dim=-1)

    pad = eos_token_id if pad_token_id is None else pad_token_id
    done = torch.zeros(batch, dtype=torch.bool, device=device)

    def finish(chosen: torch.Tensor, done: torch.Tensor):
        if eos_token_id is None:
            return chosen, done
        chosen = torch.where(done, pad, chosen)
        return chosen, done | (chosen == eos_token_id)

    if prefill_chunk is None or prefill_chunk >= prompt_len:
        chunks = [prompt]
    else:
        chunks = [prompt[:, s:s + prefill_chunk] for s in range(0, prompt_len, prefill_chunk)]
    for slab in chunks:
        logits = model(slab, cache=cache)
    chosen, done = finish(choose(logits[:, -1], prompt_len), done)
    buffer[:, prompt_len] = chosen

    t = prompt_len
    while t < total - 1 and not (eos_token_id is not None and bool(done.all())):
        logits = model(buffer[:, t:t + 1], cache=cache)
        chosen, done = finish(choose(logits[:, 0], t + 1), done)
        buffer[:, t + 1] = chosen
        t += 1
    if eos_token_id is not None:
        # an early exit leaves the columns past t unwritten
        buffer[:, t + 1:] = pad
    return buffer
