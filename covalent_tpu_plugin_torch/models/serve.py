"""Continuous batching: a fixed-slot serving loop with rolling admission.

Counterpart of ``covalent_tpu_plugin/models/serve.py``.  ``max_batch``
slots share one batched KV cache (one :class:`LayerCache` per layer with a
row per slot and a cursor per row) and one (B, L) token buffer.  Finished
slots keep stepping on frozen tokens (their logits are ignored) until a
request takes the slot.  The reference instead vmaps a batch-1 cache lane
per slot; here each row's K/V are written at the row's own position by
index.  Before every step the cursors are set to the rows' positions, so a
frozen row rewrites its own slot and never runs past the cache.

* **Sync chunks.**  A chunk is ``sync_steps`` decode steps run eagerly on
  the device; the host reads the (B,) ``done`` vector only at chunk ends,
  where it harvests finished rows and admits queued requests.
* **Bucketed batched prefill** (``prefill="batched"``, the default).  An
  admission wave prefills its prompts in one pass padded to a power-of-two
  bucket: pad K/V land past each prompt's end, the cursor is parked at the
  prompt's length, and the causal mask hides a slot from every query until
  the decode loop has overwritten it.  ``prefill="stream"`` replays the
  prompt through the step loop one token per step instead.
* **Sampling** draws the first token of each request from its own key, split
  off an admission chain in admission order (seeded from the generator's
  seed), and every later token from the loop's ``generator``.  Greedy
  outputs are identical across prefill modes; sampled ones are not.

Greedy rows of a batch are not bit-identical to batch-1 ``generate()`` rows
wherever the matrix products round differently at another batch size (the
card's GEMMs may pick another kernel for 8 rows than for 1); the reference
notes the same for TPU bf16.  Every forward of the loop runs with
``per_row=True``: an MoE layer routes each slot's tokens alone (its padded
prompt bucket at admission, its one token at a step), as the reference's
vmapped batch-1 lane does, so its capacity and drops never depend on the
other slots.  ``rolling_cache`` models are refused
(:class:`RollingCacheUnsupported`).  Speculative decoding (``draft_model``)
comes with a later slice and raises :class:`NotImplementedError`.

:class:`ContinuousEngine` also hosts **decode-mode lane groups**
(``decode_modes``: an int8-weight, an int8-KV or a fully int8 twin of the
model, each a sub-engine of its own that a request's ``quality`` picks) and a
**multi-adapter bank** (``adapters``: one resident base and up to
``adapters_max`` named LoRA adapters that co-batch in one wave, each row
gathering its own ``A``/``B``; attached and detached while the session runs).
"""

from __future__ import annotations

import collections
import hashlib
import os
import pickle
import statistics
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..ops import _kernels
from .decode import (
    _categorical,
    _filter_top_k,
    generate,
    inference_params,
    init_cache,
    set_cursor,
)
from .lora import LoRADense, adapter_digest, adapter_leaves, adapter_state, add_lora
from .quant import SERVING_MODES, mode_variant
from .transformer import (
    LayerCache,
    TransformerLM,
    lm_125m_config,
    resolve_device,
    use_batch_invariant,
)

#: Version of this package's KV bundle (``prefill_only``'s output).  The
#: bundle is this port's own format; the reference engine does not read it.
KV_BUNDLE_VERSION = 1
KV_BUNDLE_FORMAT = "covalent_tpu_plugin_torch"

#: Mixed into the generator's seed to start the admission key chain.
_ADMISSION_SALT = 0x5E1

#: Speculative and beam decoding come with this slice.
SLICE_3B = "slice 3b (speculative and beam decoding)"
#: The adapter bank's named slots when ``adapters_max`` is not given.
ADAPTERS_MAX_ENV = "COVALENT_TPU_SERVE_ADAPTERS_MAX"


class RollingCacheUnsupported(ValueError):
    """Typed refusal: continuous serving assumes the plain cache layout.

    ``rolling_cache`` models ring-rotate their KV slots, and resetting a slot
    at admission assumes the plain append-only layout.  Tagged PERMANENT
    (``fault_label``/``fault_transient``) like the reference's, so a
    misconfigured session is refused once instead of retried.
    """

    fault_label = "serve_model_unsupported"
    fault_transient = False


class AdapterUnsupported(ValueError):
    """Typed refusal: this engine cannot host the requested adapter set (a
    base that carries adapters already, a rank or geometry that does not
    match the bank's template, a full bank).  PERMANENT, like
    :class:`RollingCacheUnsupported`, so it is refused once, not retried."""

    fault_label = "serve_model_unsupported"
    fault_transient = False


def _require_plain_cache(config, what: str) -> None:
    if config.rolling_cache:
        raise RollingCacheUnsupported(
            f"{what} does not support rolling_cache models "
            "(slot reset assumes the plain cache layout)"
        )


def _choose_tokens(logits: torch.Tensor, temperature: float, top_k: int | None,
                   generator: torch.Generator | None) -> torch.Tensor:
    """Shared greedy/sampling rule for the loop and the prefill."""
    logits = logits.float()
    if temperature > 0:
        scaled = logits / temperature
        if top_k is not None:
            scaled = _filter_top_k(scaled, top_k)
        return _categorical(scaled, generator)
    return torch.argmax(logits, dim=-1)


class _AdmissionChain:
    """The per-admission key chain: one key per admitted request, in
    admission order, however admissions group into waves."""

    def __init__(self, generator: torch.Generator):
        self._chain = torch.Generator().manual_seed(generator.initial_seed() ^ _ADMISSION_SALT)

    def next_key(self) -> int:
        return int(torch.randint(0, 2**62, (), generator=self._chain))


def _first_tokens(last: torch.Tensor, keys: Sequence[int], temperature: float,
                  top_k: int | None) -> torch.Tensor:
    """Each admitted row's first token from its prompt's last logits, a
    sampled row drawing from a generator seeded with its own key."""
    if temperature <= 0:
        return _choose_tokens(last, temperature, top_k, None)
    return torch.cat([
        _choose_tokens(last[r:r + 1], temperature, top_k,
                       torch.Generator(device=last.device).manual_seed(key))
        for r, key in enumerate(keys)
    ])


def _bucket(size: int, limit: int) -> int:
    """Power-of-two prefill bucket for ``size`` tokens, capped at ``limit``."""
    return min(1 << (int(size) - 1).bit_length(), limit)


class _State:
    """Device state of the serving loop: per slot, a row of KV cache and of
    the token buffer, the position of the token it feeds next (``pos``), its
    prompt length, budget, tokens generated so far and ``done`` (empty slots
    are done)."""

    def __init__(self, model: TransformerLM, slots: int, length: int, pad: int):
        device = model.embedding.device
        #: the adapter bank's modules, and each slot's bank slot (0: base)
        self.lora = [m for m in model.modules() if isinstance(m, LoRADense) and m.bank is not None]
        self.aslot = torch.zeros(slots, dtype=torch.long, device=device)
        self.caches = init_cache(model, slots)
        self.buffer = torch.full((slots, length), pad, dtype=torch.long, device=device)
        self.pos = torch.zeros(slots, dtype=torch.long, device=device)
        self.plen = torch.ones(slots, dtype=torch.long, device=device)
        self.row_cap = torch.ones(slots, dtype=torch.long, device=device)
        self.n_gen = torch.zeros(slots, dtype=torch.long, device=device)
        self.done = torch.ones(slots, dtype=torch.bool, device=device)

    def write_lanes(self, slots: Sequence[int], lanes: list[LayerCache]) -> None:
        """Copy the rows of ``lanes`` (batch len(slots)) into the slots."""
        index = torch.tensor(list(slots), device=self.pos.device)
        for dst, src in zip(self.caches, lanes):
            dst.k[index] = src.k
            dst.v[index] = src.v
            if dst.k_scale is not None:
                dst.k_scale[index] = src.k_scale
                dst.v_scale[index] = src.v_scale

    def lane(self, slot: int, cursor: int) -> list[LayerCache]:
        """A batch-1 copy of one slot's cache, cursor parked at ``cursor``."""
        return [_lane_copy(c, slot, cursor) for c in self.caches]

    def admit(self, slots: Sequence[int], rows: np.ndarray, plens: Sequence[int],
              caps: Sequence[int], firsts: torch.Tensor, eos: int | None,
              aslots: Sequence[int] | None = None) -> None:
        """Start decoding in ``slots``: buffer rows (prompt, then the first
        token at the prompt's end), positions, budgets, one token generated,
        and each row's bank slot."""
        device = self.pos.device
        index = torch.tensor(list(slots), device=device)
        if aslots is not None:
            self.aslot[index] = torch.tensor(list(aslots), device=device)
        plens_t = torch.tensor(list(plens), device=device)
        caps_t = torch.tensor(list(caps), device=device)
        rows_t = torch.as_tensor(rows, dtype=torch.long).to(device)
        rows_t[torch.arange(len(slots), device=device), plens_t] = firsts
        self.buffer[index] = rows_t
        self.pos[index] = plens_t
        self.plen[index] = plens_t
        self.row_cap[index] = caps_t
        self.n_gen[index] = 1
        fin = caps_t <= 1
        if eos is not None:
            fin |= firsts == eos
        self.done[index] = fin


def _lane_copy(cache: LayerCache, row: int, cursor: int) -> LayerCache:
    pick = slice(row, row + 1)
    device = cache.k.device
    return LayerCache(
        k=cache.k[pick].clone(), v=cache.v[pick].clone(),
        cursor=torch.full((1,), cursor, dtype=torch.long, device=device), bound=cursor,
        k_scale=None if cache.k_scale is None else cache.k_scale[pick].clone(),
        v_scale=None if cache.v_scale is None else cache.v_scale[pick].clone(),
    )


def _set_rows(lora: list[LoRADense], rows: torch.Tensor) -> None:
    """The bank slot of each row of the next forward, for every adapter
    module of a bank."""
    for module in lora:
        module.rows = rows


def _prefill(model: TransformerLM, padded: np.ndarray, lens: Sequence[int],
             start: list[LayerCache] | None = None, start_len: int = 0,
             lora: Sequence[LoRADense] = (), aslots: Sequence[int] | None = None):
    """One admission prefill pass over ``padded`` ((g, bucket) tokens) on
    fresh zero lanes, or on copies of the batch-1 ``start`` lanes whose
    first ``start_len`` positions are a cached prefix.  With an adapter
    bank (``lora``) row ``r`` runs under bank slot ``aslots[r]``.  Returns
    the g lanes, cursors parked at ``start_len + lens``, and each row's
    logits at its last real position."""
    device = model.embedding.device
    g = padded.shape[0]
    if lora:
        _set_rows(list(lora), torch.tensor(list(aslots or [0] * g), device=device))
    lanes = init_cache(model, g)
    if start is not None:
        for dst, src in zip(lanes, start):
            dst.k.copy_(src.k.expand_as(dst.k))
            dst.v.copy_(src.v.expand_as(dst.v))
            if dst.k_scale is not None:
                dst.k_scale.copy_(src.k_scale.expand_as(dst.k_scale))
                dst.v_scale.copy_(src.v_scale.expand_as(dst.v_scale))
    set_cursor(lanes, start_len, start_len)
    logits = model(torch.as_tensor(padded, dtype=torch.long).to(device), cache=lanes,
                   per_row=True)
    last_idx = torch.tensor([n - 1 for n in lens], device=device)
    last = logits[torch.arange(g, device=device), last_idx]
    ends = [start_len + n for n in lens]
    set_cursor(lanes, torch.tensor(ends, device=device), max(ends))
    return lanes, last


def _run_steps(model: TransformerLM, state: _State, steps: int, temperature: float,
               top_k: int | None, eos: int | None, generator: torch.Generator | None) -> None:
    """``steps`` decode steps across every slot, on the device, no host read.

    A row inside its prompt (streamed admission) writes back its own next
    prompt token, so one write serves streaming prefill and decode alike; a
    done row holds its position.
    """
    buffer, length = state.buffer, state.buffer.shape[1]
    rows = torch.arange(buffer.shape[0], device=buffer.device)
    _set_rows(state.lora, state.aslot)
    for _ in range(steps):
        set_cursor(state.caches, state.pos, length - 1)
        token = buffer.gather(1, state.pos[:, None])
        logits = model(token, cache=state.caches, per_row=True)[:, -1]
        nxt = _choose_tokens(logits, temperature, top_k, generator)
        in_prompt = (state.pos + 1) < state.plen
        write_idx = (state.pos + 1).clamp(max=length - 1)
        prompt_next = buffer[rows, write_idx]
        gen_now = ~in_prompt & ~state.done
        buffer[rows, write_idx] = torch.where(gen_now, nxt, prompt_next)
        state.n_gen += gen_now
        if eos is not None:
            state.done |= gen_now & (nxt == eos)
        state.done |= state.n_gen >= state.row_cap
        state.pos = torch.where(state.done, state.pos, state.pos + 1)


def step_accounting(caps: Sequence[int], max_batch: int, sync_steps: int) -> dict[str, int]:
    """Structural decode-step accounting for per-request budgets ``caps``:
    static waves of ``max_batch`` run to their longest member
    (``static_wave_steps``); the continuous loop packs slots greedily in
    arrival order, a freed slot re-admitting at the next ``sync_steps``
    boundary (``continuous_steps_sync``), ``continuous_steps_ideal`` the
    unquantized packing bound.  A request costs ``cap - 1`` decode steps
    (its prefill yields the first token)."""
    caps = [int(c) for c in caps]
    waves = [caps[i:i + max_batch] for i in range(0, len(caps), max_batch)]
    static = sum(max(w) - 1 for w in waves)
    ideal = [0] * max_batch
    free_at = [0] * max_batch
    finish = [0] * max_batch
    for cap in caps:
        k = min(range(max_batch), key=lambda j: ideal[j])
        ideal[k] += cap - 1
        k = min(range(max_batch), key=lambda j: free_at[j])
        finish[k] = free_at[k] + cap - 1
        free_at[k] = -(-finish[k] // sync_steps) * sync_steps
    return {
        "static_wave_steps": static,
        "continuous_steps_ideal": max(ideal),
        "continuous_steps_sync": max(finish),
    }


def _default_generator(model: TransformerLM, generator: torch.Generator | None):
    if generator is not None:
        return generator
    return torch.Generator(device=model.embedding.device).manual_seed(0)


def _check_sampling(config, temperature: float, top_k: int | None) -> None:
    if temperature <= 0 and top_k is not None:
        raise ValueError("top_k requires sampling (temperature > 0)")
    if top_k is not None and not 1 <= top_k <= config.vocab_size:
        raise ValueError(f"top_k must be in [1, {config.vocab_size}], got {top_k}")


@torch.no_grad()
def continuous_generate(
    model: TransformerLM,
    prompts: Sequence[np.ndarray],
    max_new_tokens: int | Sequence[int],
    *,
    max_batch: int = 4,
    temperature: float = 0.0,
    top_k: int | None = None,
    generator: torch.Generator | None = None,
    eos_token_id: int | None = None,
    pad_token_id: int | None = None,
    sync_steps: int = 8,
    prefill: str = "batched",
    stats: dict | None = None,
) -> list[np.ndarray]:
    """Serve ``prompts`` (1-D integer arrays) through ``max_batch``
    continuously refilled slots; returns one ``prompt + generated`` int32
    array per prompt, in input order, stopped at the request's budget or its
    EOS (included).  ``max_new_tokens`` is one budget or one per request.

    ``stats``, when given, is filled with the host loop's counters:
    ``prefill_passes`` (admission waves), ``sync_fetches`` (blocking reads of
    the device state) and ``device_chunks`` (``sync_steps``-long chunks).
    """
    config = model.config
    _require_plain_cache(config, "continuous_generate")
    use_batch_invariant(model)
    caps = None
    if isinstance(max_new_tokens, (float, np.floating)):
        max_new_tokens = int(max_new_tokens)
    if not isinstance(max_new_tokens, (int, np.integer)):
        caps = [int(c) for c in max_new_tokens]
        if len(caps) != len(prompts):
            raise ValueError(
                f"per-request max_new_tokens has {len(caps)} entries for "
                f"{len(prompts)} prompts"
            )
        if any(c < 1 for c in caps):
            raise ValueError("every per-request max_new_tokens must be >= 1")
    elif max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if sync_steps < 1:
        raise ValueError(f"sync_steps must be >= 1, got {sync_steps}")
    if prefill not in ("batched", "stream"):
        raise ValueError(f'prefill must be "batched" or "stream", got {prefill!r}')
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a generator")
    _check_sampling(config, temperature, top_k)
    prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    if not prompts:
        return []
    if any(p.size < 1 for p in prompts):
        raise ValueError("every prompt needs at least one token")
    if caps is None:
        caps = [int(max_new_tokens)] * len(prompts)
    length = max(p.size + c for p, c in zip(prompts, caps))
    if length > config.max_seq:
        raise ValueError(
            f"worst-case prompt + budget ({length}) exceeds "
            f"config.max_seq ({config.max_seq})"
        )
    batch = min(max_batch, len(prompts))
    pad = pad_token_id
    if pad is None:
        pad = eos_token_id if eos_token_id is not None else 0
    generator = _default_generator(model, generator)
    chain = _AdmissionChain(generator)
    state = _State(model, batch, length, pad)

    queue = [(i, p, c) for i, (p, c) in enumerate(zip(prompts, caps))]
    outputs: list[np.ndarray | None] = [None] * len(prompts)
    slot_req = [-1] * batch
    # Host-side lower bound on decode steps until each slot can finish
    # (exact without EOS, where it lets the loop skip fetches that cannot
    # find a finished row).
    min_left = [0] * batch
    if stats is not None:
        stats.update(prefill_passes=0, sync_fetches=0, device_chunks=0)

    def count(key: str, by: int = 1) -> None:
        if stats is not None:
            stats[key] += by

    def admit_stream(slot: int) -> None:
        req_idx, tokens, cap = queue.pop(0)
        slot_req[slot] = req_idx
        min_left[slot] = tokens.size - 1 + cap
        row = np.full((length,), pad, np.int64)
        row[: tokens.size] = tokens
        state.buffer[slot] = torch.as_tensor(row).to(state.buffer.device)
        state.plen[slot] = tokens.size
        state.row_cap[slot] = cap
        state.pos[slot] = 0
        state.n_gen[slot] = 0
        state.done[slot] = False
        for layer in state.caches:
            layer.k[slot] = 0
            layer.v[slot] = 0
            if layer.k_scale is not None:
                layer.k_scale[slot] = 0
                layer.v_scale[slot] = 0

    def admit_group(free_slots: list[int]) -> None:
        if prefill == "stream":
            for slot in free_slots:
                if queue:
                    admit_stream(slot)
            return
        picked = []  # (slot, tokens, cap, key, bucket)
        for slot in free_slots:
            if not queue:
                break
            req_idx, tokens, cap = queue.pop(0)
            slot_req[slot] = req_idx
            min_left[slot] = cap - 1
            picked.append((slot, tokens, cap, chain.next_key(),
                           _bucket(tokens.size, config.max_seq)))
        for bucket in sorted({p[4] for p in picked}):
            group = [p for p in picked if p[4] == bucket]
            _admit_wave(model, state, group, bucket, length, pad, temperature, top_k,
                        eos_token_id)
            count("prefill_passes")

    admit_group(list(range(batch)))
    while True:
        # Without EOS the budget bound is exact, so whole chunks run before
        # a fetch until some row can finish; with EOS one chunk per fetch.
        active = [s for s in range(batch) if slot_req[s] >= 0]
        chunks = 1
        if eos_token_id is None:
            bound = min((min_left[s] for s in active), default=1)
            chunks = max(1, -(-bound // sync_steps))
        for _ in range(chunks):
            _run_steps(model, state, sync_steps, temperature, top_k, eos_token_id, generator)
        count("device_chunks", chunks)
        for s in active:
            min_left[s] = max(min_left[s] - chunks * sync_steps, 0)
        done_h = state.done.cpu().numpy()
        count("sync_fetches")
        finished = [s for s in range(batch) if done_h[s] and slot_req[s] >= 0]
        if finished:
            buffer_h = state.buffer.cpu().numpy()
            plen_h = state.plen.cpu().numpy()
            n_gen_h = state.n_gen.cpu().numpy()
            for slot in finished:
                keep = int(plen_h[slot]) + int(n_gen_h[slot])
                outputs[slot_req[slot]] = buffer_h[slot, :keep].astype(np.int32)
                slot_req[slot] = -1
            if queue:
                admit_group(finished)
        if not queue and all(r < 0 for r in slot_req):
            break
    return outputs  # type: ignore[return-value]


def _admit_wave(model: TransformerLM, state: _State, group: list, bucket: int, length: int,
                pad: int, temperature: float, top_k: int | None, eos: int | None,
                start: list[LayerCache] | None = None, start_len: int = 0,
                aslots: Sequence[int] | None = None) -> None:
    """One fused admission wave: prefill the group's prompts (suffixes past
    ``start_len`` when starting from a cached prefix lane) padded to
    ``bucket``, and start them decoding in their slots, each under its bank
    slot (``aslots``; rows of different adapters share the wave).  ``group``
    holds ``(slot, tokens, cap, key, ...)``."""
    g = len(group)
    rows = np.full((g, length), pad, np.int64)
    padded = np.full((g, bucket), pad, np.int64)
    for r, (_, tokens, *_rest) in enumerate(group):
        rows[r, : tokens.size] = tokens
        padded[r, : tokens.size - start_len] = tokens[start_len:]
    lens = [tokens.size - start_len for _, tokens, *_ in group]
    lanes, last = _prefill(model, padded, lens, start, start_len, state.lora, aslots)
    firsts = _first_tokens(last, [p[3] for p in group], temperature, top_k)
    slots = [p[0] for p in group]
    state.write_lanes(slots, lanes)
    state.admit(slots, rows, [start_len + n for n in lens], [p[2] for p in group], firsts, eos,
                aslots)


def _tokens_digest(tokens: np.ndarray) -> str:
    """Content key of a token prefix (the prefix tree's index)."""
    return hashlib.sha256(np.ascontiguousarray(tokens, np.int32).tobytes()).hexdigest()


class _PrefixEntry:
    """One cached KV lane: the tokens it prefilled; ``pinned`` marks the
    constructor's ``shared_prefix``, exempt from LRU eviction; ``aslot`` is
    the bank slot whose weights computed it (0: the base), the only adapter
    it is reused under."""

    __slots__ = ("tokens", "lane", "pinned", "aslot")

    def __init__(self, tokens: np.ndarray, lane: list[LayerCache], pinned: bool,
                 aslot: int = 0):
        self.tokens = tokens
        self.lane = lane
        self.pinned = pinned
        self.aslot = aslot


def _lane_leaves(lane: list[LayerCache]) -> list[torch.Tensor]:
    leaves = []
    for layer in lane:
        leaves += [layer.k, layer.v]
        if layer.k_scale is not None:
            leaves += [layer.k_scale, layer.v_scale]
    return leaves


def _to_wire(t: torch.Tensor) -> tuple[str, np.ndarray]:
    """(dtype name, numpy array) of a tensor; bfloat16 travels as its bits."""
    t = t.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return name, t.view(torch.int16).numpy()
    return name, t.numpy()


def _from_wire(name: str, array: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(array))
    return t.view(torch.bfloat16) if name == "bfloat16" else t


class ContinuousEngine:
    """Incremental continuous batching for a resident model server.

    ``continuous_generate``'s fixed-slot loop turned inside out behind the
    serving-engine surface of the reference (``slots`` / :meth:`admit` /
    :meth:`step` / :meth:`cancel` / :meth:`close` / ``busy``): requests are
    admitted as lanes free, flushed in the same bucketed prefill waves at
    the next :meth:`step`, and each step runs one ``sync_steps`` chunk and
    returns the fresh tokens of every request since the last one.  The
    buffer width is ``length`` (default ``config.max_seq``).

    **Prefix tree.**  Every admission's prefilled lane is kept in a small
    LRU keyed by its tokens' digest and its bank slot; a later prompt under
    the same adapter reuses the deepest cached lane sharing at least
    ``prefix_min_tokens`` leading tokens with it (rewound to the common
    prefix, capped one short of the prompt) and prefills only the rest.
    ``shared_prefix`` seeds a pinned entry.  ``stats`` counts
    ``prefix_hits``/``prefix_misses``/``prefix_evictions``, the
    ``prefill_positions`` every admission paid and
    ``adapter_prefix_blocked`` (a match under another adapter, not reused).

    **KV export/import.**  :meth:`prefill_only` runs one admission prefill
    without taking a slot and returns a serialized KV bundle (this port's
    own format, ``KV_BUNDLE_VERSION``) carrying the lane group's ``quant``
    mode and the adapter's name and digest; :meth:`admit_from_kv` admits
    such a bundle into a free slot of the matching group with no prefill,
    and refuses a bundle of a mode it did not build or of a superseded
    adapter generation.

    **Decode-mode lane groups** (reference ``serve.py:1373-1456``).
    ``decode_modes`` is a subset of ``quant.SERVING_MODES`` holding ``fp``.
    Every other mode is a sub-engine of its own (its slots, its prefix
    tree) over :func:`..quant.mode_variant`'s twin of the model; a request's
    ``params["quality"]`` picks it (``None``, ``"exact"`` and ``"fp"`` the
    fp lane).  An unknown mode, or one whose twin refused to build (an MoE
    model has no int8 twin), falls back to fp, bit-exact, and counts
    ``mode_refusals``.  ``busy`` sums the groups; ``stats`` folds theirs in
    and counts ``mode_tokens_<mode>``.

    **Multi-adapter bank** (reference ``serve.py:1019-1200``).
    ``adapters={name: payload}`` (or ``adapter_rank`` for an empty bank)
    keeps one base resident and stacks each adapter's ``A``/``B`` into bank
    tensors of ``adapters_max + 1`` slots; slot 0 is the zero-B identity, so
    a base lane computes what an engine without a bank computes.  Each row
    gathers its own adapter in every product (``LoRADense.bank``), so
    requests of different adapters share a wave.  A payload is the wire
    form (``lora.adapter_leaves``), a registry bundle dict or a LoRA model.
    :meth:`attach_adapter` installs one while the session runs; re-attaching
    a live name is a hot swap (lanes in flight keep the old slot, which is
    reclaimed when they finish); :meth:`detach_adapter` retires one.  Every
    decode-mode group attaches the same adapters over its own base
    (``lora.quantize_then_lora``'s order).  ``stats`` counts
    ``adapter_tokens_<name>``, ``adapter_requests_<name>``,
    ``adapter_attaches``, ``adapter_detaches`` and ``adapter_swaps``.
    """

    def __init__(
        self,
        model: TransformerLM,
        *,
        max_batch: int = 4,
        temperature: float = 0.0,
        top_k: int | None = None,
        generator: torch.Generator | None = None,
        eos_token_id: int | None = None,
        pad_token_id: int | None = None,
        sync_steps: int = 8,
        max_new_tokens: int = 16,
        length: int | None = None,
        shared_prefix: Sequence[int] | None = None,
        prefix_cache_size: int = 8,
        prefix_min_tokens: int = 4,
        decode_modes: Sequence[str] = ("fp",),
        draft_model: TransformerLM | None = None,
        adapters: dict[str, Any] | None = None,
        adapter_rank: int | None = None,
        adapter_alpha: float = 16.0,
        adapters_max: int | None = None,
    ) -> None:
        config = model.config
        _require_plain_cache(config, "ContinuousEngine")
        use_batch_invariant(model)
        if draft_model is not None:
            raise NotImplementedError(
                f"draft_model (speculative decoding) is not ported yet: it comes with {SLICE_3B}"
            )
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if sync_steps < 1:
            raise ValueError(f"sync_steps must be >= 1, got {sync_steps}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        _check_sampling(config, temperature, top_k)
        modes = tuple(dict.fromkeys(decode_modes or ("fp",)))
        for mode in modes:
            if mode not in SERVING_MODES:
                raise ValueError(f"unknown decode mode {mode!r}; expected a subset of "
                                 f"{SERVING_MODES}")
        if "fp" not in modes:
            raise ValueError("decode_modes must include 'fp' (the bit-exact fallback lane "
                             "every refusal degrades to)")
        self._length = int(length or config.max_seq)
        if not 2 <= self._length <= config.max_seq:
            raise ValueError(f"length must be in [2, {config.max_seq}], got {self._length}")
        #: host-loop counters: prefix-tree hits and misses, the prefill
        #: positions each admission paid, the KV plane's traffic, the mode
        #: refusals and the adapter bank's lifecycle.
        self.stats: dict[str, int] = {
            "prefix_hits": 0, "prefix_misses": 0, "prefill_positions": 0,
            "prefix_evictions": 0, "kv_admits": 0, "kv_exports": 0, "mode_refusals": 0,
            "adapter_prefix_blocked": 0, "adapter_attaches": 0, "adapter_detaches": 0,
            "adapter_swaps": 0,
        }
        self._prefix_tree: collections.OrderedDict[str, _PrefixEntry] = collections.OrderedDict()
        self._prefix_cache_size = max(0, int(prefix_cache_size))
        self._prefix_min = max(1, int(prefix_min_tokens))
        self._model = model
        self._config = config
        # -- the multi-adapter bank -------------------------------------------
        self._bank: list[LoRADense] | None = None
        self._adapter_slot: dict[str, int] = {}
        self._adapter_digests: dict[str, str] = {}
        self._adapter_free: list[int] = []
        self._adapter_retired: list[int] = []
        self._slot_refs: list[int] = []
        self._rid_adapter: dict[str, tuple[int, str]] = {}
        self._adapter_rank = 0
        self._adapter_alpha = float(adapter_alpha)
        self._adapters_max = 0
        self._payloads: dict[str, list] = {}
        if adapters is not None or adapter_rank is not None:
            adapters = {str(k): v for k, v in (adapters or {}).items()}
            self._open_bank(adapters, adapter_rank, adapters_max)
        self._temperature = float(temperature)
        self._top_k = top_k
        self._eos = eos_token_id
        pad = pad_token_id
        if pad is None:
            pad = eos_token_id if eos_token_id is not None else 0
        self._pad = int(pad)
        self._sync = int(sync_steps)
        self._default_cap = int(max_new_tokens)
        self.slots = int(max_batch)
        self._generator = _default_generator(model, generator)
        self._chain = _AdmissionChain(self._generator)
        self._state: _State | None = _State(self._model, self.slots, self._length, self._pad)
        #: slot -> rid (None = free), and generated tokens already streamed.
        self._slot_rid: list[str | None] = [None] * self.slots
        self._reported = [0] * self.slots
        self._rid_slot: dict[str, int] = {}
        #: admissions awaiting a flush: (rid, tokens, cap, bank slot).
        self._pending: list[tuple[str, np.ndarray, int, int]] = []
        #: KV-bundle admissions awaiting a flush:
        #: (rid, tokens, cap, first, lane, bank slot).
        self._pending_kv: list[tuple[str, np.ndarray, int, int, list[LayerCache], int]] = []
        #: (shape, dtype name) of every leaf of a batch-1 lane.
        self._lane_shapes = [
            ((1,) + tuple(t.shape[1:]), str(t.dtype).removeprefix("torch."))
            for t in _lane_leaves(self._state.caches)
        ]
        if shared_prefix is not None:
            ptoks = np.asarray(shared_prefix, np.int32).reshape(-1)
            if ptoks.size < 1:
                raise ValueError("shared_prefix needs at least one token")
            if ptoks.size + 2 > self._length:
                raise ValueError(
                    f"shared_prefix ({ptoks.size} tokens) leaves no room "
                    f"for a suffix + generation inside the session's "
                    f"static length ({self._length})"
                )
            # One exact-length pass on a zero lane, cursor parked at the
            # prefix's end: a pinned entry of the prefix tree (base slot).
            with torch.no_grad():
                lane, _ = _prefill(self._model, ptoks[None].astype(np.int64), [ptoks.size],
                                   lora=self._state.lora, aslots=[0])
            self._insert_prefix(ptoks, lambda: lane, pinned=True)
        # -- decode-mode lane groups ----------------------------------------
        self._mode = "fp"
        self._subs: dict[str, ContinuousEngine] = {}
        self._sub_stats_seen: dict[str, dict[str, int]] = {}
        self._rid_mode: dict[str, str] = {}
        self._mode_refusal: dict[str, str] = {}
        for mode in modes:
            if mode == "fp":
                continue
            bank = {}
            if self._bank is not None:
                # quantize_then_lora's order: the twin quantizes the base,
                # the sub-engine attaches the same adapters over it
                bank = dict(adapters=self._adapter_payloads(), adapter_rank=self._adapter_rank,
                            adapter_alpha=self._adapter_alpha, adapters_max=self._adapters_max)
            try:
                sub = ContinuousEngine(
                    mode_variant(model, mode), max_batch=max_batch, temperature=temperature,
                    top_k=top_k,
                    generator=torch.Generator(device=self._generator.device).manual_seed(
                        self._generator.initial_seed()),
                    eos_token_id=eos_token_id, pad_token_id=pad_token_id,
                    sync_steps=sync_steps, max_new_tokens=max_new_tokens, length=self._length,
                    shared_prefix=shared_prefix, prefix_cache_size=prefix_cache_size,
                    prefix_min_tokens=prefix_min_tokens, **bank,
                )
            except ValueError as exc:
                self._mode_refusal[mode] = str(exc)
                self.stats["mode_refusals"] += 1
                continue
            sub._mode = mode
            self._subs[mode] = sub
            self._sub_stats_seen[mode] = {}
        for mode in modes:
            self.stats.setdefault(f"mode_tokens_{mode}", 0)

    # -- serving-engine surface -------------------------------------------

    def _dup(self, rid: str) -> bool:
        return (
            rid in self._rid_slot
            or rid in self._rid_mode
            or any(p[0] == rid for p in self._pending)
            or any(p[0] == rid for p in self._pending_kv)
        )

    def _route_mode(self, params: dict) -> str:
        """A request's ``quality`` as a lane group (``serve.py:1457-1475``):
        ``None``, ``"exact"`` and ``"fp"`` the fp lane, a built mode its
        group; anything else falls back to fp and counts ``mode_refusals``
        (a session degrades, it does not reject a request over a knob)."""
        quality = params.get("quality")
        if quality is None:
            return self._mode
        mode = "fp" if quality == "exact" else str(quality)
        if mode == self._mode or mode in self._subs:
            return mode
        self.stats["mode_refusals"] += 1
        return self._mode

    def _check_budget(self, tokens: np.ndarray, params: dict) -> int:
        cap = int(params.get("max_new_tokens", self._default_cap))
        if cap < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {cap}")
        if tokens.size + cap > self._length:
            raise ValueError(
                f"prompt + budget ({tokens.size + cap}) exceeds the "
                f"session's static length ({self._length})"
            )
        if self.busy >= self.slots:
            raise RuntimeError("no free lane (all slots busy)")
        return cap

    def _hold_adapter(self, rid: str, aslot: int, name: str) -> None:
        """Count a request's hold on its bank slot (a no-op without a bank)."""
        if self._bank is None:
            return
        self._rid_adapter[rid] = (aslot, name)
        self._slot_refs[aslot] += 1
        key = f"adapter_requests_{name}"
        self.stats[key] = self.stats.get(key, 0) + 1

    def admit(self, rid: str, prompt, params: dict | None = None) -> None:
        """Reserve a lane for one request (flushed at the next step).

        ``params`` may carry ``max_new_tokens``, ``quality`` (a decode mode)
        and ``adapter`` (a bank name; ``"base"`` or none the base); sampling
        and EOS are session-static.  Raises on malformed prompts and unknown
        adapters, so the session rejects the request instead of wedging a
        lane.
        """
        params = params or {}
        if self._dup(rid):
            raise ValueError(f"request id {rid!r} already admitted")
        mode = self._route_mode(params)
        if mode != self._mode:
            if self.busy >= self.slots:
                raise RuntimeError("no free lane (all slots busy)")
            self._subs[mode].admit(rid, prompt, params)
            self._rid_mode[rid] = mode
            return
        tokens = np.asarray(prompt, np.int32).reshape(-1)
        if tokens.size < 1:
            raise ValueError("prompt needs at least one token")
        cap = self._check_budget(tokens, params)
        aslot, aname = self._resolve_adapter(params)
        self._hold_adapter(rid, aslot, aname)
        self._pending.append((rid, tokens, cap, aslot))

    @torch.no_grad()
    def prefill_only(self, prompt, params: dict | None = None) -> bytes:
        """Run the admission prefill for one prompt without taking a slot;
        returns a serialized KV bundle: the prompt, the prefilled lane, the
        first generated token, the sampling fingerprint, the lane group's
        ``quant`` mode and the adapter's name and digest.  Consumes one key
        of the admission chain, like an admission; warms the prefix tree."""
        params = params or {}
        mode = self._route_mode(params)
        if mode != self._mode:
            return self._subs[mode].prefill_only(prompt, params)
        tokens = np.asarray(prompt, np.int32).reshape(-1)
        if tokens.size < 1:
            raise ValueError("prompt needs at least one token")
        if tokens.size + 1 > self._length:
            raise ValueError(
                f"prompt ({tokens.size} tokens) leaves no room for "
                f"generation inside the session's static length "
                f"({self._length})"
            )
        aslot, aname = self._resolve_adapter(params)
        key = self._chain.next_key()
        m, lane_m, _ = self._lookup_prefix(tokens, aslot)
        if m:
            bucket = _bucket(tokens.size - m, self._config.max_seq - m)
            self.stats["prefix_hits"] += 1
        else:
            bucket = _bucket(tokens.size, self._config.max_seq)
            if self._prefix_tree:
                self.stats["prefix_misses"] += 1
        padded = np.full((1, bucket), self._pad, np.int64)
        padded[0, : tokens.size - m] = tokens[m:]
        lane, last = _prefill(self._model, padded, [tokens.size - m], lane_m if m else None, m,
                              self._state.lora, [aslot])
        first = int(_first_tokens(last, [key], self._temperature, self._top_k)[0])
        self.stats["prefill_positions"] += bucket
        self.stats["kv_exports"] += 1
        self._insert_prefix(tokens, lambda: lane, aslot=aslot)
        bundle = {
            "v": KV_BUNDLE_VERSION,
            "format": KV_BUNDLE_FORMAT,
            "prompt": [int(t) for t in tokens],
            "first": first,
            "plen": int(tokens.size),
            "rng": key,
            "temperature": self._temperature,
            "top_k": self._top_k,
            "eos": self._eos,
            "quant": self._mode,
            # the bank slot is this engine's own: the bundle names the
            # adapter and its generation, the importer resolves its slot
            "adapter": "" if aname == "base" else aname,
            "adapter_digest": self._adapter_digests.get(aname, ""),
            "leaves": [_to_wire(t) for t in _lane_leaves(lane)],
        }
        return pickle.dumps(bundle, protocol=4)

    def admit_from_kv(self, rid: str, bundle, params: dict | None = None) -> None:
        """Reserve a lane for a request whose prefill ran elsewhere (flushed
        at the next step).  ``bundle`` is :meth:`prefill_only`'s bytes or
        the unpickled dict.  Its ``quant`` mode picks the lane group; its
        lane is validated leaf by leaf against that group's cache layout,
        its sampling fingerprint against this engine's, its adapter against
        the bank (a name it does not host, or a digest of a superseded
        generation); a mismatch raises :class:`ValueError`, so the caller
        falls back to a full prefill.  No admission key is consumed."""
        params = params or {}
        if isinstance(bundle, (bytes, bytearray)):
            bundle = pickle.loads(bytes(bundle))
        if (not isinstance(bundle, dict) or int(bundle.get("v") or 0) != KV_BUNDLE_VERSION
                or bundle.get("format") != KV_BUNDLE_FORMAT):
            raise ValueError("unrecognized KV bundle")
        if self._dup(rid):
            raise ValueError(f"request id {rid!r} already admitted")
        quant = str(bundle.get("quant", "fp") or "fp")
        if quant != self._mode:
            sub = self._subs.get(quant)
            if sub is None:
                raise ValueError(
                    f"KV bundle quantization fingerprint {quant!r} does not match this "
                    f"engine's {self._mode!r} and no {quant!r} lane group is configured"
                )
            if self.busy >= self.slots:
                raise RuntimeError("no free lane (all slots busy)")
            sub._admit_from_kv_dict(rid, bundle, params)
            self._rid_mode[rid] = quant
            return
        self._admit_from_kv_dict(rid, bundle, params)

    def _admit_from_kv_dict(self, rid: str, bundle: dict, params: dict) -> None:
        """Validate and queue one unpickled bundle into this lane group."""
        quant = str(bundle.get("quant", "fp") or "fp")
        if quant != self._mode:
            raise ValueError(f"KV bundle quantization fingerprint {quant!r} does not match "
                             f"this lane group's {self._mode!r}")
        fingerprint = (
            float(bundle.get("temperature", 0.0) or 0.0), bundle.get("top_k"), bundle.get("eos"),
        )
        ours = (self._temperature, self._top_k, self._eos)
        if fingerprint != ours:
            raise ValueError(
                f"KV bundle sampling fingerprint {fingerprint} does not match this engine's {ours}"
            )
        aname = str(bundle.get("adapter") or "")
        if aname and self._bank is None:
            raise ValueError(
                f"KV bundle was prefilled under adapter {aname!r} and "
                "this session hosts no adapter bank"
            )
        aslot, alabel = self._resolve_adapter({"adapter": aname} if aname else {})
        if aname:
            want = str(bundle.get("adapter_digest") or "")
            have = self._adapter_digests.get(alabel, "")
            if want and have and want != have:
                raise ValueError(
                    f"KV bundle adapter digest {want[:12]} does not match the attached "
                    f"{aname!r} generation {have[:12]} (stale bundle after a hot swap)"
                )
        tokens = np.asarray(bundle.get("prompt") or (), np.int32).reshape(-1)
        if tokens.size < 1:
            raise ValueError("KV bundle has an empty prompt")
        cap = self._check_budget(tokens, params)
        leaves = bundle.get("leaves")
        if not isinstance(leaves, (list, tuple)) or len(leaves) != len(self._lane_shapes):
            raise ValueError(
                "KV bundle does not match this engine's cache layout "
                f"({len(leaves) if isinstance(leaves, (list, tuple)) else 0}"
                f" leaves, want {len(self._lane_shapes)})"
            )
        imported = []
        for (name, array), (shape, dtype) in zip(leaves, self._lane_shapes):
            array = np.asarray(array)
            if tuple(array.shape) != shape or name != dtype:
                raise ValueError(
                    f"KV bundle lane leaf {array.shape}/{name} does "
                    f"not match this engine's {shape}/{dtype}"
                )
            imported.append(_from_wire(name, array).to(self._model.embedding.device))
        plen = int(tokens.size)
        lane, it = [], iter(imported)
        for layer in self._state.caches:
            entry = LayerCache(k=next(it), v=next(it), bound=plen,
                               cursor=torch.full((1,), plen, dtype=torch.long,
                                                 device=layer.k.device))
            if layer.k_scale is not None:
                entry.k_scale, entry.v_scale = next(it), next(it)
            lane.append(entry)
        self._hold_adapter(rid, aslot, alabel)
        self._pending_kv.append((rid, tokens, cap, int(bundle.get("first") or 0), lane, aslot))
        self.stats["kv_admits"] += 1

    @torch.no_grad()
    def step(self) -> list[dict]:
        """Flush admissions, run one sync chunk in every busy lane group,
        return fresh tokens.

        One event per request with new output since the previous chunk:
        ``{"rid", "tokens": [int, ...], "done": bool}``; the first event
        includes the admission-prefill token, the final one the EOS (when
        configured): the rows ``continuous_generate`` would return, in
        pieces.  The groups' counters fold into :attr:`stats`.
        """
        if self._bank is not None:
            self._reclaim_adapter_slots()
        events = self._step_local()
        fresh = sum(len(ev["tokens"]) for ev in events)
        if fresh:
            key = f"mode_tokens_{self._mode}"
            self.stats[key] = self.stats.get(key, 0) + fresh
        for sub in self._subs.values():
            if not sub.busy:
                continue
            for event in sub.step():
                if event.get("done"):
                    self._rid_mode.pop(event["rid"], None)
                events.append(event)
        self._sync_sub_stats()
        return events

    def _sync_sub_stats(self) -> None:
        """Add what each group counted since the last call to :attr:`stats`."""
        for mode, sub in self._subs.items():
            seen = self._sub_stats_seen[mode]
            for key, value in sub.stats.items():
                delta = value - seen.get(key, 0)
                if delta:
                    self.stats[key] = self.stats.get(key, 0) + delta
                    seen[key] = value

    def _step_local(self) -> list[dict]:
        """One sync chunk of this lane group alone."""
        self._flush_admissions()
        if not self._rid_slot:
            return []
        state = self._state
        _run_steps(self._model, state, self._sync, self._temperature, self._top_k, self._eos,
                   self._generator)
        buffer_h = state.buffer.cpu().numpy()
        plen_h, n_gen_h, done_h = (
            t.cpu().numpy() for t in (state.plen, state.n_gen, state.done)
        )
        events: list[dict] = []
        for slot in range(self.slots):
            rid = self._slot_rid[slot]
            if rid is None:
                continue
            total = int(n_gen_h[slot])
            start = int(plen_h[slot]) + self._reported[slot]
            fresh = buffer_h[slot, start: int(plen_h[slot]) + total]
            finished = bool(done_h[slot])
            if fresh.size or finished:
                events.append({"rid": rid, "tokens": [int(t) for t in fresh], "done": finished})
            if self._bank is not None and fresh.size:
                key = f"adapter_tokens_{self._rid_adapter.get(rid, (0, 'base'))[1]}"
                self.stats[key] = self.stats.get(key, 0) + int(fresh.size)
            self._reported[slot] += int(fresh.size)
            if finished:
                self._slot_rid[slot] = None
                self._rid_slot.pop(rid, None)
                self._release_adapter(rid)
        return events

    def cancel(self, rid: str) -> None:
        """Free a request's lane early (deadline/disconnect): the row is
        marked done on the device, which freezes it like any finished row,
        and the slot is free for the next admission."""
        mode = self._rid_mode.pop(rid, None)
        if mode is not None:
            self._subs[mode].cancel(rid)
            return
        self._pending = [p for p in self._pending if p[0] != rid]
        self._pending_kv = [p for p in self._pending_kv if p[0] != rid]
        self._release_adapter(rid)
        slot = self._rid_slot.pop(rid, None)
        if slot is None:
            return
        self._state.done[slot] = True
        self._slot_rid[slot] = None

    def close(self) -> None:
        """Drop the device state so its memory can be reclaimed."""
        self._state = None
        self._pending.clear()
        self._pending_kv.clear()
        self._prefix_tree.clear()
        self._rid_slot.clear()
        self._slot_rid = [None] * self.slots
        self._rid_adapter.clear()
        self._slot_refs = [0] * len(self._slot_refs)
        for sub in self._subs.values():
            sub.close()
        self._rid_mode.clear()

    @property
    def busy(self) -> int:
        return (len(self._rid_slot) + len(self._pending) + len(self._pending_kv)
                + sum(sub.busy for sub in self._subs.values()))

    @property
    def decode_modes(self) -> tuple[str, ...]:
        """The built lane groups, fp first (refused modes absent)."""
        return (self._mode,) + tuple(self._subs)

    def group(self, mode: str) -> "ContinuousEngine":
        """The engine of one built lane group (``self`` for fp)."""
        return self if mode == self._mode else self._subs[mode]

    # -- the multi-adapter bank --------------------------------------------

    def _open_bank(self, adapters: dict, rank: int | None, limit: int | None) -> None:
        """The bank's template (``add_lora`` over the base, shared weights)
        and its tensors, then each named adapter installed."""
        if self._config.lora_rank:
            raise AdapterUnsupported(
                "the adapter bank needs the base model, and this one already carries "
                f"adapters (lora_rank={self._config.lora_rank}): serve the base and attach "
                "adapters on top (lora.quantize_then_lora's order)")
        if rank is None:
            if not adapters:
                raise AdapterUnsupported("an empty bank needs adapter_rank to size its template")
            try:
                rank = int(np.shape(self._payload_leaves(next(iter(adapters.values())))[0])[-1])
            except (ValueError, IndexError, TypeError) as exc:
                raise AdapterUnsupported(f"cannot infer the adapter rank: {exc}") from exc
        if int(rank) < 1:
            raise AdapterUnsupported(f"adapter_rank must be >= 1, got {rank}")
        if limit is None:
            limit = int(os.environ.get(ADAPTERS_MAX_ENV) or 8)
        if int(limit) < max(1, len(adapters)):
            raise AdapterUnsupported(f"{len(adapters)} adapters exceed the bank's {limit} named "
                                     f"slots ({ADAPTERS_MAX_ENV})")
        try:
            lmodel = add_lora(self._model, rank=int(rank), alpha=self._adapter_alpha)
        except ValueError as exc:
            raise AdapterUnsupported(str(exc)) from exc
        use_batch_invariant(lmodel)
        self._adapter_rank, self._adapters_max = int(rank), int(limit)
        n_slots = self._adapters_max + 1  # + the identity at slot 0
        self._bank = [m for m in lmodel.modules() if isinstance(m, LoRADense)]
        for module in self._bank:
            a = torch.zeros((n_slots,) + tuple(module.lora_a.shape), dtype=module.dtype,
                            device=module.lora_a.device)
            b = torch.zeros((n_slots,) + tuple(module.lora_b.shape), dtype=module.dtype,
                            device=module.lora_b.device)
            a[0] = module.lora_a.detach().to(module.dtype)  # B zero: the identity
            module.bank = (a, b)
        self._model = lmodel
        self._adapter_free = list(range(1, n_slots))
        self._slot_refs = [0] * n_slots
        for name, payload in adapters.items():
            self._install_adapter(name, payload)
        self.stats.setdefault("adapter_tokens_base", 0)

    @staticmethod
    def _payload_leaves(payload) -> list:
        """An adapter payload as its wire-form leaf list: a registry bundle
        dict (``{"leaves": [...]}``), a leaf list, or a LoRA model."""
        if isinstance(payload, dict) and "leaves" in payload:
            return list(payload["leaves"])
        if isinstance(payload, (list, tuple)):
            return list(payload)
        return adapter_leaves(payload)

    def _adapter_payloads(self) -> dict[str, list]:
        """The attached adapters' wire forms, for a lane group to attach."""
        return {name: self._payloads[name] for name in self._adapter_slot}

    def _install_adapter(self, name: str, payload) -> str:
        """Write one adapter into a free bank slot; returns its digest.  A
        live name is hot-swapped: the new generation takes a fresh slot and
        the name points there; lanes in flight keep the old slot, retired
        until their holds drain (``serve.py:1537-1600``)."""
        if (not name or name == "base"
                or not all(ch.isalnum() or ch in "._-" for ch in name)):
            raise AdapterUnsupported(f"invalid adapter name {name!r} ('base' is reserved; "
                                     "names are [A-Za-z0-9._-])")
        try:
            leaves = [np.asarray(leaf, np.float32) for leaf in self._payload_leaves(payload)]
            state = adapter_state(self._model, leaves)
        except (ValueError, KeyError, TypeError) as exc:
            raise AdapterUnsupported(f"adapter {name!r} does not fit this bank: {exc}") from exc
        if isinstance(payload, dict) and payload.get("digest"):
            digest = str(payload["digest"])
        else:
            digest = adapter_digest(leaves)
        self._reclaim_adapter_slots()
        if not self._adapter_free:
            raise AdapterUnsupported(
                f"adapter bank is full ({self._adapters_max} named slots, {ADAPTERS_MAX_ENV}); "
                "detach one or raise the limit")
        slot = self._adapter_free.pop(0)
        names = {m: n for n, m in self._model.named_modules() if isinstance(m, LoRADense)}
        with torch.no_grad():
            for module in self._bank:
                a, b = module.bank
                a[slot] = state[f"{names[module]}.lora_a"].to(a.device, a.dtype)
                b[slot] = state[f"{names[module]}.lora_b"].to(b.device, b.dtype)
        old = self._adapter_slot.get(name)
        self._adapter_slot[name] = slot
        self._adapter_digests[name] = digest
        self._payloads[name] = leaves
        self.stats.setdefault(f"adapter_tokens_{name}", 0)
        if old is not None:
            self._adapter_retired.append(old)
            self._purge_prefix_slot(old)
            self.stats["adapter_swaps"] += 1
        return digest

    def attach_adapter(self, name: str, payload) -> str:
        """Install an adapter into the running session (or hot-swap a live
        name); returns its digest.  Every decode-mode group attaches it too
        (``serve.py:1602-1625``)."""
        if self._bank is None:
            raise AdapterUnsupported("this session hosts no adapter bank (construct the engine "
                                     "with adapters= or adapter_rank=)")
        digest = self._install_adapter(str(name), payload)
        for sub in self._subs.values():
            if sub._bank is not None:
                sub.attach_adapter(name, self._payloads[name])
        self.stats["adapter_attaches"] += 1
        return digest

    def detach_adapter(self, name: str) -> None:
        """Retire a named adapter: new requests refuse it at once; its bank
        slot is reclaimed when the lanes in flight finish."""
        slot = self._adapter_slot.pop(name, None)
        if slot is None:
            raise ValueError(f"unknown adapter {name!r}; attached: "
                             f"{sorted(self._adapter_slot) or 'none'}")
        self._adapter_digests.pop(name, None)
        self._payloads.pop(name, None)
        self._adapter_retired.append(slot)
        self._purge_prefix_slot(slot)
        self._reclaim_adapter_slots()
        for sub in self._subs.values():
            if sub._bank is not None and name in sub._adapter_slot:
                sub.detach_adapter(name)
        self.stats["adapter_detaches"] += 1

    @property
    def adapters(self) -> tuple[str, ...]:
        """The attached adapters' names, in attach order."""
        return tuple(self._adapter_slot)

    @property
    def adapter_digests(self) -> dict[str, str]:
        """name -> content digest of the attached generation."""
        return dict(self._adapter_digests)

    def _reclaim_adapter_slots(self) -> None:
        still = []
        for slot in self._adapter_retired:
            if self._slot_refs[slot] == 0:
                self._adapter_free.append(slot)
            else:
                still.append(slot)
        self._adapter_retired = still

    def _purge_prefix_slot(self, aslot: int) -> None:
        """Drop the prefix-tree lanes a retired slot computed."""
        for digest in [d for d, e in self._prefix_tree.items() if e.aslot == aslot]:
            del self._prefix_tree[digest]

    def _release_adapter(self, rid: str) -> None:
        entry = self._rid_adapter.pop(rid, None)
        if entry is not None and self._slot_refs:
            self._slot_refs[entry[0]] = max(0, self._slot_refs[entry[0]] - 1)

    def _resolve_adapter(self, params: dict) -> tuple[int, str]:
        """``params["adapter"]`` as ``(bank slot, name)``, the base slot 0.
        An unknown name raises :class:`ValueError`: the session refuses the
        request instead of serving the base weights."""
        name = str(params.get("adapter") or "")
        if self._bank is None:
            if name and name != "base":
                raise ValueError(f"unknown adapter {name!r} (this session hosts no adapter bank)")
            return 0, "base"
        if not name or name == "base":
            return 0, "base"
        slot = self._adapter_slot.get(name)
        if slot is None:
            raise ValueError(f"unknown adapter {name!r}; attached: "
                             f"{sorted(self._adapter_slot) or 'none'}")
        return slot, name

    # -- internals ---------------------------------------------------------

    def _lookup_prefix(self, tokens: np.ndarray,
                       aslot: int = 0) -> tuple[int, list[LayerCache] | None, str]:
        """``(m, lane, digest)`` of the deepest cached prefix usable for
        ``tokens`` under bank slot ``aslot``, ``(0, None, "")`` when none is.
        An entry is usable at depth ``m`` when its first ``m`` tokens equal
        the prompt's (``m`` at most ``len(prompt) - 1``: the suffix pass
        needs a position to read the first token's logits from) and ``m >=
        prefix_min_tokens``; the positions past ``m`` of a partial match stay
        dead until the suffix pass overwrites them.  An entry of another
        slot is never used: a match there counts ``adapter_prefix_blocked``
        (``serve.py:2097-2140``)."""
        best_m, best_digest, best_entry = 0, "", None
        blocked = False
        limit_all = int(tokens.size) - 1
        for digest, entry in self._prefix_tree.items():
            limit = min(int(entry.tokens.size), limit_all)
            if limit < self._prefix_min or (entry.aslot == aslot and limit <= best_m):
                continue
            eq = entry.tokens[:limit] == tokens[:limit]
            m = limit if bool(eq.all()) else int(np.argmin(eq))
            if entry.aslot != aslot:
                blocked |= m >= self._prefix_min
            elif m >= self._prefix_min and m > best_m:
                best_m, best_digest, best_entry = m, digest, entry
        if best_entry is None:
            if blocked:
                self.stats["adapter_prefix_blocked"] += 1
            return 0, None, ""
        self._prefix_tree.move_to_end(best_digest)
        return best_m, best_entry.lane, best_digest

    def _insert_prefix(self, tokens: np.ndarray, lane_fn: Callable[[], list[LayerCache]],
                       pinned: bool = False, aslot: int = 0) -> None:
        """Cache one prefilled lane under its bank slot and its tokens'
        digest (LRU-bounded; ``lane_fn`` defers the copy until the entry is
        known to be new)."""
        if not pinned and (
            self._prefix_cache_size <= 0 or int(tokens.size) < self._prefix_min + 1
        ):
            return
        digest = f"{int(aslot)}:{_tokens_digest(tokens)}"
        if digest in self._prefix_tree:
            self._prefix_tree.move_to_end(digest)
            return
        self._prefix_tree[digest] = _PrefixEntry(
            np.array(tokens, np.int32, copy=True), lane_fn(), pinned, int(aslot)
        )
        unpinned = [d for d, e in self._prefix_tree.items() if not e.pinned]
        while len(unpinned) > self._prefix_cache_size:
            del self._prefix_tree[unpinned.pop(0)]
            self.stats["prefix_evictions"] += 1

    def _flush_admissions(self) -> None:
        """Admit pending requests in bucketed waves, as ``continuous_generate``
        does: one wave per full-prefill bucket (rows of any adapters), one per
        (prefix entry, depth, bucket) of prefix-tree hits (entries are
        adapter-scoped, so such a wave holds one adapter), one for KV
        bundles.  The admission keys are split in admission order before the
        hit/miss partition, so sampled streams do not depend on the road a
        prompt takes.  Every admitted lane then goes into the prefix tree."""
        if not (self._pending or self._pending_kv):
            return
        state = self._state
        free = [s for s in range(self.slots) if self._slot_rid[s] is None]
        picked: list[tuple[int, np.ndarray, int, int, int, int]] = []
        picked_prefix: dict[tuple[str, int, int], tuple[list[LayerCache], list]] = {}
        picked_kv = []
        while self._pending and free:
            rid, tokens, cap, aslot = self._pending.pop(0)
            slot = free.pop(0)
            self._slot_rid[slot] = rid
            self._rid_slot[rid] = slot
            self._reported[slot] = 0
            key = self._chain.next_key()
            m, lane_m, entry_digest = self._lookup_prefix(tokens, aslot)
            if m:
                # pad K/V land past m + the suffix: the bucket is capped to
                # what fits beyond the reused prefix
                bucket = _bucket(tokens.size - m, self._config.max_seq - m)
                self.stats["prefix_hits"] += 1
                self.stats["prefill_positions"] += bucket
                _, group = picked_prefix.setdefault((entry_digest, m, bucket), (lane_m, []))
                group.append((slot, tokens, cap, key, aslot))
            else:
                bucket = _bucket(tokens.size, self._config.max_seq)
                if self._prefix_tree:
                    self.stats["prefix_misses"] += 1
                self.stats["prefill_positions"] += bucket
                picked.append((slot, tokens, cap, key, bucket, aslot))
        while self._pending_kv and free:
            rid, tokens, cap, first, lane, aslot = self._pending_kv.pop(0)
            slot = free.pop(0)
            self._slot_rid[slot] = rid
            self._rid_slot[rid] = slot
            self._reported[slot] = 0
            picked_kv.append((slot, tokens, cap, first, lane, aslot))
        args = (self._length, self._pad, self._temperature, self._top_k, self._eos)
        for bucket in sorted({p[4] for p in picked}):
            group = [p for p in picked if p[4] == bucket]
            _admit_wave(self._model, state, group, bucket, *args, aslots=[p[5] for p in group])
        for (_, m, bucket), (lane_m, group) in picked_prefix.items():
            _admit_wave(self._model, state, group, bucket, *args, start=lane_m, start_len=m,
                        aslots=[p[4] for p in group])
        if picked_kv:
            slots = [p[0] for p in picked_kv]
            rows = np.full((len(picked_kv), self._length), self._pad, np.int64)
            for r, (_, tokens, *_rest) in enumerate(picked_kv):
                rows[r, : tokens.size] = tokens
            lanes = [
                LayerCache(
                    k=torch.cat([p[4][i].k for p in picked_kv]),
                    v=torch.cat([p[4][i].v for p in picked_kv]),
                    cursor=torch.zeros(len(picked_kv), dtype=torch.long, device=layer.k.device),
                    k_scale=None if layer.k_scale is None
                    else torch.cat([p[4][i].k_scale for p in picked_kv]),
                    v_scale=None if layer.v_scale is None
                    else torch.cat([p[4][i].v_scale for p in picked_kv]),
                )
                for i, layer in enumerate(state.caches)
            ]
            state.write_lanes(slots, lanes)
            firsts = torch.tensor([p[3] for p in picked_kv], device=state.pos.device)
            state.admit(slots, rows, [p[1].size for p in picked_kv], [p[2] for p in picked_kv],
                        firsts, self._eos, [p[5] for p in picked_kv])
        if self._prefix_cache_size > 0:
            admitted = (
                [(p[0], p[1], p[5]) for p in picked]
                + [(slot, tokens, aslot) for _, group in picked_prefix.values()
                   for slot, tokens, _cap, _key, aslot in group]
                + [(p[0], p[1], p[5]) for p in picked_kv]
            )
            for slot, tokens, aslot in admitted:
                self._insert_prefix(
                    tokens, lambda slot=slot, n=tokens.size: state.lane(slot, n), aslot=aslot
                )


class _LMEngineFactory:
    """See :func:`lm_engine_factory`.  Pickles as host data: the config and
    either the weights as CPU tensors or only their seed."""

    def __init__(self, model: TransformerLM | None, config, seed: int | None, device,
                 engine_kwargs: dict) -> None:
        self._model = model
        self.config = model.config if model is not None else config
        self.seed = seed
        self.device = device
        self.engine_kwargs = engine_kwargs
        self.weights: dict[str, torch.Tensor] | None = None

    def __getstate__(self) -> dict:
        state = dict(self.__dict__, _model=None)
        if self._model is not None:
            state["weights"] = {name: t.detach().cpu()
                                for name, t in self._model.state_dict().items()}
        return state

    def _build(self) -> TransformerLM:
        device = resolve_device(self.device)
        if self.weights is None:
            generator = torch.Generator(device=device).manual_seed(self.seed)
            return inference_params(TransformerLM(self.config, device=device,
                                                  generator=generator))
        model = TransformerLM(self.config, device=device)
        # assign: the shipped tensors keep their dtype (bf16 inference weights)
        model.load_state_dict({k: v.to(device) for k, v in self.weights.items()}, assign=True)
        return model

    def __call__(self) -> ContinuousEngine:
        model = self._model if self._model is not None else self._build()
        return ContinuousEngine(model, **self.engine_kwargs)


def lm_engine_factory(model: TransformerLM | None = None, *, config=None, seed: int | None = None,
                      device=None, **engine_kwargs) -> Callable[[], ContinuousEngine]:
    """A zero-argument serving-session factory for an LM: calling it builds
    the :class:`ContinuousEngine` where the session lives.

    Give the ``model``, or a ``config`` and the ``seed`` of its weights (the
    bf16 inference weights ``serve_lm`` builds: the model initialised from a
    generator seeded with ``seed`` on the device, then
    :func:`~.decode.inference_params`).  Called in this process, a model's
    factory serves that model as it is.  Cloudpickled for a resident worker
    (``serving.open_session``), the factory carries host data only: the
    config and the model's weights as CPU tensors, or just the seed, whose
    payload is a few hundred bytes.  The worker then builds the model on
    ``device``: the card unless ``device="cpu"``.  The class is pickled by
    reference, so the worker must import this package (``task_env`` with
    ``PYTHONPATH``).
    """
    if (model is None) == (config is None) or (config is not None and seed is None):
        raise ValueError("lm_engine_factory needs a model, or a config and a seed")
    return _LMEngineFactory(model, config, seed, device, engine_kwargs)


# --- the serving electron ----------------------------------------------------


def _drive(engine: ContinuousEngine, prompts: list[np.ndarray], caps: list[int], sync):
    """Serve every request through ``engine``: all arrive at once and are
    admitted in order as lanes free; step until each is done.  Returns the
    streams and, per request, seconds to its first token and to its end."""
    queue = list(range(len(prompts)))
    streams: list[list[int]] = [[] for _ in prompts]
    first = [None] * len(prompts)
    end = [None] * len(prompts)
    sync()
    t0 = time.perf_counter()
    while queue or engine.busy:
        while queue and engine.busy < engine.slots:
            i = queue.pop(0)
            engine.admit(str(i), prompts[i], {"max_new_tokens": caps[i]})
        events = engine.step()
        now = time.perf_counter() - t0
        for event in events:
            i = int(event["rid"])
            streams[i].extend(event["tokens"])
            if first[i] is None and event["tokens"]:
                first[i] = now
            if event["done"]:
                end[i] = now
    return streams, first, end, time.perf_counter() - t0


def _percentiles(values) -> dict:
    return {"p50": float(np.percentile(values, 50)), "p95": float(np.percentile(values, 95))}


def _top2_margin(model: TransformerLM, tokens: np.ndarray) -> float:
    """Top-2 logit margin of the next token after ``tokens``, from a
    decode-path prefill on a fresh batch-1 cache."""
    logits = model(torch.as_tensor(tokens[None], dtype=torch.long).to(model.embedding.device),
                   cache=init_cache(model, 1))[0, -1].float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


@torch.no_grad()
def serve_lm(
    device=None,
    seed: int = 0,
    batch: int = 8,
    prompt_len: int = 128,
    new_tokens: int = 128,
    requests: int = 16,
    short_tokens: int = 32,
    max_batch: int = 8,
    sync_steps: int = 32,
    timed_calls: int = 3,
    **config_overrides,
) -> dict:
    """The slice's serving electron: the 125M LM with random bf16 inference
    weights (``lm_125m_config(max_seq=512)``, weights from a generator seeded
    with ``seed``), served two ways, as the reference's ``lm_decode`` and
    ``lm_serve`` bench arms serve it.

    * decode: ``generate`` at ``batch`` x ``prompt_len`` prompts, greedy,
      ``new_tokens`` new tokens; one warm call, then the median of
      ``timed_calls`` calls.
    * serve: ``requests`` prompts of ``prompt_len`` tokens with budgets
      ``new_tokens`` (even index) and ``short_tokens`` (odd), all arriving
      at once, through a ``ContinuousEngine`` of ``max_batch`` slots and
      ``sync_steps``; then ``continuous_generate`` on the same mix, each
      engine row against batch-1 ``generate``, and the prefill logits of an
      int8 KV cache against the float cache.

    Runs on the card unless ``device="cpu"``.  The launch counts cover the
    whole electron: the flash kernels' (the decode path runs none of them)
    and the batch-invariant kernels' (every serving product and norm).
    """
    device = resolve_device(device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    config = lm_125m_config(**{"max_seq": 512, **config_overrides})
    model = TransformerLM(config, device=device,
                          generator=torch.Generator(device=device).manual_seed(seed))
    inference_params(model)
    rng = np.random.default_rng(seed)
    _kernels.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # -- decode arm: generate at (batch, prompt_len) -> new_tokens --------
    prompt = rng.integers(0, config.vocab_size, (batch, prompt_len)).astype(np.int32)
    out = generate(model, prompt, new_tokens)
    walls = []
    for _ in range(timed_calls):
        sync()
        start = time.perf_counter()
        out = generate(model, prompt, new_tokens)
        sync()
        walls.append(time.perf_counter() - start)
    decode_s = statistics.median(walls)
    decode = {
        "batch": batch, "prompt_len": prompt_len, "new_tokens": new_tokens,
        "walls_s": walls, "median_s": decode_s,
        "e2e_tokens_per_s": batch * new_tokens / decode_s,
        "e2e_ms_per_new_token": decode_s * 1e3 / new_tokens,
        "shape_ok": tuple(out.shape) == (batch, prompt_len + new_tokens),
    }

    # -- serve arm: the continuous-batching engine ---------------------------
    prompts = [rng.integers(0, config.vocab_size, prompt_len).astype(np.int32)
               for _ in range(requests)]
    caps = [new_tokens if i % 2 == 0 else short_tokens for i in range(requests)]
    engine = lm_engine_factory(model, max_batch=max_batch, sync_steps=sync_steps,
                               max_new_tokens=new_tokens)()
    streams, first, end, serve_wall = _drive(engine, prompts, caps, sync)
    engine_stats = dict(engine.stats)
    engine.close()
    complete = all(len(s) == c for s, c in zip(streams, caps))
    serve = {
        "requests": requests, "caps": caps, "max_batch": max_batch, "sync_steps": sync_steps,
        "wall_s": serve_wall, "tokens_per_s": sum(caps) / serve_wall,
        "ttft_s": _percentiles(first) if complete else None,
        "completion_s": _percentiles(end) if complete else None,
        "engine_stats": engine_stats, "complete": complete, "streams": streams,
    }

    # -- continuous_generate on the same mix -------------------------------
    cg_stats: dict = {}
    sync()
    start = time.perf_counter()
    cg_out = continuous_generate(model, prompts, caps, max_batch=max_batch,
                                 sync_steps=sync_steps, stats=cg_stats)
    sync()
    continuous = {
        "wall_s": time.perf_counter() - start, "stats": cg_stats,
        "step_accounting": step_accounting(caps, max_batch, sync_steps),
        "streams_equal_engine": all(
            o is not None and list(o[prompt_len:]) == s for o, s in zip(cg_out, streams)
        ),
    }

    # -- engine rows against batch-1 generate rows --------------------------
    divergences = []
    for i, (p, cap) in enumerate(zip(prompts, caps)):
        ref = generate(model, p[None], cap)[0, prompt_len:].cpu().numpy()
        got = np.asarray(streams[i])
        if got.shape != ref.shape or not np.array_equal(got, ref):
            j = int(np.argmin(got == ref)) if got.shape == ref.shape else 0
            divergences.append({
                "request": i, "step": j,
                "batch1_top2_margin": _top2_margin(model, np.concatenate([p, ref[:j]])),
            })
    agreement = {"rows": requests, "equal": requests - len(divergences),
                 "divergences": divergences}

    # -- int8 KV cache against the float cache, and finite logits ----------
    qmodel = TransformerLM(
        lm_125m_config(**{"max_seq": 512, **config_overrides, "quantized_kv_cache": True}),
        device=device,
    )
    inference_params(qmodel).load_state_dict(model.state_dict())
    tokens = torch.as_tensor(prompt, dtype=torch.long).to(device)
    cache = init_cache(model, batch)
    float_logits = model(tokens, cache=cache)
    step_logits = model(float_logits[:, -1:].argmax(-1), cache=cache)
    quant_logits = qmodel(tokens, cache=init_cache(qmodel, batch))
    a, b = float_logits.double().flatten(), quant_logits.double().flatten()
    cosine = float((a @ b) / (a.norm() * b.norm()))
    finite = all(bool(torch.isfinite(t).all())
                 for t in (float_logits, step_logits, quant_logits))
    del qmodel, float_logits, quant_logits, step_logits, a, b
    sync()
    return {
        "decode": decode,
        "serve": serve,
        "continuous_generate": continuous,
        "batch1_agreement": agreement,
        "kv_int8_logit_cosine": cosine,
        "logits_finite": finite,
        "flash_launches": _kernels.launch_counts(),
        "serving_launches": _kernels.serving_launch_counts(),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        "n_params": model.parameter_count(),
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
    }
