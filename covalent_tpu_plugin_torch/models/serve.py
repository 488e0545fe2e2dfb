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
notes the same for TPU bf16.  ``rolling_cache`` models are refused
(:class:`RollingCacheUnsupported`).  Speculative decoding (``draft_model``),
decode modes other than ``("fp",)`` and adapter banks come with a later
slice and raise :class:`NotImplementedError`.
"""

from __future__ import annotations

import collections
import hashlib
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
from .transformer import (
    SLICE_3,
    LayerCache,
    TransformerLM,
    lm_125m_config,
    resolve_device,
)

#: Version of this package's KV bundle (``prefill_only``'s output).  The
#: bundle is this port's own format; the reference engine does not read it.
KV_BUNDLE_VERSION = 1
KV_BUNDLE_FORMAT = "covalent_tpu_plugin_torch"

#: Mixed into the generator's seed to start the admission key chain.
_ADMISSION_SALT = 0x5E1


class RollingCacheUnsupported(ValueError):
    """Typed refusal: continuous serving assumes the plain cache layout.

    ``rolling_cache`` models ring-rotate their KV slots, and resetting a slot
    at admission assumes the plain append-only layout.  Tagged PERMANENT
    (``fault_label``/``fault_transient``) like the reference's, so a
    misconfigured session is refused once instead of retried.
    """

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
              caps: Sequence[int], firsts: torch.Tensor, eos: int | None) -> None:
        """Start decoding in ``slots``: buffer rows (prompt, then the first
        token at the prompt's end), positions, budgets, one token generated."""
        device = self.pos.device
        index = torch.tensor(list(slots), device=device)
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


def _prefill(model: TransformerLM, padded: np.ndarray, lens: Sequence[int],
             start: list[LayerCache] | None = None, start_len: int = 0):
    """One admission prefill pass over ``padded`` ((g, bucket) tokens) on
    fresh zero lanes, or on copies of the batch-1 ``start`` lanes whose
    first ``start_len`` positions are a cached prefix.  Returns the g lanes,
    cursors parked at ``start_len + lens``, and each row's logits at its
    last real position."""
    device = model.embedding.device
    g = padded.shape[0]
    lanes = init_cache(model, g)
    if start is not None:
        for dst, src in zip(lanes, start):
            dst.k.copy_(src.k.expand_as(dst.k))
            dst.v.copy_(src.v.expand_as(dst.v))
            if dst.k_scale is not None:
                dst.k_scale.copy_(src.k_scale.expand_as(dst.k_scale))
                dst.v_scale.copy_(src.v_scale.expand_as(dst.v_scale))
    set_cursor(lanes, start_len, start_len)
    logits = model(torch.as_tensor(padded, dtype=torch.long).to(device), cache=lanes)
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
    for _ in range(steps):
        set_cursor(state.caches, state.pos, length - 1)
        token = buffer.gather(1, state.pos[:, None])
        logits = model(token, cache=state.caches)[:, -1]
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
                start: list[LayerCache] | None = None, start_len: int = 0) -> None:
    """One fused admission wave: prefill the group's prompts (suffixes past
    ``start_len`` when starting from a cached prefix lane) padded to
    ``bucket``, and start them decoding in their slots.  ``group`` holds
    ``(slot, tokens, cap, key, ...)``."""
    g = len(group)
    rows = np.full((g, length), pad, np.int64)
    padded = np.full((g, bucket), pad, np.int64)
    for r, (_, tokens, *_rest) in enumerate(group):
        rows[r, : tokens.size] = tokens
        padded[r, : tokens.size - start_len] = tokens[start_len:]
    lens = [tokens.size - start_len for _, tokens, *_ in group]
    lanes, last = _prefill(model, padded, lens, start, start_len)
    firsts = _first_tokens(last, [p[3] for p in group], temperature, top_k)
    slots = [p[0] for p in group]
    state.write_lanes(slots, lanes)
    state.admit(slots, rows, [start_len + n for n in lens], [p[2] for p in group], firsts, eos)


def _tokens_digest(tokens: np.ndarray) -> str:
    """Content key of a token prefix (the prefix tree's index)."""
    return hashlib.sha256(np.ascontiguousarray(tokens, np.int32).tobytes()).hexdigest()


class _PrefixEntry:
    """One cached KV lane: the tokens it prefilled; ``pinned`` marks the
    constructor's ``shared_prefix``, exempt from LRU eviction."""

    __slots__ = ("tokens", "lane", "pinned")

    def __init__(self, tokens: np.ndarray, lane: list[LayerCache], pinned: bool):
        self.tokens = tokens
        self.lane = lane
        self.pinned = pinned


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
    LRU keyed by its tokens' digest; a later prompt reuses the deepest
    cached lane sharing at least ``prefix_min_tokens`` leading tokens with
    it (rewound to the common prefix, capped one short of the prompt) and
    prefills only the rest.  ``shared_prefix`` seeds a pinned entry.
    ``stats`` counts ``prefix_hits``/``prefix_misses``/``prefix_evictions``
    and the ``prefill_positions`` every admission paid.

    **KV export/import.**  :meth:`prefill_only` runs one admission prefill
    without taking a slot and returns a serialized KV bundle (this port's
    own format, ``KV_BUNDLE_VERSION``); :meth:`admit_from_kv` admits such a
    bundle into a free slot with no prefill.
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
    ) -> None:
        config = model.config
        _require_plain_cache(config, "ContinuousEngine")
        if draft_model is not None:
            raise NotImplementedError(
                f"draft_model (speculative decoding) is not ported yet: it comes with {SLICE_3}"
            )
        if tuple(decode_modes or ("fp",)) != ("fp",):
            raise NotImplementedError(
                f"decode_modes {tuple(decode_modes)!r}: only ('fp',) is ported; the "
                f"quantized modes come with {SLICE_3}"
            )
        if adapters is not None or adapter_rank is not None:
            raise NotImplementedError(
                f"adapters (the multi-adapter LoRA bank) are not ported yet: they come "
                f"with {SLICE_3}"
            )
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if sync_steps < 1:
            raise ValueError(f"sync_steps must be >= 1, got {sync_steps}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        _check_sampling(config, temperature, top_k)
        self._length = int(length or config.max_seq)
        if not 2 <= self._length <= config.max_seq:
            raise ValueError(f"length must be in [2, {config.max_seq}], got {self._length}")
        #: host-loop counters: prefix-tree hits and misses, the prefill
        #: positions each admission paid, and the KV plane's traffic.
        self.stats: dict[str, int] = {
            "prefix_hits": 0, "prefix_misses": 0, "prefill_positions": 0,
            "prefix_evictions": 0, "kv_admits": 0, "kv_exports": 0,
        }
        self._prefix_tree: collections.OrderedDict[str, _PrefixEntry] = collections.OrderedDict()
        self._prefix_cache_size = max(0, int(prefix_cache_size))
        self._prefix_min = max(1, int(prefix_min_tokens))
        self._model = model
        self._config = config
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
        self._state: _State | None = _State(model, self.slots, self._length, self._pad)
        #: slot -> rid (None = free), and generated tokens already streamed.
        self._slot_rid: list[str | None] = [None] * self.slots
        self._reported = [0] * self.slots
        self._rid_slot: dict[str, int] = {}
        #: admissions awaiting a flush: (rid, tokens, cap).
        self._pending: list[tuple[str, np.ndarray, int]] = []
        #: KV-bundle admissions awaiting a flush: (rid, tokens, cap, first, lane).
        self._pending_kv: list[tuple[str, np.ndarray, int, int, list[LayerCache]]] = []
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
            # prefix's end: a pinned entry of the prefix tree.
            with torch.no_grad():
                lane, _ = _prefill(model, ptoks[None].astype(np.int64), [ptoks.size])
            self._insert_prefix(ptoks, lambda: lane, pinned=True)

    # -- serving-engine surface -------------------------------------------

    def _dup(self, rid: str) -> bool:
        return (
            rid in self._rid_slot
            or any(p[0] == rid for p in self._pending)
            or any(p[0] == rid for p in self._pending_kv)
        )

    @staticmethod
    def _check_request(params: dict) -> None:
        """A request for an adapter is refused: this engine hosts no bank."""
        name = str(params.get("adapter") or "")
        if name and name != "base":
            raise ValueError(f"unknown adapter {name!r} (this session hosts no adapter bank)")

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

    def admit(self, rid: str, prompt, params: dict | None = None) -> None:
        """Reserve a lane for one request (flushed at the next step).

        ``params`` may carry ``max_new_tokens``; sampling and EOS are
        session-static.  Raises on malformed prompts, so the session rejects
        the request instead of wedging a lane.
        """
        params = params or {}
        if self._dup(rid):
            raise ValueError(f"request id {rid!r} already admitted")
        self._check_request(params)
        tokens = np.asarray(prompt, np.int32).reshape(-1)
        if tokens.size < 1:
            raise ValueError("prompt needs at least one token")
        cap = self._check_budget(tokens, params)
        self._pending.append((rid, tokens, cap))

    @torch.no_grad()
    def prefill_only(self, prompt, params: dict | None = None) -> bytes:
        """Run the admission prefill for one prompt without taking a slot;
        returns a serialized KV bundle: the prompt, the prefilled lane, the
        first generated token and the sampling fingerprint.  Consumes one
        key of the admission chain, like an admission; warms the prefix
        tree."""
        params = params or {}
        self._check_request(params)
        tokens = np.asarray(prompt, np.int32).reshape(-1)
        if tokens.size < 1:
            raise ValueError("prompt needs at least one token")
        if tokens.size + 1 > self._length:
            raise ValueError(
                f"prompt ({tokens.size} tokens) leaves no room for "
                f"generation inside the session's static length "
                f"({self._length})"
            )
        key = self._chain.next_key()
        m, lane_m, _ = self._lookup_prefix(tokens)
        if m:
            bucket = _bucket(tokens.size - m, self._config.max_seq - m)
            self.stats["prefix_hits"] += 1
        else:
            bucket = _bucket(tokens.size, self._config.max_seq)
            if self._prefix_tree:
                self.stats["prefix_misses"] += 1
        padded = np.full((1, bucket), self._pad, np.int64)
        padded[0, : tokens.size - m] = tokens[m:]
        lane, last = _prefill(self._model, padded, [tokens.size - m], lane_m if m else None, m)
        first = int(_first_tokens(last, [key], self._temperature, self._top_k)[0])
        self.stats["prefill_positions"] += bucket
        self.stats["kv_exports"] += 1
        self._insert_prefix(tokens, lambda: lane)
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
            "quant": "fp",
            "adapter": "",
            "adapter_digest": "",
            "leaves": [_to_wire(t) for t in _lane_leaves(lane)],
        }
        return pickle.dumps(bundle, protocol=4)

    def admit_from_kv(self, rid: str, bundle, params: dict | None = None) -> None:
        """Reserve a lane for a request whose prefill ran elsewhere (flushed
        at the next step).  ``bundle`` is :meth:`prefill_only`'s bytes or
        the unpickled dict.  Its lane is validated leaf by leaf against this
        engine's cache layout and its sampling fingerprint against this
        engine's; a mismatch raises :class:`ValueError`, so the caller falls
        back to a full prefill.  No admission key is consumed."""
        params = params or {}
        if isinstance(bundle, (bytes, bytearray)):
            bundle = pickle.loads(bytes(bundle))
        if (not isinstance(bundle, dict) or int(bundle.get("v") or 0) != KV_BUNDLE_VERSION
                or bundle.get("format") != KV_BUNDLE_FORMAT):
            raise ValueError("unrecognized KV bundle")
        if self._dup(rid):
            raise ValueError(f"request id {rid!r} already admitted")
        if str(bundle.get("quant", "fp") or "fp") != "fp":
            raise ValueError(
                f"KV bundle quantization fingerprint {bundle.get('quant')!r} does not "
                "match this engine's 'fp'"
            )
        fingerprint = (
            float(bundle.get("temperature", 0.0) or 0.0), bundle.get("top_k"), bundle.get("eos"),
        )
        ours = (self._temperature, self._top_k, self._eos)
        if fingerprint != ours:
            raise ValueError(
                f"KV bundle sampling fingerprint {fingerprint} does not match this engine's {ours}"
            )
        if bundle.get("adapter"):
            raise ValueError(
                f"KV bundle was prefilled under adapter {bundle['adapter']!r} and "
                "this session hosts no adapter bank"
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
        self._pending_kv.append((rid, tokens, cap, int(bundle.get("first") or 0), lane))
        self.stats["kv_admits"] += 1

    @torch.no_grad()
    def step(self) -> list[dict]:
        """Flush admissions, run one sync chunk, return fresh tokens.

        One event per request with new output since the previous chunk:
        ``{"rid", "tokens": [int, ...], "done": bool}``; the first event
        includes the admission-prefill token, the final one the EOS (when
        configured): the rows ``continuous_generate`` would return, in
        pieces.
        """
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
            self._reported[slot] += int(fresh.size)
            if finished:
                self._slot_rid[slot] = None
                self._rid_slot.pop(rid, None)
        return events

    def cancel(self, rid: str) -> None:
        """Free a request's lane early (deadline/disconnect): the row is
        marked done on the device, which freezes it like any finished row,
        and the slot is free for the next admission."""
        self._pending = [p for p in self._pending if p[0] != rid]
        self._pending_kv = [p for p in self._pending_kv if p[0] != rid]
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

    @property
    def busy(self) -> int:
        return len(self._rid_slot) + len(self._pending) + len(self._pending_kv)

    # -- internals ---------------------------------------------------------

    def _lookup_prefix(self, tokens: np.ndarray) -> tuple[int, list[LayerCache] | None, str]:
        """``(m, lane, digest)`` of the deepest cached prefix usable for
        ``tokens``, ``(0, None, "")`` when none is.  An entry is usable at
        depth ``m`` when its first ``m`` tokens equal the prompt's (``m`` at
        most ``len(prompt) - 1``: the suffix pass needs a position to read
        the first token's logits from) and ``m >= prefix_min_tokens``; the
        positions past ``m`` of a partial match stay dead until the suffix
        pass overwrites them."""
        best_m, best_digest, best_entry = 0, "", None
        limit_all = int(tokens.size) - 1
        for digest, entry in self._prefix_tree.items():
            limit = min(int(entry.tokens.size), limit_all)
            if limit < self._prefix_min or limit <= best_m:
                continue
            eq = entry.tokens[:limit] == tokens[:limit]
            m = limit if bool(eq.all()) else int(np.argmin(eq))
            if m >= self._prefix_min and m > best_m:
                best_m, best_digest, best_entry = m, digest, entry
        if best_entry is None:
            return 0, None, ""
        self._prefix_tree.move_to_end(best_digest)
        return best_m, best_entry.lane, best_digest

    def _insert_prefix(self, tokens: np.ndarray, lane_fn: Callable[[], list[LayerCache]],
                       pinned: bool = False) -> None:
        """Cache one prefilled lane under its tokens' digest (LRU-bounded;
        ``lane_fn`` defers the copy until the entry is known to be new)."""
        if not pinned and (
            self._prefix_cache_size <= 0 or int(tokens.size) < self._prefix_min + 1
        ):
            return
        digest = _tokens_digest(tokens)
        if digest in self._prefix_tree:
            self._prefix_tree.move_to_end(digest)
            return
        self._prefix_tree[digest] = _PrefixEntry(
            np.array(tokens, np.int32, copy=True), lane_fn(), pinned
        )
        unpinned = [d for d, e in self._prefix_tree.items() if not e.pinned]
        while len(unpinned) > self._prefix_cache_size:
            del self._prefix_tree[unpinned.pop(0)]
            self.stats["prefix_evictions"] += 1

    def _flush_admissions(self) -> None:
        """Admit pending requests in bucketed waves, as ``continuous_generate``
        does: one wave per full-prefill bucket, one per (prefix entry, depth,
        bucket) of prefix-tree hits, one for KV bundles.  The admission keys
        are split in admission order before the hit/miss partition, so
        sampled streams do not depend on the road a prompt takes.  Every
        admitted lane then goes into the prefix tree."""
        if not (self._pending or self._pending_kv):
            return
        state = self._state
        free = [s for s in range(self.slots) if self._slot_rid[s] is None]
        picked: list[tuple[int, np.ndarray, int, int, int]] = []
        picked_prefix: dict[tuple[str, int, int], tuple[list[LayerCache], list]] = {}
        picked_kv = []
        while self._pending and free:
            rid, tokens, cap = self._pending.pop(0)
            slot = free.pop(0)
            self._slot_rid[slot] = rid
            self._rid_slot[rid] = slot
            self._reported[slot] = 0
            key = self._chain.next_key()
            m, lane_m, entry_digest = self._lookup_prefix(tokens)
            if m:
                # pad K/V land past m + the suffix: the bucket is capped to
                # what fits beyond the reused prefix
                bucket = _bucket(tokens.size - m, self._config.max_seq - m)
                self.stats["prefix_hits"] += 1
                self.stats["prefill_positions"] += bucket
                _, group = picked_prefix.setdefault((entry_digest, m, bucket), (lane_m, []))
                group.append((slot, tokens, cap, key))
            else:
                bucket = _bucket(tokens.size, self._config.max_seq)
                if self._prefix_tree:
                    self.stats["prefix_misses"] += 1
                self.stats["prefill_positions"] += bucket
                picked.append((slot, tokens, cap, key, bucket))
        while self._pending_kv and free:
            rid, tokens, cap, first, lane = self._pending_kv.pop(0)
            slot = free.pop(0)
            self._slot_rid[slot] = rid
            self._rid_slot[rid] = slot
            self._reported[slot] = 0
            picked_kv.append((slot, tokens, cap, first, lane))
        args = (self._length, self._pad, self._temperature, self._top_k, self._eos)
        for bucket in sorted({p[4] for p in picked}):
            _admit_wave(self._model, state, [p for p in picked if p[4] == bucket], bucket, *args)
        for (_, m, bucket), (lane_m, group) in picked_prefix.items():
            _admit_wave(self._model, state, group, bucket, *args, start=lane_m, start_len=m)
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
                        firsts, self._eos)
        if self._prefix_cache_size > 0:
            admitted = (
                [(p[0], p[1]) for p in picked]
                + [(slot, tokens) for _, group in picked_prefix.values()
                   for slot, tokens, *_ in group]
                + [(p[0], p[1]) for p in picked_kv]
            )
            for slot, tokens in admitted:
                self._insert_prefix(
                    tokens, lambda slot=slot, n=tokens.size: state.lane(slot, n)
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

    Runs on the card unless ``device="cpu"``.  The flash kernels' launch
    counts cover the whole electron (the decode path runs none of them).
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
        "peak_mem_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        "n_params": model.parameter_count(),
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
    }
