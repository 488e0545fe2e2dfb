"""Decoding a Switch-MoE LM: the port's ``generate``, ``continuous_generate``
and ``ContinuousEngine`` against the reference's, on the CPU.

The small LM of ``tests/test_torch_moe.py`` (2 layers, d_model 64, vocab
256, 4 experts, f32, reference attention, its lm_head scaled by 10 so greedy
steps have clear margins), the port's weights converted from the
reference's, each test at a roomy capacity factor (4.0, nothing dropped)
and a tight one (0.5: tokens dropped at prefill and, in ``generate``, at
the decode steps).

The reference routes over whatever tokens a call holds.  Its ``generate``
applies the model to the whole (B, S) slab, so ``N = B * S`` at a prefill
and ``N = B`` at a decode step; its engine vmaps a batch-1 lane per slot,
so a row routes over its own tokens alone: its padded prompt bucket at an
admission wave, the suffix bucket from a prefix-tree hit, one token at a
decode step or a streamed prefill.  ``MoEMlp(per_row=True)`` is that lane.

Streams are compared token for token only after the test has replayed each
stream's road on the reference (its batch-1 lane, or ``generate``'s batch)
and asserted that the replay chooses the stream's tokens with a top-2 logit
margin above 1e-4 at every step, so a near-tie shows as a setup failure.  A
routing decision the port makes differently from the reference would show
as a stream mismatch; the message then gives the smallest top-2 gate margin
the port's routers saw.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covalent_tpu_plugin.models import decode as jax_decode
from covalent_tpu_plugin.models import lora as jax_lora
from covalent_tpu_plugin.models import serve as jax_serve
from covalent_tpu_plugin.models import transformer as jax_tf
from covalent_tpu_plugin.models.moe import MoEMlp as RefMoEMlp
from covalent_tpu_plugin.models.speculative import _set_cursor
from covalent_tpu_plugin_torch.models import convert, decode, serve
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.models.moe import MoEMlp
from covalent_tpu_plugin_torch.ops import _kernels
from covalent_tpu_plugin_torch.ops import batch_invariant as bi

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=64,
            moe_experts=4)
FACTORS = {"roomy": 4.0, "tight": 0.5}
OUT_ATOL = 1e-5
MARGIN = 1e-4
CAPS = [3, 12, 5, 8, 1, 9]
ENGINE = dict(max_batch=2, sync_steps=3, max_new_tokens=8)


def _configs(capacity_factor, dtype="float32", **overrides):
    overrides = {**TINY, **overrides}
    jcfg = jax_tf.TransformerConfig(**overrides, dtype=getattr(jnp, dtype),
                                    attention="reference", moe_capacity_factor=capacity_factor,
                                    scan_layers=False)
    tcfg = torch_tf.TransformerConfig(**overrides, dtype=getattr(torch, dtype),
                                      attention="reference", moe_capacity_factor=capacity_factor)
    return jcfg, tcfg


class LM:
    """Both LMs on the same weights, the reference's jitted decode apply and
    the port's gate margins (each MoE router's smallest top-2 gate gap)."""

    def __init__(self, capacity_factor):
        self.jcfg, self.tcfg = _configs(capacity_factor)
        self.jmodel = jax_tf.TransformerLM(self.jcfg)
        params = flax.core.meta.unbox(jax.jit(self.jmodel.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
        params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 10.0
        self.params = params
        self.model = torch_tf.TransformerLM(self.tcfg, device="cpu")
        self.model.load_state_dict(
            convert.params_from_jax(jax.tree.map(np.asarray, params), self.tcfg))
        decoder = jax_decode._decode_model(self.jmodel)
        self._apply = jax.jit(lambda p, c, t: decoder.apply(
            {"params": p, "cache": c}, t, mutable=["cache"]))
        self.gate_margin = float("inf")
        for module in self.model.modules():
            if isinstance(module, MoEMlp):
                module.register_forward_pre_hook(self._watch_gates)

    def _watch_gates(self, module, args):
        x = args[0]
        gates = torch.softmax(torch.nn.functional.linear(
            x.float(), module.router.float()), dim=-1)
        top2 = torch.topk(gates, 2, dim=-1).values
        self.gate_margin = min(self.gate_margin, float((top2[..., 0] - top2[..., 1]).min()))

    def replay(self, ops, batch=1):
        """The reference's decode model on one zero cache of ``batch`` rows:
        ``("t", tokens)`` applies the model, ``("c", n)`` parks the cursor.
        Returns the logits of every apply."""
        cache = jax_decode.init_cache(self.jmodel, batch)
        out = []
        for kind, value in ops:
            if kind == "c":
                cache = _set_cursor(cache, value)
                continue
            logits, mutated = self._apply(self.params, cache, jnp.asarray(value, jnp.int32))
            cache = mutated["cache"]
            out.append(np.asarray(logits, np.float32))
        return out


@pytest.fixture(scope="module", params=sorted(FACTORS))
def lm(request):
    return LM(FACTORS[request.param])


def _bucket(n, limit):
    return min(1 << (int(n) - 1).bit_length(), limit)


def _padded(tokens, bucket, pad=0):
    row = np.full((1, bucket), pad, np.int32)
    row[0, :tokens.size] = tokens
    return row


def _wave(tokens, max_seq, start=None, m=0):
    """A lane's ops up to its first token: a bucketed admission prefill on a
    zero lane, or on ``start`` (an entry's ops) rewound to ``m``."""
    ops = [] if start is None else list(start) + [("c", m)]
    return ops + [("t", _padded(tokens[m:], _bucket(tokens.size - m, max_seq - m))),
                  ("c", tokens.size)]


def _checked(lm, ops, first_pos, stream):
    """Replay a lane (``ops`` up to its first token, whose logits sit at
    ``first_pos`` of the last apply), then one apply a generated token:
    assert the replay chooses ``stream`` with margins above ``MARGIN``."""
    ops = list(ops) + [("t", np.asarray([[t]], np.int32)) for t in stream[:-1]]
    logits = lm.replay(ops)
    picks = [logits[len(logits) - len(stream)][0, first_pos]]
    picks += [step[0, -1] for step in logits[len(logits) - len(stream) + 1:]]
    for token, row in zip(stream, picks):
        top2 = np.sort(row)[-2:]
        assert int(np.argmax(row)) == token, "the replay does not take the stream's road"
        assert top2[1] - top2[0] > MARGIN, f"near-tie {top2[1] - top2[0]}"


def _prompts(n, seed, low=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"], low + i % 4).astype(np.int32) for i in range(n)]


def _stream_ops(tokens):
    return [("t", np.asarray([[t]], np.int32)) for t in tokens]


def _equal(lm, got, want):
    assert got == want, f"streams differ; the port's smallest top-2 gate margin {lm.gate_margin}"


# -- the layer ----------------------------------------------------------------


@pytest.mark.parametrize("factor", sorted(FACTORS))
def test_per_row_moe_is_the_reference_lane(factor):
    """``MoEMlp(per_row=True)`` against ``jax.vmap`` of the reference module
    over (1, S, d) rows, and the default against the module on the whole
    batch; the tight factor drops tokens in each row and over the call."""
    jcfg, tcfg = _configs(FACTORS[factor])
    x = np.random.default_rng(3).standard_normal((3, 12, TINY["d_model"])).astype(np.float32)
    ref = RefMoEMlp(jcfg)
    variables = ref.init(jax.random.PRNGKey(1), x[:1])
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(variables["params"]))
    port = MoEMlp(tcfg, "cpu", None)
    port.load_state_dict({"router": torch.tensor(params["router"]["kernel"].T),
                          "wi": torch.tensor(params["wi"]), "wo": torch.tensor(params["wo"])})
    lanes = np.asarray(jax.vmap(lambda row: ref.apply(variables, row[None])[0])(x))
    whole = np.asarray(ref.apply(variables, x))
    with torch.no_grad():
        rows = port(torch.tensor(x), per_row=True).numpy()
        call = port(torch.tensor(x)).numpy()
        port.batch_invariant = True  # the serving form, plain twins on the CPU
        call_serving = port(torch.tensor(x)).numpy()
    np.testing.assert_allclose(rows, lanes, rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(call, whole, rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(call_serving, whole, rtol=0, atol=OUT_ATOL)
    dropped = int((np.abs(rows).max(axis=-1) == 0).sum())
    assert (dropped > 0) == (factor == "tight")
    if factor == "tight":
        assert not np.allclose(rows, whole, atol=OUT_ATOL)  # the two modes differ


def test_the_expert_products_are_the_reference_einsum():
    """The serving form's expert products are ``linear_rows`` with the
    experts as its batch, on the weights seen as (E, out, in)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 6, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16, 24)).astype(np.float32)
    want = np.einsum("ecd,edf->ecf", x, w)
    got = bi.linear_rows_plain(torch.tensor(x), torch.tensor(w).transpose(1, 2), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # on CPU tensors the routed version is the plain twin
    again = bi.linear_rows(torch.tensor(x), torch.tensor(w).transpose(1, 2), torch.float32)
    assert torch.equal(again, got)


@pytest.mark.parametrize("rows", [1, 8, 80])
def test_the_expert_products_plan_onto_the_tensor_cores(rows):
    """bf16 expert products with the weight k-contiguous (as the MoE keeps it
    on the card) plan ``bi_gemm_tc`` with the experts as the batch, at a
    decode step's and a wave's rows; a transposed view would plan the mix."""
    e, d, f = 8, 768, 3072
    x = torch.zeros(e, rows, d, dtype=torch.bfloat16)
    for w, out_f in ((torch.zeros(e, f, d, dtype=torch.bfloat16), f),
                     (torch.zeros(e, d, f, dtype=torch.bfloat16), d)):
        a = x if out_f == f else torch.zeros(e, rows, f, dtype=torch.bfloat16)
        plan = _kernels.bi_gemm_plan(a, w, torch.empty(e, rows, out_f, dtype=torch.bfloat16))
        assert plan.route == "tc" and plan.seg_k == _kernels.BI_SEG_K
    view = torch.zeros(e, d, f, dtype=torch.bfloat16).transpose(1, 2)
    assert _kernels.bi_gemm_plan(x, view, torch.empty(e, rows, f, dtype=torch.bfloat16)).route \
        == "mix"


# -- generate -------------------------------------------------------------------


@pytest.mark.parametrize("batch,chunk", [(1, None), (1, 5), (4, None), (4, 5)],
                         ids=["b1", "b1_chunk5", "b4", "b4_chunk5"])
def test_generate_matches_the_reference(lm, batch, chunk):
    """Greedy ``generate`` routes over the call as the reference's does: the
    whole (B, prompt) slab or each ``prefill_chunk`` slab, then the B tokens
    of each step (the tight factor drops some of them)."""
    prompt = np.random.default_rng(batch).integers(
        0, TINY["vocab_size"], (batch, 12)).astype(np.int32)
    new = 10
    want = np.asarray(jax_decode.generate(lm.jmodel, lm.params, jnp.asarray(prompt), new,
                                          prefill_chunk=chunk))
    slabs = [prompt] if chunk is None else [prompt[:, s:s + chunk] for s in range(0, 12, chunk)]
    logits = lm.replay([("t", s) for s in slabs]
                       + [("t", want[:, t:t + 1]) for t in range(12, 12 + new - 1)], batch)
    picks = [logits[len(slabs) - 1][:, -1]] + [step[:, -1] for step in logits[len(slabs):]]
    for t, rows in enumerate(picks):
        np.testing.assert_array_equal(rows.argmax(-1), want[:, 12 + t])
        top2 = np.sort(rows, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN
    got = decode.generate(lm.model, prompt, new, prefill_chunk=chunk).numpy()
    _equal(lm, got.tolist(), want.tolist())


def test_generate_drops_tokens_at_a_tight_decode_step():
    """At the tight factor a decode step of 4 rows over 4 experts has
    capacity 1: rows routed to a shared expert past its first are dropped,
    as in the reference, so a row's token depends on its batch (the
    reference says so at ``tests/test_moe.py:157-166``)."""
    jcfg, tcfg = _configs(FACTORS["tight"])
    module = MoEMlp(tcfg, "cpu", torch.Generator().manual_seed(0))
    x = torch.randn(4, 1, TINY["d_model"], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = module(x)
        rows = module(x, per_row=True)
    kept = (out.abs().amax(dim=-1) > 0).sum()
    assert kept < 4 and (rows.abs().amax(dim=-1) > 0).all()


# -- continuous_generate ----------------------------------------------------------


#: name: continuous_generate keyword arguments (prompts from seed 10)
CG_CASES = {
    "batched": dict(max_batch=2, sync_steps=3),
    "stream": dict(max_batch=2, sync_steps=3, prefill="stream"),
}


@pytest.mark.parametrize("name", sorted(CG_CASES))
def test_continuous_generate_matches_the_reference(lm, name):
    prompts = _prompts(len(CAPS), 10, low=5)
    want_stats, stats = {}, {}
    want = jax_serve.continuous_generate(lm.jmodel, lm.params, prompts, CAPS, stats=want_stats,
                                         **CG_CASES[name])
    for p, out in zip(prompts, want):
        stream = list(np.asarray(out)[p.size:])
        if name == "stream":
            _checked(lm, _stream_ops(p), 0, stream)
        else:
            _checked(lm, _wave(p, TINY["max_seq"]), p.size - 1, stream)
    got = serve.continuous_generate(lm.model, prompts, CAPS, stats=stats, **CG_CASES[name])
    _equal(lm, [o.tolist() for o in got], [np.asarray(o).tolist() for o in want])
    assert stats == want_stats


# -- the engine -----------------------------------------------------------------


def _drive(engine, requests):
    """Admit ``{rid: (prompt, cap)}`` as lanes free and step until every
    request is done; returns the event list of each step."""
    queue = list(requests.items())
    steps, done = [], set()
    for _ in range(200):
        while queue and engine.busy < engine.slots:
            rid, (prompt, cap) = queue.pop(0)
            engine.admit(rid, prompt, {"max_new_tokens": cap})
        events = engine.step()
        steps.append(events)
        done |= {e["rid"] for e in events if e["done"]}
        if not queue and done >= set(requests):
            return steps
    raise AssertionError("engine never drained")


def _streams(steps):
    out = {}
    for events in steps:
        for e in events:
            out.setdefault(e["rid"], []).extend(e["tokens"])
    return out


PREFIX = np.asarray([5, 9, 2, 7, 11, 3, 8, 1], np.int32)
FIRST = np.asarray([7, 3, 9, 1, 12, 5, 8, 2, 44, 61], np.int32)


def _engine_cases():
    """name: (engine keyword arguments, prompts, each request's road as
    ``(entry index or None, depth)``: a bucketed wave, or a prefix-tree hit
    on an earlier request's lane (-1: the shared prefix))."""
    shared = [np.concatenate([PREFIX, np.asarray(s, np.int32)])
              for s in ([12, 13], [20], [31, 32, 33], [40, 41, 42, 43, 44])]
    # the third prompt repeats the first, the fourth shares its first 6
    # tokens: both hit the lane the tree took in at the first admission
    repeated = [FIRST, np.asarray([30, 31, 32], np.int32), FIRST,
                np.concatenate([FIRST[:6], np.asarray([40, 41, 42], np.int32)])]
    return {
        "budgets": (dict(ENGINE), _prompts(5, 20, low=6), [(None, 0)] * 5),
        "shared_prefix": (dict(ENGINE, shared_prefix=PREFIX), shared,
                          [(-1, PREFIX.size)] * 4),
        "prefix_tree": (dict(ENGINE), repeated,
                        [(None, 0), (None, 0), (0, FIRST.size - 1), (0, 6)]),
    }


ENGINE_CASES = _engine_cases()


def _lane_ops(prompts, roads, i):
    entry, m = roads[i]
    tokens = prompts[i]
    if entry is None:
        return _wave(tokens, TINY["max_seq"])
    start = ([("t", PREFIX[None]), ("c", PREFIX.size)] if entry == -1
             else _lane_ops(prompts, roads, entry))
    return _wave(tokens, TINY["max_seq"], start, m)


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_event_sequences_match_the_reference(lm, name):
    """The same admissions give the same events, step for step, and the same
    prefix-tree counters, on bucketed waves and on prefix-tree hits."""
    kwargs, prompts, roads = ENGINE_CASES[name]
    requests = {f"r{i}": (p, CAPS[i % len(CAPS)] + 2) for i, p in enumerate(prompts)}
    ref = jax_serve.ContinuousEngine(lm.jmodel, lm.params, **kwargs)
    want = _drive(ref, requests)
    streams = _streams(want)
    for i, p in enumerate(prompts):
        _checked(lm, _lane_ops(prompts, roads, i), p.size - roads[i][1] - 1, streams[f"r{i}"])
    engine = serve.ContinuousEngine(lm.model, **kwargs)
    got = _drive(engine, requests)
    _equal(lm, got, want)
    for key in ("prefix_hits", "prefix_misses", "prefill_positions", "prefix_evictions"):
        assert engine.stats[key] == ref.stats[key], key
    assert (engine.stats["prefix_hits"] > 0) == (name != "budgets")
    engine.close()
    ref.close()


def test_engine_rows_are_what_each_request_streams_alone(lm):
    """Per-row routing: a request's stream in a full batch equals the same
    request served alone by an engine of the same ``max_batch``, whatever
    shares its waves and steps."""
    _, prompts, _ = ENGINE_CASES["budgets"]
    requests = {f"r{i}": (p, CAPS[i % len(CAPS)] + 2) for i, p in enumerate(prompts)}
    batched = _streams(_drive(serve.ContinuousEngine(lm.model, **dict(ENGINE, max_batch=4)),
                              requests))
    for rid, request in requests.items():
        alone = _streams(_drive(serve.ContinuousEngine(lm.model, **dict(ENGINE, max_batch=4)),
                                {rid: request}))
        assert alone[rid] == batched[rid], rid


def test_engine_kv_export_import_matches_the_reference_engine(lm):
    """``prefill_only`` on one engine and ``admit_from_kv`` on another stream
    what the reference's engine streams, with no prefill on the decode side."""
    _, prompts, _ = ENGINE_CASES["budgets"]
    requests = {f"r{i}": (p, CAPS[i % len(CAPS)] + 2) for i, p in enumerate(prompts)}
    want = _streams(_drive(jax_serve.ContinuousEngine(lm.jmodel, lm.params, **ENGINE),
                           requests))
    prefill = serve.ContinuousEngine(lm.model, **ENGINE)
    decode_side = serve.ContinuousEngine(lm.model, **ENGINE)
    bundles = {rid: prefill.prefill_only(p) for rid, (p, _) in requests.items()}
    queue, steps = list(requests.items()), []
    while queue or decode_side.busy:
        while queue and decode_side.busy < decode_side.slots:
            rid, (_, cap) = queue.pop(0)
            decode_side.admit_from_kv(rid, bundles[rid], {"max_new_tokens": cap})
        steps.append(decode_side.step())
    _equal(lm, _streams(steps), want)
    assert decode_side.stats["prefill_positions"] == 0
    assert decode_side.stats["kv_admits"] == prefill.stats["kv_exports"] == len(requests)


def test_decode_modes_refuse_int8_per_mode_and_serve_fp(lm):
    """On an MoE base ``quantize_lm`` refuses (the reference's words), so the
    int8 and full_quant groups are recorded refusals whose requests are
    served on fp, bit-exact; kv_quant builds over the same weights."""
    modes = ("fp", "int8", "kv_quant", "full_quant")
    kwargs = dict(ENGINE, max_batch=3)
    engine = serve.ContinuousEngine(lm.model, **kwargs, decode_modes=modes)
    ref = jax_serve.ContinuousEngine(lm.jmodel, lm.params, **kwargs, decode_modes=modes)
    assert engine.decode_modes == ref.decode_modes == ("fp", "kv_quant")
    assert engine._mode_refusal == ref._mode_refusal
    assert set(engine._mode_refusal) == {"int8", "full_quant"}
    assert "MoE" in engine._mode_refusal["int8"]
    prompts = _prompts(3, 30, low=6)
    runs = []
    for e in (engine, ref):
        for i, (p, quality) in enumerate(zip(prompts, ("int8", "fp", "full_quant"))):
            e.admit(f"q{i}", p, {"quality": quality, "max_new_tokens": 6})
        steps = []
        while e.busy:
            steps.append(e.step())
        runs.append(steps)
    _equal(lm, runs[0], runs[1])
    assert engine.stats["mode_refusals"] == ref.stats["mode_refusals"] == 4
    plain = _streams(_drive(serve.ContinuousEngine(lm.model, **kwargs),
                            {f"q{i}": (p, 6) for i, p in enumerate(prompts)}))
    assert _streams(runs[0]) == plain


def test_an_adapter_bank_on_an_moe_base_serves_as_the_reference(lm):
    """The reference's bank attaches adapters to the attention denses of an
    MoE base (its experts are no dense layers) and serves; so does the
    port's, token for token, a lane under the adapter streaming what an
    engine of base + adapter alone streams."""
    lmodel, lparams = jax_lora.add_lora(lm.jmodel, lm.params, rank=2)
    mask = jax.tree_util.tree_leaves(jax_lora.lora_mask(lparams))
    leaves, treedef = jax.tree_util.tree_flatten(lparams)
    rng = np.random.default_rng(5)
    leaves = [jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32) * 0.3)
              if m else leaf for leaf, m in zip(leaves, mask)]
    lparams = jax.tree_util.tree_unflatten(treedef, leaves)
    wire = [np.asarray(leaf) for leaf in jax_lora.adapter_leaves(lparams)]
    prompts = _prompts(3, 40, low=6)
    names = ("", "tuned", "tuned")
    runs, kwargs = [], dict(ENGINE, max_batch=3)
    for engine in (serve.ContinuousEngine(lm.model, **kwargs, adapters={"tuned": wire}),
                   jax_serve.ContinuousEngine(lm.jmodel, lm.params, **kwargs,
                                              adapters={"tuned": wire})):
        for i, (p, name) in enumerate(zip(prompts, names)):
            engine.admit(f"a{i}", p, {"adapter": name, "max_new_tokens": 6} if name
                         else {"max_new_tokens": 6})
        steps = []
        while engine.busy:
            steps.append(engine.step())
        runs.append(steps)
    _equal(lm, runs[0], runs[1])
    port_lora = torch_tf.TransformerLM(dataclasses.replace(lm.tcfg, lora_rank=2), device="cpu")
    port_lora.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, lparams),
                                                      port_lora.config))
    alone = _streams(_drive(serve.ContinuousEngine(port_lora, **kwargs),
                            {"a1": (prompts[1], 6)}))
    assert _streams(runs[0])["a1"] == alone["a1"]
    assert _streams(runs[0])["a1"] != _streams(
        _drive(serve.ContinuousEngine(lm.model, **kwargs), {"a1": (prompts[1], 6)}))["a1"]


# -- bfloat16 -------------------------------------------------------------------


#: The bf16 bound of a plain model (``tests/test_torch_decode.py``): every
#: product's inputs are rounded to bf16 on both sides, but the two stacks may
#: round a value to neighbouring bf16 numbers where their f32 sums differ in
#: the last bits, and one such step in the final features moves a logit by
#: about one rounding (2^-8) of the largest logit.  8 such roundings.  The
#: MoE adds no rounding of its own (its dispatch and combine are exact), and
#: the reference's decode applies run op by op, so XLA's excess precision
#: between fused ops (``tests/test_torch_lora.py``) does not reach them.
BF16_ROUNDINGS = 8


def bf16_pair(capacity_factor, **overrides):
    """Both LMs in bf16 activations with bf16 inference weights (the
    reference's ``inference_params``; the port's weights converted from
    them), and a prefill + 3 decode steps of tokens."""
    jcfg, tcfg = _configs(capacity_factor, "bfloat16", **overrides)
    jmodel = jax_tf.TransformerLM(jcfg)
    params = flax.core.meta.unbox(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    params = jax_decode.inference_params(params)
    model = decode.inference_params(torch_tf.TransformerLM(tcfg, device="cpu"))
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params), tcfg))
    rng = np.random.default_rng(8)
    calls = [rng.integers(0, TINY["vocab_size"], (2, 12)).astype(np.int32)] + [
        rng.integers(0, TINY["vocab_size"], (2, 1)).astype(np.int32) for _ in range(3)]
    return jmodel, params, model, calls


def reference_bf16_logits(jmodel, params, calls):
    decoder = jax_decode._decode_model(jmodel)
    cache = jax_decode.init_cache(jmodel, 2)
    out = []
    for tokens in calls:
        logits, mutated = decoder.apply({"params": params, "cache": cache},
                                        jnp.asarray(tokens), mutable=["cache"])
        cache = mutated["cache"]
        out.append(np.asarray(logits, np.float32))
    return out


@pytest.mark.parametrize("factor", sorted(FACTORS))
def test_bf16_decode_logits_match_the_reference(factor):
    """A bf16 MoE LM's prefill and decode logits on the serving route
    (``use_batch_invariant``: the plain twins on the CPU), routed over the
    call, against the reference's ``decode=True`` applies, within a plain
    model's bound (``BF16_ROUNDINGS``)."""
    jmodel, params, model, calls = bf16_pair(FACTORS[factor])
    want = reference_bf16_logits(jmodel, params, calls)
    torch_tf.use_batch_invariant(model)
    cache = decode.init_cache(model, 2)
    with torch.no_grad():
        got = [model(torch.tensor(t).long(), cache=cache).float().numpy() for t in calls]
    for i, (g, w) in enumerate(zip(got, want)):
        tol = BF16_ROUNDINGS * 2.0**-8 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"call {i}")


# -- the resident session's factory and the card's phase --------------------------


def test_an_moe_config_ships_through_the_engine_factory():
    """``lm_engine_factory(config=, seed=)`` carries an MoE config as it is:
    the factory pickled as a resident worker receives it builds the model
    from the seed and serves what an engine on the same model serves."""
    import cloudpickle

    _, tcfg = _configs(FACTORS["tight"])
    factory = serve.lm_engine_factory(config=tcfg, seed=3, device="cpu", **ENGINE)
    shipped = cloudpickle.loads(cloudpickle.dumps(factory))
    assert len(cloudpickle.dumps(factory)) < 4096  # the config and the seed, no weights
    engine = shipped()
    local = decode.inference_params(torch_tf.TransformerLM(
        tcfg, device="cpu", generator=torch.Generator().manual_seed(3)))
    requests = {f"r{i}": (p, 6) for i, p in enumerate(_prompts(3, 50, low=6))}
    assert _streams(_drive(engine, requests)) == _streams(
        _drive(serve.ContinuousEngine(local, **ENGINE), requests))


def test_chip_smoke_decodes_the_train_phases_moe_arm():
    """``chip_smoke.py``'s ``serve_moe`` phase serves the ``moe8`` arm's
    model (8 experts, the default capacity factor) at the serve cell's
    length, and counts differing tokens stream by stream."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    arms = {name: overrides for name, _, _, overrides in chip_smoke.TRAIN_ARMS}
    assert chip_smoke.MOE_SERVE == {**arms["moe8"], "max_seq": 512}
    assert torch_tf.lm_125m_config(**chip_smoke.MOE_SERVE).moe_capacity_factor == 1.25
    assert chip_smoke._tokens_differ([[1, 2, 3], [4]], [[1, 2, 3], [4]]) == 0
    assert chip_smoke._tokens_differ([[1, 2, 3], [4, 5]], [[1, 9, 3], [4]]) == 2
