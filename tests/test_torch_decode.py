"""The port's KV-cache decode path and ``generate`` against the reference's,
on the CPU.

Both LMs are tiny (2 layers, d_model 64, 4 heads, vocab 128, max_seq 64)
and use the reference attention; the port's weights come from the
reference's through ``params_from_jax``.  The same numpy prompts and tokens
go through ``decode=True`` applies of the reference and ``forward(...,
cache=...)`` calls of the port.

Tolerances:
* float32 activations: logits within atol 1e-5 + rtol 1e-5 (the same f32
  products, summed in another order).
* bfloat16 activations and bf16 ``inference_params`` weights: every matmul
  input is rounded to bf16 on both sides, but the two stacks may round a
  value to neighbouring bf16 numbers where their f32 sums differ in the last
  bits, and one such step in the final features moves a logit by about one
  bf16 rounding (2^-8) of the largest logit.  The bound is 8 such roundings.
* Greedy tokens are compared exactly, after the test has asserted that the
  reference's top-2 logit margin exceeds 1e-4 at every generated step, so a
  near-tie shows as a setup failure, never as a flaky mismatch.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covalent_tpu_plugin.models import decode as jax_decode
from covalent_tpu_plugin.models import transformer as jax_tf
from covalent_tpu_plugin_torch.models import convert, decode
from covalent_tpu_plugin_torch.models import transformer as torch_tf

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=64)
F32_ATOL = F32_RTOL = 1e-5
BF16_ROUNDINGS = 8
MARGIN = 1e-4


def _configs(dtype="float32", **overrides):
    jcfg = jax_tf.TransformerConfig(
        **TINY, **overrides, dtype=getattr(jnp, dtype), attention="reference",
    )
    tcfg = torch_tf.TransformerConfig(
        **TINY, **overrides, dtype=getattr(torch, dtype), attention="reference",
    )
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    variables = jax.jit(jax_tf.TransformerLM(jcfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32)
    )
    params = flax.core.meta.unbox(variables["params"])
    # a wider head spreads the logits, so greedy steps have clear margins
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 10.0
    return params


def _port_model(tcfg, params, bf16=False):
    model = torch_tf.TransformerLM(tcfg, device="cpu")
    if bf16:
        decode.inference_params(model)
    model.load_state_dict(
        convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg), strict=True
    )
    return model


_JAX_APPLY = {}


def _jax_calls(jcfg, params, calls, batch):
    """Logits of each call of the reference's decode model on one cache
    (its apply jitted once per config, compiled once per token shape)."""
    model = jax_tf.TransformerLM(jcfg)
    if jcfg not in _JAX_APPLY:
        decoder = jax_decode._decode_model(model)
        _JAX_APPLY[jcfg] = jax.jit(lambda p, c, t: decoder.apply(
            {"params": p, "cache": c}, t, mutable=["cache"]))
    cache = jax_decode.init_cache(model, batch)
    out = []
    for tokens in calls:
        logits, mutated = _JAX_APPLY[jcfg](params, cache, jnp.asarray(tokens))
        cache = mutated["cache"]
        out.append(np.asarray(logits, np.float32))
    return out


def _port_calls(model, calls, batch):
    cache = decode.init_cache(model, batch)
    with torch.no_grad():
        return [model(torch.tensor(t).long(), cache=cache).float().numpy() for t in calls]


def _calls(prompt_len, chunk, steps=3, batch=2, seed=1):
    """A prompt fed in chunks (a prefill, possibly chunked), then one-token
    decode steps, as numpy token arrays."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, TINY["vocab_size"], (batch, prompt_len)).astype(np.int32)
    calls = [prompt[:, s:s + chunk] for s in range(0, prompt_len, chunk)]
    return calls + [rng.integers(0, TINY["vocab_size"], (batch, 1)).astype(np.int32)
                    for _ in range(steps)]


#: name: (config overrides, prompt length, prefill chunk)
DECODE_CASES = {
    # a 24-token prompt in two slabs: the second prefills at a non-zero cursor
    "plain": (dict(), 24, 12),
    "int8_kv": (dict(quantized_kv_cache=True), 12, 12),
    # 24-token prompt, ring capacity 8 + 2: chunks of the window wrap it
    "rolling_sinks": (dict(sliding_window=8, attention_sinks=2, rolling_cache=True), 24, 8),
    "gqa_window_rope_base": (dict(n_kv_heads=2, sliding_window=7, rope_base=500000.0), 12, 12),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_prefill_and_decode_logits_match_reference(name):
    overrides, prompt_len, chunk = DECODE_CASES[name]
    jcfg, tcfg = _configs(**overrides)
    params = _jax_params(jcfg)
    calls = _calls(prompt_len, chunk)
    want = _jax_calls(jcfg, params, calls, batch=2)
    got = _port_calls(_port_model(tcfg, params), calls, batch=2)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=F32_RTOL, atol=F32_ATOL, err_msg=f"call {i}")


@pytest.mark.parametrize("name", ["plain", "rolling_sinks"])
def test_bf16_decode_logits_match_reference(name):
    """bf16 activations and bf16 inference weights on both sides (the
    reference's ``inference_params`` tree, converted bit for bit)."""
    overrides, prompt_len, chunk = DECODE_CASES[name]
    jcfg, tcfg = _configs("bfloat16", **overrides)
    params = jax_decode.inference_params(_jax_params(jcfg))
    calls = _calls(prompt_len, chunk)
    want = _jax_calls(jcfg, params, calls, batch=2)
    model = _port_model(tcfg, params, bf16=True)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    got = _port_calls(model, calls, batch=2)
    for i, (a, b) in enumerate(zip(got, want)):
        tol = BF16_ROUNDINGS * 2.0**-8 * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f"call {i}")


def test_int8_kv_cache_is_int8_with_scales_and_close_to_float():
    jcfg, tcfg = _configs(quantized_kv_cache=True)
    params = _jax_params(jcfg)
    model = _port_model(tcfg, params)
    cache = decode.init_cache(model, 2)
    assert cache[0].k.dtype == cache[0].v.dtype == torch.int8
    assert cache[0].k_scale.dtype == torch.float32 and cache[0].k_scale.shape == (2, 64, 4, 1)
    float_model = _port_model(_configs()[1], params)
    calls = _calls(12, 12, steps=0)
    a = _port_calls(float_model, calls, 2)[0].astype(np.float64).ravel()
    b = _port_calls(model, calls, 2)[0].astype(np.float64).ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert 0.999 < cos and not np.array_equal(a, b)


def test_rolling_cache_slots_and_sentinel():
    """Empty rolling slots hold position -1; after 13 tokens in a ring of
    2 sinks + 6, the sinks stay pinned and the band holds the last 6."""
    _, tcfg = _configs(sliding_window=6, attention_sinks=2, rolling_cache=True)
    model = torch_tf.TransformerLM(tcfg, device="cpu")
    cache = decode.init_cache(model, 1)
    assert cache[0].slot_pos.tolist() == [[-1] * 8]
    with torch.no_grad():
        for chunk in (torch.arange(0, 6), torch.arange(6, 12), torch.arange(12, 13)):
            model(chunk[None], cache=cache)
    assert sorted(cache[0].slot_pos[0].tolist()) == [0, 1, 7, 8, 9, 10, 11, 12]
    assert cache[0].cursor.tolist() == [13]


def test_cache_writes_raise_instead_of_clamping():
    _, tcfg = _configs()
    model = torch_tf.TransformerLM(tcfg, device="cpu")
    cache = decode.init_cache(model, 1)
    with torch.no_grad():
        model(torch.zeros(1, 60).long(), cache=cache)
        with pytest.raises(ValueError, match="does not fit"):
            model(torch.zeros(1, 5).long(), cache=cache)
    _, rcfg = _configs(sliding_window=4, attention_sinks=1, rolling_cache=True)
    rolling = torch_tf.TransformerLM(rcfg, device="cpu")
    cache = decode.init_cache(rolling, 1)
    with torch.no_grad():
        rolling(torch.zeros(1, 4).long(), cache=cache)
        # 5 > sliding_window tokens that would wrap: two in one slot
        with pytest.raises(ValueError, match="sliding_window"):
            rolling(torch.zeros(1, 5).long(), cache=cache)
        with pytest.raises(ValueError, match="exceeds the cache length"):
            rolling(torch.zeros(1, 6).long(), cache=decode.init_cache(rolling, 1))
    with pytest.raises(ValueError, match="needs a cache"):
        torch_tf.TransformerLM(dataclasses.replace(tcfg, decode=True), device="cpu")(
            torch.zeros(1, 3).long())


# --- the filters ---------------------------------------------------------------


def _filter_inputs():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((4, 128), dtype=np.float32) * 3
    # ties: row 1 has four tokens tied at its 3rd-largest value, row 2 a tie
    # straddling its nucleus cut
    order = np.argsort(-logits[1])
    logits[1, order[2:6]] = logits[1, order[2]]
    order = np.argsort(-logits[2])
    logits[2, order[3:5]] = logits[2, order[3]]
    seen = rng.integers(-1, 128, (4, 10)).astype(np.int32)
    return logits, seen


@pytest.mark.parametrize("name,arg", [
    ("top_k", 3), ("top_k", 1), ("top_p", 0.9), ("top_p", 0.5), ("min_p", 0.1),
    ("repetition_penalty", 1.3),
])
def test_filters_match_reference(name, arg):
    logits, seen = _filter_inputs()
    jl, tl = jnp.asarray(logits), torch.tensor(logits)
    if name == "repetition_penalty":
        want = jax_decode._apply_repetition_penalty(jl, jnp.asarray(seen), arg)
        got = decode._apply_repetition_penalty(tl, torch.tensor(seen).long(), arg)
    else:
        want = getattr(jax_decode, f"_filter_{name}")(jl, arg)
        got = getattr(decode, f"_filter_{name}")(tl, arg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if name == "top_k" and arg == 3:
        assert (got[1] > -1e29).sum() == 6  # the tie at the cut survives


# --- generate --------------------------------------------------------------


def _margins(jcfg, params, seqs, start, stops):
    """The reference's top-2 logit margin at every generated step of each
    sequence (positions start-1 .. stop-2), from one full forward."""
    model = jax_tf.TransformerLM(dataclasses.replace(jcfg, decode=False))
    logits = np.asarray(model.apply({"params": params}, jnp.asarray(seqs)), np.float32)
    out = []
    for row, stop in zip(logits, stops):
        top2 = np.sort(row[start - 1:stop - 1], axis=-1)[:, -2:]
        out.append(top2[:, 1] - top2[:, 0])
    return np.concatenate(out)


@pytest.fixture(scope="module")
def gen_setup():
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg, seed=2)
    prompt = np.random.default_rng(5).integers(0, 128, (3, 7)).astype(np.int32)
    jmodel = jax_tf.TransformerLM(jcfg)
    plain = np.asarray(jax_decode.generate(jmodel, params, jnp.asarray(prompt), 12))
    # an EOS that row 0 emits mid-way, so rows stop at different steps
    eos = int(plain[0, 7 + 4])
    with_eos = np.asarray(jax_decode.generate(
        jmodel, params, jnp.asarray(prompt), 12, eos_token_id=eos, pad_token_id=3,
        prefill_chunk=3,
    ))
    return jcfg, tcfg, params, prompt, plain, eos, with_eos


def test_greedy_generate_matches_reference(gen_setup):
    jcfg, tcfg, params, prompt, plain, _, _ = gen_setup
    assert _margins(jcfg, params, plain[:, :-1], 7, [18] * 3).min() > MARGIN
    model = _port_model(tcfg, params)
    got = decode.generate(model, prompt, 12)
    np.testing.assert_array_equal(got.numpy(), plain)
    np.testing.assert_array_equal(decode.generate(model, prompt, 12, prefill_chunk=2).numpy(),
                                  plain)


def test_greedy_generate_with_eos_pad_and_chunks_matches_reference(gen_setup):
    jcfg, tcfg, params, prompt, _, eos, want = gen_setup
    stops = []
    for row in want:
        hits = np.where(row[7:] == eos)[0]
        stops.append(7 + (hits[0] + 1 if hits.size else 12))
    assert min(stops) < 19 and eos in want[0, 7:]
    assert _margins(jcfg, params, want[:, :-1], 7, [min(s, 18) for s in stops]).min() > MARGIN
    model = _port_model(tcfg, params)
    got = decode.generate(model, prompt, 12, eos_token_id=eos, pad_token_id=3, prefill_chunk=3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rolling_generate_past_capacity_matches_reference():
    """Prompt past the ring's capacity (chunks of the window) and generation
    past max_seq; the margins come from the reference's own decode steps."""
    jcfg, tcfg = _configs(sliding_window=8, attention_sinks=2, rolling_cache=True)
    params = _jax_params(jcfg, seed=3)
    prompt = np.random.default_rng(6).integers(0, 128, (2, 15)).astype(np.int32)
    want = np.asarray(jax_decode.generate(jax_tf.TransformerLM(jcfg), params,
                                          jnp.asarray(prompt), 60))
    assert want.shape == (2, 75)
    calls = [want[:, :8], want[:, 8:15]] + [want[:, t:t + 1] for t in range(15, 74)]
    logits = np.concatenate([c[:, -1:] for c in _jax_calls(jcfg, params, calls, 2)[1:]], 1)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MARGIN
    got = decode.generate(_port_model(tcfg, params), prompt, 60)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_structure():
    """Sampled streams cannot match across frameworks: hold their structure.
    The same generator seed gives the same stream, top_k=1 sampling is the
    greedy stream, and every token lies inside the vocabulary."""
    _, tcfg = _configs()
    model = torch_tf.TransformerLM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    prompt = np.random.default_rng(7).integers(0, 128, (2, 5))
    draw = lambda seed, **kw: decode.generate(  # noqa: E731
        model, prompt, 10, temperature=0.8, generator=torch.Generator().manual_seed(seed), **kw)
    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 15) and int(a.min()) >= 0 and int(a.max()) < 128
    greedy = decode.generate(model, prompt, 10)
    assert torch.equal(draw(3, top_k=1), greedy)
    for kw in (dict(top_p=0.5), dict(min_p=0.2), dict(top_k=4, top_p=0.9, min_p=0.05),
               dict(repetition_penalty=1.5)):
        out = draw(4, **kw)
        assert out.shape == (2, 15) and torch.equal(out[:, :5], greedy[:, :5])


@pytest.mark.parametrize("kwargs,match", [
    (dict(top_k=3), "require sampling"),
    (dict(temperature=1.0, top_k=0), "top_k must be"),
    (dict(temperature=1.0, top_p=0.0), "top_p must be"),
    (dict(temperature=1.0, min_p=1.5), "min_p must be"),
    (dict(repetition_penalty=0.0), "repetition_penalty must be"),
    (dict(pad_token_id=1), "pad_token_id requires"),
    (dict(prefill_chunk=0), "prefill_chunk must be"),
    (dict(max_new_tokens=100), "exceeds config.max_seq"),
])
def test_generate_validation_matches_reference(kwargs, match):
    jcfg, tcfg = _configs()
    kwargs = {"max_new_tokens": 4, **kwargs}
    prompt = np.zeros((1, 3), np.int32)
    with pytest.raises(ValueError, match=match) as ref:
        jax_decode._generate_traced(jax_tf.TransformerLM(jcfg), None, jnp.asarray(prompt),
                                    rng=jax.random.PRNGKey(0), **kwargs)
    model = torch_tf.TransformerLM(tcfg, device="cpu")
    with pytest.raises(ValueError, match=match) as port:
        decode.generate(model, prompt, generator=torch.Generator(), **kwargs)
    assert str(port.value) == str(ref.value)


def test_generate_rolling_chunk_guard_and_rng_requirement():
    _, tcfg = _configs(sliding_window=4, rolling_cache=True)
    model = torch_tf.TransformerLM(tcfg, device="cpu")
    with pytest.raises(ValueError, match="exceed sliding_window"):
        decode.generate(model, np.zeros((1, 9), np.int32), 2, prefill_chunk=5)
    with pytest.raises(ValueError, match="requires a generator"):
        decode.generate(model, np.zeros((1, 3), np.int32), 2, temperature=1.0)
    assert decode.generate(model, np.ones((1, 3), np.int32), 0).tolist() == [[1, 1, 1]]


# --- serving weights -------------------------------------------------------


def test_inference_params_cast_the_same_leaves_as_the_reference():
    """The reference's bf16 tree converts bit for bit, and equals the port's
    own cast of the f32 weights, leaf for leaf, RMSNorm scales included."""
    jcfg, tcfg = _configs(n_kv_heads=2)
    params = _jax_params(jcfg)
    ref = jax.tree.map(np.asarray, jax_decode.inference_params(params))
    assert {leaf.dtype.name for leaf in jax.tree.leaves(ref)} == {"bfloat16"}
    converted = convert.params_from_jax(ref, tcfg)
    model = decode.inference_params(_port_model(tcfg, params))
    state = model.state_dict()
    assert set(converted) == set(state)
    for name, tensor in state.items():
        assert tensor.dtype == converted[name].dtype == torch.bfloat16, name
        assert torch.equal(tensor.view(torch.int16), converted[name].view(torch.int16)), name
    assert any(name.endswith(".scale") for name in state)
