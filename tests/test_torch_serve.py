"""The port's continuous batching against the reference's, on the CPU.

One tiny float32 LM (2 layers, d_model 32, 4 heads with 2 kv heads, vocab
64, max_seq 48, reference attention) on both sides, the port's weights
converted from the reference's.  The same numpy prompts go through the
reference's ``continuous_generate``/``ContinuousEngine`` and the port's; the
reference's results are computed once per module.

Streams are compared token for token only after the test has asserted that
the reference's top-2 logit margin exceeds 1e-4 at every generated step (a
full forward over each finished sequence), so a near-tie shows as a setup
failure.  The host loop's counters (``prefill_passes``, ``sync_fetches``,
``device_chunks``, ``prefix_hits``, ``prefill_positions``) must be equal.
"""

import pickle
import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covalent_tpu_plugin.models import serve as jax_serve
from covalent_tpu_plugin.models import transformer as jax_tf
from covalent_tpu_plugin.resilience import FaultClass, classify_error
from covalent_tpu_plugin_torch.models import convert
from covalent_tpu_plugin_torch.models import serve
from covalent_tpu_plugin_torch.models import transformer as torch_tf

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
            max_seq=48)
MARGIN = 1e-4
CAPS = [3, 12, 5, 8, 1, 9]


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_tf.TransformerConfig(**TINY, dtype=jnp.float32, attention="reference")
    tcfg = torch_tf.TransformerConfig(**TINY, dtype=torch.float32, attention="reference")
    jmodel = jax_tf.TransformerLM(jcfg)
    params = flax.core.meta.unbox(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    # a wider head spreads the logits, so greedy steps have clear margins
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 10.0
    model = torch_tf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg))
    forward = jax.jit(lambda t: jmodel.apply({"params": params}, t))

    def margins(prompts, outputs):
        """The reference's top-2 margin at every generated step."""
        seqs = np.zeros((len(outputs), TINY["max_seq"]), np.int32)
        for row, out in zip(seqs, outputs):
            row[: out.size] = out
        logits = np.asarray(forward(jnp.asarray(seqs)))
        got = []
        for row, p, out in zip(logits, prompts, outputs):
            top2 = np.sort(row[p.size - 1:out.size - 1], axis=-1)[:, -2:]
            got.append(top2[:, 1] - top2[:, 0])
        return np.concatenate(got)

    return jmodel, params, model, margins


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"], 3 + i % 4).astype(np.int32) for i in range(n)]


#: name: continuous_generate keyword arguments (prompts from seed 10); the
#: "eos" case's EOS is the third token the longest request generates
CG_CASES = {
    "batched": dict(max_batch=2, sync_steps=3),
    "stream": dict(max_batch=2, sync_steps=3, prefill="stream"),
    "eos": dict(max_batch=2, sync_steps=3),
}


@pytest.fixture(scope="module")
def cg_reference(lm):
    jmodel, params, _, margins = lm
    prompts = _prompts(len(CAPS), 10)
    out, kwargs = {}, {}
    for name in CG_CASES:
        kwargs[name] = dict(CG_CASES[name])
        if name == "eos":
            longest = int(np.argmax(CAPS))
            kwargs[name]["eos_token_id"] = int(
                out["batched"][0][longest][prompts[longest].size + 2])
        stats = {}
        outs = jax_serve.continuous_generate(jmodel, params, prompts, CAPS, stats=stats,
                                             **kwargs[name])
        assert margins(prompts, outs).min() > MARGIN, name
        out[name] = ([np.asarray(o) for o in outs], stats)
    return prompts, out, kwargs


@pytest.mark.parametrize("name", sorted(CG_CASES))
def test_continuous_generate_matches_reference(lm, cg_reference, name):
    model = lm[2]
    prompts, reference, kwargs = cg_reference
    want, want_stats = reference[name]
    stats = {}
    got = serve.continuous_generate(model, prompts, CAPS, stats=stats, **kwargs[name])
    assert [o.tolist() for o in got] == [o.tolist() for o in want]
    assert stats == want_stats
    if name == "eos":
        eos = kwargs[name]["eos_token_id"]
        assert any(o[-1] == eos and o.size < p.size + c for o, p, c in zip(got, prompts, CAPS))


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


#: name: (engine keyword arguments, prompts)
def _engine_cases():
    prefix = np.asarray([5, 9, 2, 7, 11, 3, 8, 1], np.int32)
    shared = [np.concatenate([prefix, np.asarray(s, np.int32)])
              for s in ([12, 13], [20], [31, 32, 33], [40, 41])]
    # the third prompt repeats the first, the fourth shares its first 6
    # tokens: both hit lanes the tree took in at the first admission
    first = np.asarray([7, 3, 9, 1, 12, 5, 8, 2], np.int32)
    repeated = [first, np.asarray([30, 31, 32], np.int32), first,
                np.asarray([7, 3, 9, 1, 12, 5, 40, 41], np.int32)]
    return {
        "budgets": (dict(max_batch=2, sync_steps=3), _prompts(5, 20)),
        "shared_prefix": (dict(max_batch=2, sync_steps=3, shared_prefix=prefix), shared),
        "prefix_tree": (dict(max_batch=2, sync_steps=3), repeated),
    }


ENGINE_CASES = _engine_cases()


@pytest.fixture(scope="module")
def engine_reference(lm):
    jmodel, params, _, margins = lm
    out = {}
    for name, (kwargs, prompts) in ENGINE_CASES.items():
        engine = jax_serve.ContinuousEngine(jmodel, params, max_new_tokens=8, **kwargs)
        requests = {f"r{i}": (p, CAPS[i % len(CAPS)] + 2) for i, p in enumerate(prompts)}
        steps = _drive(engine, requests)
        streams = _streams(steps)
        outputs = [np.concatenate([p, streams[rid]]) for rid, (p, _) in requests.items()]
        assert margins(prompts, outputs).min() > MARGIN, name
        out[name] = (requests, steps, dict(engine.stats))
        engine.close()
    return out


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_event_sequences_match_reference(lm, engine_reference, name):
    """The same admissions give the same events, step for step, and the same
    prefix-tree counters."""
    kwargs, _ = ENGINE_CASES[name]
    requests, want_steps, want_stats = engine_reference[name]
    engine = serve.ContinuousEngine(lm[2], max_new_tokens=8, **kwargs)
    steps = _drive(engine, requests)
    assert steps == want_steps
    for key in ("prefix_hits", "prefix_misses", "prefill_positions", "prefix_evictions"):
        assert engine.stats[key] == want_stats[key], key
    if name != "budgets":
        assert engine.stats["prefix_hits"] > 0
    engine.close()


def test_engine_cancel_matches_reference(lm):
    """A lane cancelled mid-decode frees its slot for a queued request: the
    event sequences of both engines stay equal."""
    jmodel, params, model, margins = lm
    prompts = _prompts(3, 30)
    runs = []
    for engine in (jax_serve.ContinuousEngine(jmodel, params, max_batch=2, sync_steps=2),
                   serve.ContinuousEngine(model, max_batch=2, sync_steps=2)):
        engine.admit("keep", prompts[0], {"max_new_tokens": 9})
        engine.admit("drop", prompts[1], {"max_new_tokens": 9})
        steps = [engine.step()]
        engine.cancel("drop")
        engine.admit("late", prompts[2], {"max_new_tokens": 4})
        while engine.busy:
            steps.append(engine.step())
        runs.append(steps)
        engine.close()
    streams = _streams(runs[0])
    outs = [np.concatenate([prompts[0], streams["keep"]]),
            np.concatenate([prompts[2], streams["late"]])]
    assert margins([prompts[0], prompts[2]], outs).min() > MARGIN
    assert runs[1] == runs[0]
    assert len(streams["keep"]) == 9 and len(streams["late"]) == 4


def test_engine_kv_export_import_matches_one_engine(lm, engine_reference):
    """prefill_only on one engine and admit_from_kv on another stream what
    one engine doing both streams, with no prefill work on the decode side."""
    model = lm[2]
    requests, want_steps, _ = engine_reference["budgets"]
    prefill = serve.ContinuousEngine(model, max_batch=2, sync_steps=3)
    decode = serve.ContinuousEngine(model, max_batch=2, sync_steps=3)
    bundles = {rid: prefill.prefill_only(p) for rid, (p, _) in requests.items()}
    queue, steps = list(requests.items()), []
    while queue or decode.busy:
        while queue and decode.busy < decode.slots:
            rid, (_, cap) = queue.pop(0)
            decode.admit_from_kv(rid, bundles[rid], {"max_new_tokens": cap})
        steps.append(decode.step())
    assert _streams(steps) == _streams(want_steps)
    assert decode.stats["prefill_positions"] == 0
    assert decode.stats["kv_admits"] == prefill.stats["kv_exports"] == len(requests)


def test_engine_admit_from_kv_validation(lm):
    """Garbage, a bundle of another model shape, a duplicate rid and an
    over-budget admission are refused with the lane untouched; the valid
    admission then decodes what a plain admission decodes."""
    model = lm[2]
    engine = serve.ContinuousEngine(model, max_batch=2, sync_steps=2, max_new_tokens=4)
    prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    bundle = engine.prefill_only(prompt)
    with pytest.raises(Exception):
        engine.admit_from_kv("bad", b"not a pickle")
    with pytest.raises(ValueError, match="unrecognized"):
        engine.admit_from_kv("bad", pickle.dumps({"v": 99}))
    other = torch_tf.TransformerLM(torch_tf.TransformerConfig(
        **{**TINY, "d_model": 16, "n_kv_heads": None}, dtype=torch.float32),
        device="cpu")
    with pytest.raises(ValueError, match="cache layout|lane leaf"):
        serve.ContinuousEngine(other, max_batch=1).admit_from_kv("r1", bundle)
    sampled = serve.ContinuousEngine(model, max_batch=1, temperature=0.5)
    with pytest.raises(ValueError, match="sampling fingerprint"):
        sampled.admit_from_kv("r1", bundle)
    engine.admit_from_kv("r1", bundle)
    with pytest.raises(ValueError, match="already admitted"):
        engine.admit_from_kv("r1", bundle)
    with pytest.raises(ValueError, match="exceeds"):
        engine.admit_from_kv("r2", bundle, {"max_new_tokens": 1000})
    got = []
    while engine.busy:
        got += [t for e in engine.step() for t in e["tokens"]]
    plain = serve.ContinuousEngine(model, max_batch=1, max_new_tokens=4)
    plain.admit("p", prompt)
    want = []
    while plain.busy:
        want += [t for e in plain.step() for t in e["tokens"]]
    assert got == want and len(got) == 4


def test_engine_sampling_is_reproducible_and_road_invariant(lm):
    """Sampled streams: the same generator seed gives the same streams, and
    a prefix-tree engine draws what a plain engine draws (the admission keys
    are split before the hit/miss partition)."""
    model = lm[2]
    prefix = np.asarray([5, 9, 2, 7, 4], np.int32)
    prompts = [np.concatenate([prefix, [12, 13]]).astype(np.int32),
               np.asarray([9, 9, 9], np.int32),
               np.concatenate([prefix, [30]]).astype(np.int32)]
    requests = {f"r{i}": (p, 5) for i, p in enumerate(prompts)}

    def run(seed, **kw):
        engine = serve.ContinuousEngine(
            model, max_batch=2, sync_steps=2, temperature=0.8, top_k=16,
            generator=torch.Generator().manual_seed(seed), **kw)
        return _streams(_drive(engine, dict(requests))), engine.stats

    plain, _ = run(11)
    again, _ = run(11)
    reuse, stats = run(11, shared_prefix=prefix)
    assert plain == again == reuse and stats["prefix_hits"] == 2
    assert all(len(s) == 5 and all(0 <= t < TINY["vocab_size"] for t in s)
               for s in plain.values())


@pytest.mark.parametrize("caps,batch,sync", [
    (CAPS, 2, 4), ([128, 32] * 8, 8, 32), ([1, 1, 1], 4, 1), ([5, 17, 2, 9, 30], 3, 7),
])
def test_step_accounting_matches_reference(caps, batch, sync):
    assert serve.step_accounting(caps, batch, sync) == jax_serve.step_accounting(
        caps, batch, sync)


def test_typed_refusals(lm):
    model = lm[2]
    rolling = torch_tf.TransformerLM(torch_tf.TransformerConfig(
        **TINY, sliding_window=6, rolling_cache=True), device="cpu")
    for call in (lambda: serve.ContinuousEngine(rolling, max_batch=1),
                 lambda: serve.continuous_generate(rolling, [np.ones(3, np.int32)], 2)):
        with pytest.raises(serve.RollingCacheUnsupported) as refusal:
            call()
        assert isinstance(refusal.value, ValueError)
        assert classify_error(refusal.value) == (FaultClass.PERMANENT, "serve_model_unsupported")
    # speculative decoding waits for slice 3b; the lane groups and the bank
    # construct, and the bank's refusals are typed and permanent
    with pytest.raises(NotImplementedError, match="slice 3b \\(speculative"):
        serve.ContinuousEngine(model, draft_model=model)
    assert serve.ContinuousEngine(model, decode_modes=("fp", "kv_quant")).decode_modes == (
        "fp", "kv_quant")
    assert serve.ContinuousEngine(model, adapter_rank=4).adapters == ()
    with pytest.raises(serve.AdapterUnsupported, match="adapter_rank") as refusal:
        serve.ContinuousEngine(model, adapters={})
    assert classify_error(refusal.value) == (FaultClass.PERMANENT, "serve_model_unsupported")


def test_engine_and_continuous_generate_validation(lm):
    model = lm[2]
    engine = serve.lm_engine_factory(model, max_batch=1, sync_steps=2, max_new_tokens=4)()
    assert isinstance(engine, serve.ContinuousEngine)
    engine.admit("r1", np.asarray([1, 2, 3], np.int32))
    with pytest.raises(ValueError, match="already admitted"):
        engine.admit("r1", np.asarray([4], np.int32))
    with pytest.raises(RuntimeError, match="no free lane"):
        engine.admit("r2", np.asarray([4], np.int32))
    engine.cancel("r1")
    with pytest.raises(ValueError, match="at least one token"):
        engine.admit("r3", np.zeros(0, np.int32))
    with pytest.raises(ValueError, match="exceeds the"):
        engine.admit("r4", np.asarray([1], np.int32), {"max_new_tokens": 10_000})
    with pytest.raises(ValueError, match="unknown adapter"):
        engine.admit("r5", np.asarray([1], np.int32), {"adapter": "tuned"})
    with pytest.raises(ValueError, match="no room"):
        serve.ContinuousEngine(model, length=8, shared_prefix=np.arange(1, 8))
    prompts = _prompts(2, 0)
    for kwargs, match in ((dict(max_new_tokens=1000), "max_seq"),
                          (dict(max_new_tokens=4, temperature=0.5), "requires a generator"),
                          (dict(max_new_tokens=4, top_k=4), "top_k requires"),
                          (dict(max_new_tokens=4, prefill="turbo"), "prefill must be"),
                          (dict(max_new_tokens=[4]), "entries for")):
        with pytest.raises(ValueError, match=match):
            serve.continuous_generate(model, prompts, **kwargs)
    assert serve.continuous_generate(model, [], 4) == []


def test_serve_lm_electron_through_the_executor(tmp_path, run_async):
    """``serve_lm`` at a tiny width through ``GPUExecutor(transport="local")``
    on the CPU: both arms complete, the engine's streams equal
    ``continuous_generate``'s and batch-1 ``generate``'s, and no flash kernel
    runs."""
    from covalent_tpu_plugin_torch import GPUExecutor

    executor = GPUExecutor(
        transport="local", cache_dir=str(tmp_path / "cache"),
        remote_cache=str(tmp_path / "remote"), remote_workdir=str(tmp_path / "work"),
        python_path=sys.executable, poll_freq=0.2, task_env={"PYTHONPATH": str(REPO)},
        use_agent=False,
    )
    kwargs = dict(device="cpu", batch=2, prompt_len=6, new_tokens=8, requests=4,
                  short_tokens=3, max_batch=2, sync_steps=4, timed_calls=1,
                  **{k: v for k, v in TINY.items()})
    out = run_async(executor.run(serve.serve_lm, [], kwargs,
                                 {"dispatch_id": "d", "node_id": 0}))
    assert out["decode"]["shape_ok"] and out["decode"]["e2e_tokens_per_s"] > 0
    assert out["serve"]["complete"] and out["serve"]["caps"] == [8, 3, 8, 3]
    assert out["continuous_generate"]["streams_equal_engine"]
    assert out["continuous_generate"]["stats"]["prefill_passes"] >= 1
    assert out["batch1_agreement"]["equal"] == 4
    assert out["logits_finite"] and out["kv_int8_logit_cosine"] > 0.999
    assert set(out["flash_launches"].values()) == {0}
    assert out["serve"]["ttft_s"]["p50"] <= out["serve"]["completion_s"]["p95"]
